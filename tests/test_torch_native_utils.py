"""The port's native host data path (haff_tpu_torch/data/native.py) and
utils (profiling, flops, bench_cache), on the CPU.

native: the same runtime/haff_host.cpp as haff_tpu's binding, built into
build/haff_tpu_torch/ (never under runtime/): equal to haff_tpu's native
results bit for bit, and to the cv2/PIL path within its fixed-point
rounding; HAFF_NATIVE_PREPROCESS=1 selects it in the port's transforms.
flops: FlopCounterMode's counts against analytic counts, the SAM
attention ops by their registered formula. bench_cache: the hash moves
with the code, a leg comes back only at the same code."""

import os
import subprocess

import numpy as np
import pytest
import torch

from haff_tpu.data import native as jnative
from haff_tpu_torch.data import native
from haff_tpu_torch.data.transforms import (CLIP_MEAN, CLIP_STD,
                                            clip_preprocess, mask_to_canvas,
                                            sam_preprocess)
from haff_tpu_torch.nn.sam import PIXEL_MEAN, PIXEL_STD

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def lib():
    if not native.available():
        pytest.skip("no C++ toolchain: the Python path serves")
    return native


def test_native_equals_jax_native_bit_for_bit(lib):
    if not jnative.available():
        pytest.skip("haff_tpu's native library did not build")
    rng = np.random.RandomState(0)
    img = rng.randint(0, 255, (120, 160, 3), np.uint8)
    for a, b in zip(lib.sam_preprocess_native(img, 256, PIXEL_MEAN, PIXEL_STD),
                    jnative.sam_preprocess_native(img, 256, PIXEL_MEAN,
                                                  PIXEL_STD)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(
        lib.clip_preprocess_native(img, 96, CLIP_MEAN, CLIP_STD),
        jnative.clip_preprocess_native(img, 96, CLIP_MEAN, CLIP_STD))
    mask = (rng.rand(60, 90) > 0.6).astype(np.uint8)
    np.testing.assert_array_equal(
        lib.mask_to_canvas_native(mask, (128, 192), 192),
        jnative.mask_to_canvas_native(mask, (128, 192), 192))
    pts = np.array([[4, 4], [4, 20], [20, 20], [20, 4]], np.int32)
    np.testing.assert_array_equal(lib.fill_polygon_native(pts, (32, 32)),
                                  jnative.fill_polygon_native(pts, (32, 32)))


def test_native_against_the_python_path(lib, monkeypatch):
    rng = np.random.RandomState(1)
    img = rng.randint(0, 255, (90, 140, 3), np.uint8)
    ref, hw = sam_preprocess(img, 256)
    out, hw2 = lib.sam_preprocess_native(img, 256, PIXEL_MEAN, PIXEL_STD)
    assert tuple(hw) == tuple(hw2)
    assert np.abs(out - ref).max() < 2.5 / 57.0
    np.testing.assert_array_equal(out[hw[0]:], ref[hw[0]:])
    tol = 1.5 / 255.0 / 0.26
    for shape in ((50, 70, 3), (300, 400, 3)):
        im = rng.randint(0, 255, shape, np.uint8)
        assert np.abs(lib.clip_preprocess_native(im, 96, CLIP_MEAN, CLIP_STD)
                      - clip_preprocess(im, 96)).max() < tol
    mask = (rng.rand(60, 90) > 0.6).astype(np.uint8)
    out = lib.mask_to_canvas_native(mask, (128, 192), 192)
    assert (out == mask_to_canvas(mask, (128, 192), 192)).mean() > 0.99
    monkeypatch.setenv("HAFF_NATIVE_PREPROCESS", "1")
    got, _ = sam_preprocess(img, 256)
    np.testing.assert_array_equal(got, lib.sam_preprocess_native(
        img, 256, PIXEL_MEAN, PIXEL_STD)[0])
    np.testing.assert_array_equal(
        clip_preprocess(img, 64),
        lib.clip_preprocess_native(img, 64, CLIP_MEAN, CLIP_STD))


def test_native_builds_under_build_and_writes_nothing_under_runtime(
        tmp_path, monkeypatch):
    """A fresh build (another build directory) runs g++ on runtime's
    source with its output under the build directory; runtime/ is the
    same before and after (names, sizes and times)."""
    runtime = os.path.join(ROOT, "runtime")

    def listing():
        return sorted((n, os.stat(os.path.join(runtime, n)).st_size,
                       os.stat(os.path.join(runtime, n)).st_mtime_ns)
                      for n in os.listdir(runtime))

    before = listing()
    calls = []
    real = subprocess.run

    def spy(cmd, *a, **kw):
        calls.append(list(cmd))
        return real(cmd, *a, **kw)

    build = str(tmp_path / "build")
    monkeypatch.setattr(native, "BUILD_DIR", build)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native.subprocess, "run", spy)
    ok = native.load_library() is not None
    assert listing() == before
    gxx = [c for c in calls if c[0] == "g++"]
    if not ok and not gxx:
        pytest.skip("no C++ toolchain")
    assert ok and gxx
    for c in gxx:
        out = c[c.index("-o") + 1]
        assert out.startswith(build + os.sep) and native.SOURCE in c
    assert native.library_path().startswith(build + os.sep)
    assert os.path.exists(native.library_path())


# ---------------------------------------------------------------------------
# flops
# ---------------------------------------------------------------------------

def test_flops_of_a_linear_chain_and_the_sam_ops():
    from haff_tpu_torch.kernels import sam_attention as sa
    from haff_tpu_torch.utils.flops import count_flops, mfu_fields

    net = torch.nn.Sequential(torch.nn.Linear(64, 128), torch.nn.ReLU(),
                              torch.nn.Linear(128, 32))
    x = torch.randn(5, 64)
    assert count_flops(net, x) == 2 * 5 * (64 * 128 + 128 * 32)
    b, hw, nh, d = 3, (4, 6), 2, 8
    L = hw[0] * hw[1]
    qkv = torch.randn(b, L, 3 * nh * d)
    rel = [torch.randn(2 * s - 1, d) for s in hw]
    want = 2 * b * nh * L * d * (2 * L + hw[0] + hw[1])
    assert count_flops(sa.sam_window_attention_qkv, qkv, *rel, hw, nh) == want
    assert count_flops(sa.sam_global_attention_qkv, qkv, *rel, hw, nh) == want
    f = mfu_fields(2e12, 10.0, 400.0, prefix="sam_")
    assert f == {"sam_tflops": 20.0, "sam_mfu_pct": 5.0}
    assert mfu_fields(None, 10.0, 400.0) == {}


def test_flops_of_the_tiny_sam_encoder_are_analytic():
    """The tiny encoder's count: patch embedding, per block the qkv,
    projection and MLP products and the attention op's formula (window
    blocks over the padded windows), and the neck's two convolutions."""
    from haff_tpu_torch.core.config import ModelConfig
    from haff_tpu_torch.nn.sam import Sam
    from haff_tpu_torch.utils.flops import count_flops

    cfg = ModelConfig.preset("tiny")
    e = cfg.sam_encoder
    sam = Sam(e, cfg.sam_decoder)
    x = torch.zeros(1, e.image_size, e.image_size, 3)
    g, c = e.grid_size, e.embed_dim
    hd = c // e.num_heads
    tokens = g * g
    flops = 2 * tokens * (3 * e.patch_size ** 2) * c
    for i in range(e.depth):
        if i in e.global_attn_indexes:
            n, hw = 1, (g, g)
        else:
            w = e.window_size
            n, hw = (-(-g // w)) ** 2, (w, w)
        L = hw[0] * hw[1]
        flops += 2 * n * L * c * 3 * c + 2 * tokens * c * c
        flops += 2 * n * e.num_heads * L * hd * (2 * L + hw[0] + hw[1])
        mlp = int(c * e.mlp_ratio)
        flops += 2 * tokens * 2 * c * mlp
    flops += 2 * tokens * c * e.out_chans
    flops += 2 * tokens * e.out_chans * e.out_chans * 9
    with torch.no_grad():
        assert count_flops(sam.encode_image, x) == flops


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------

def test_profiling_trace_annotate_and_timer(tmp_path):
    from haff_tpu_torch.utils import profiling as P

    with P.trace(str(tmp_path / "tr"), cuda=False) as prof:
        with P.annotate("haff_step"):
            torch.randn(64, 64) @ torch.randn(64, 64)
    assert os.path.getsize(str(tmp_path / "tr" / "trace.json")) > 0
    assert "haff_step" in {e.key for e in prof.key_averages()}
    t = P.StepTimer()
    assert t.tick() >= 0 and t.tick() >= 0 and t.steps == 2
    assert t.mean == t.total / 2
    with pytest.raises(NotImplementedError, match="no live profiler"):
        P.start_profiler_server()


# ---------------------------------------------------------------------------
# bench_cache
# ---------------------------------------------------------------------------

def test_bench_cache_hash_and_legs(tmp_path, monkeypatch):
    import shutil

    from haff_tpu_torch.utils import bench_cache as B

    root = tmp_path / "repo"
    shutil.copytree(os.path.join(ROOT, "haff_tpu_torch", "utils"),
                    str(root / "haff_tpu_torch" / "utils"))
    monkeypatch.setattr(B, "_ROOT", str(root))
    monkeypatch.setattr(B, "_PATH", str(root / ".bench_cache_torch.json"))
    h0 = B.code_hash()
    assert h0 == B.code_hash()
    B.store("e2e", {"fps": 1.5})
    assert B.load("e2e") == {"fps": 1.5} and B.load("other") is None
    (root / "chip_smoke.py").write_text("# script\n")
    assert B.code_hash() != h0 and B.load("e2e") is None
    B.store("p50", {"ms": 3.0})
    assert B.load("p50") == {"ms": 3.0} and B.load("e2e") is None
    os.remove(str(root / "chip_smoke.py"))
    (root / "haff_tpu_torch" / "utils" / "x.cu").write_text("// kernel\n")
    assert B.code_hash() not in (h0,)
    assert os.path.basename(B._PATH) != ".bench_cache.json"
