"""The port's deployment tools against haff_tpu's, at tiny in float32 on
the CPU:

* tools/export_model.py: the encoder, decoder and mask_path components
  exported with torch.export, saved as .pt2, loaded back (in this
  process, and for mask_path in a fresh one that imports no model code):
  loaded = eager exactly, and = haff_tpu's exported artifact within 1e-4
  (the port's standing module tolerance, float32 summation order), JAX's
  initial weights reaching the port through an .npz `--checkpoint`;
* tools/export_params.py from a train-CLI checkpoint directory: read back
  by haff_tpu's load_exported_params exactly (float32) and to bf16
  rounding ("::bf16"), LoRA folded as haff_tpu's merge_lora_params folds
  it; a Predictor serving the .npz gives the tokens and masks of one
  serving the directory (masks within 1e-4: the folded product rounds
  differently);
* tools/merge_lora.py, convert_cli.py, delta_weights.py and
  bench_to_shards.py against haff_tpu's functions on the same inputs.
"""

import json
import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch
from flax import traverse_util

from haff_tpu.tools import delta_weights as JDW
from haff_tpu.tools import export_model as JX
from haff_tpu.tools.export_params import load_exported_params
from haff_tpu.tools.merge_lora import merge_lora_params as jax_merge
from haff_tpu_torch.tools import delta_weights as TDW
from haff_tpu_torch.tools import export_model as TX
from haff_tpu_torch.tools.bridge import load_npz, state_dict_to_flax
from haff_tpu_torch.tools.merge_lora import merge_lora_params
from test_torch_bridge import write_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def flat(tree):
    return {"/".join(k): np.asarray(v)
            for k, v in traverse_util.flatten_dict(tree).items()}


def assert_same_flat(got, want, skip=()):
    got = {k: v for k, v in got.items() if not k.startswith(skip or "\0")}
    want = {k: v for k, v in want.items() if not k.startswith(skip or "\0")}
    assert sorted(got) == sorted(want) and got
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# export_model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_sam(tmp_path_factory):
    """haff_tpu's tiny Sam build (one init for the file) and its weights as
    a bare-Sam .npz."""
    built = JX._build("tiny", None, "fp32")
    path = write_npz(built[2], tmp_path_factory.mktemp("sam") / "sam.npz")
    return built, path


@pytest.fixture(scope="module")
def port_exports(jax_sam, tmp_path_factory):
    """The port's Sam on JAX's weights and its three components exported
    and saved: {component: (program, path, bytes)}."""
    _, npz = jax_sam
    cfg, sam = TX.build_sam("tiny", npz, "fp32", device="cpu")
    root = tmp_path_factory.mktemp("pt2")
    out = {}
    for component in TX.COMPONENTS:
        program = TX.export_sam_component(sam, cfg, component)
        path = str(root / f"{component}.pt2")
        out[component] = (program, path, TX.save_exported(
            program, path, {"component": component}))
    return cfg, sam, out


@pytest.mark.parametrize("component", ["encoder", "decoder", "mask_path"])
def test_export_model_equals_eager_and_jax(component, jax_sam, port_exports,
                                           tmp_path, monkeypatch):
    built, _ = jax_sam
    monkeypatch.setattr(JX, "_build", lambda *a: built)
    cfg, sam, exports = port_exports
    program, out, size = exports[component]
    with open(out + ".json") as f:
        manifest = json.load(f)
    assert manifest == {"component": component, "bytes": size,
                        "format": "torch.export/pt2"}
    assert os.path.getsize(out) == size
    ops = {str(n.target) for n in program.graph.nodes}
    if component != "decoder":
        assert {"haff.sam_window_relpos_attn.default"} <= ops

    inputs = TX.example_inputs(cfg, component, 1, "cpu",
                               torch.Generator().manual_seed(3))
    loaded = TX.load_exported(out)
    with torch.no_grad():
        got = loaded(*inputs)
        eager = TX._Component(sam, component, cfg.sam_encoder.image_size)(
            *inputs)
    got = got if isinstance(got, (tuple, list)) else (got,)
    eager = eager if isinstance(eager, (tuple, list)) else (eager,)
    path = str(tmp_path / f"{component}.stablehlo")
    with open(path, "wb") as f:
        f.write(JX.export_component(component, "tiny", None, 1, "fp32"))
    want = JX.load_exported(path)(*[i.numpy() for i in inputs])
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(eager) == len(want)
    for g, e, w in zip(got, eager, want):
        assert torch.equal(g, e)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-4)


def test_load_exported_in_a_fresh_process_needs_no_model_code(port_exports,
                                                              tmp_path):
    """mask_path saved, then loaded and run by a new interpreter that
    imports only export_model.load_exported: the outputs equal this
    process's, and haff_tpu_torch.nn was never imported there."""
    cfg, sam, exports = port_exports
    out = exports["mask_path"][1]
    inputs = TX.example_inputs(cfg, "mask_path", 1, "cpu",
                               torch.Generator().manual_seed(4))
    torch.save(inputs, str(tmp_path / "in.pt"))
    code = (
        "import sys, torch\n"
        "from haff_tpu_torch.tools.export_model import load_exported\n"
        f"m = load_exported({out!r})\n"
        f"x = torch.load({str(tmp_path / 'in.pt')!r})\n"
        "with torch.no_grad():\n"
        "    y = m(*x)\n"
        f"torch.save(list(y), {str(tmp_path / 'out.pt')!r})\n"
        "assert not any(k.startswith('haff_tpu_torch.nn') for k in "
        "sys.modules), sorted(sys.modules)\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   env=dict(os.environ, PYTHONPATH=ROOT))
    got = torch.load(str(tmp_path / "out.pt"))
    with torch.no_grad():
        want = TX._Component(sam, "mask_path", cfg.sam_encoder.image_size)(
            *inputs)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_export_model_checkpoint_forms(jax_sam, tmp_path):
    """A whole-model .npz (the Sam under visual_model) loads as the bare
    one does; an orbax-like directory raises; the CLI writes the
    artifact and manifest; without a card the default device raises."""
    _, npz = jax_sam
    _, bare = TX.build_sam("tiny", npz, "fp32", device="cpu")
    with np.load(npz) as z:
        np.savez(str(tmp_path / "whole.npz"),
                 **{"visual_model/" + k: z[k] for k in z.files})
    _, whole = TX.build_sam("tiny", str(tmp_path / "whole.npz"), "fp32",
                            device="cpu")
    for (k, a), (_, b) in zip(bare.state_dict().items(),
                              whole.state_dict().items()):
        assert torch.equal(a, b), k
    (tmp_path / "orbax").mkdir()
    with pytest.raises(NotImplementedError, match="orbax"):
        TX.build_sam("tiny", str(tmp_path / "orbax"), "fp32", device="cpu")
    out = str(tmp_path / "dec.pt2")
    TX.main(["--component", "decoder", "--out", out, "--model_preset", "tiny",
             "--precision", "fp32", "--checkpoint", npz, "--device", "cpu"])
    with open(out + ".json") as f:
        assert json.load(f)["format"] == "torch.export/pt2"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TX.build_sam("tiny", None, "bf16")


# ---------------------------------------------------------------------------
# export_params and merge_lora from a train-CLI checkpoint
# ---------------------------------------------------------------------------

def _write_checkpoint(root):
    """A train-CLI checkpoint directory at tiny (LoRA r 2, float32, seed
    42): step 3's trainable tensors (LoRA adapters made nonzero, the text
    projection and mask decoders perturbed) and model.json. Returns
    (ckpt_dir, the trained model, the initial model)."""
    from haff_tpu_torch.core.config import ModelConfig
    from haff_tpu_torch.train.cli import build_model

    import dataclasses

    llama = dict(lora_rank=2, lora_alpha=16.0, lora_dropout=0.0,
                 lora_targets=["q_proj", "v_proj"], vocab_size=512,
                 moe_num_experts=0, moe_top_k=2, moe_every=1)
    meta = dict(model_preset="tiny", decoder="llama", precision="fp32",
                seed=42, pretrained_params=None, vision_pretrained=None,
                reset_mask_decoder=False, llama=llama)
    base = ModelConfig.preset("tiny")
    cfg = base.replace(llama=dataclasses.replace(
        base.llama, **dict(llama, lora_targets=("q_proj", "v_proj"))))
    init = build_model(cfg, "fp32", "cpu", 42)
    model = build_model(cfg, "fp32", "cpu", 42)
    g = torch.Generator().manual_seed(7)
    trainable = {}
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ("lora_" in name or name.startswith("text_fc")
                    or ".mask_decoder_" in name):
                p.add_(0.05 * torch.randn(p.shape, generator=g))
                trainable[name] = p.detach().clone()
    ckpt = os.path.join(root, "ckpt_model")
    step = os.path.join(ckpt, "3")
    os.makedirs(step)
    torch.save({"step": 3, "trainable": trainable, "optimizer": {}},
               os.path.join(step, "state.pt"))
    for name, data in (("model.json", meta), ("metrics.json", {})):
        with open(os.path.join(step, name), "w") as f:
            json.dump(data, f)
    return ckpt, model, init


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    return _write_checkpoint(str(tmp_path_factory.mktemp("run")))


def test_export_params_read_by_jax(checkpoint, tmp_path):
    from haff_tpu_torch.tools.export_params import export_params

    ckpt, model, _ = checkpoint
    unmerged = flat(state_dict_to_flax(model))
    assert any(k.endswith("lora_a") for k in unmerged)
    want = flat(jax_merge(traverse_util.unflatten_dict(
        {tuple(k.split("/")): v for k, v in unmerged.items()}), alpha=16.0))
    f32 = export_params(ckpt, str(tmp_path / "f32.npz"), "tiny", "float32",
                        device="cpu")
    assert_same_flat(flat(load_exported_params(f32)), want)
    bf = export_params(ckpt, str(tmp_path / "bf.npz"), dtype="bfloat16",
                       device="cpu")
    got = flat(load_exported_params(bf))
    assert_same_flat(got, {k: v.astype(ml_dtypes.bfloat16).astype(np.float32)
                           for k, v in want.items()})
    assert_same_flat(flat(load_npz(bf)), got)
    raw = export_params(ckpt, str(tmp_path / "raw.npz"), dtype="float32",
                        merge_lora=False, device="cpu")
    assert_same_flat(flat(load_exported_params(raw)), unmerged)
    with pytest.raises(SystemExit, match="trained tiny"):
        export_params(ckpt, str(tmp_path / "x.npz"), "small", device="cpu")


def test_predictor_serves_the_export_as_the_checkpoint(checkpoint, tmp_path):
    from haff_tpu_torch.infer.predictor import Predictor
    from haff_tpu_torch.tools.export_params import main as export_main

    ckpt, _, _ = checkpoint
    npz = str(tmp_path / "p.npz")
    export_main(["--ckpt_dir", ckpt, "--out", npz, "--dtype", "float32",
                 "--device", "cpu"])
    kw = dict(model_preset="tiny", precision="fp32", max_new_tokens=4,
              max_text_len=448, device="cpu")
    rng = np.random.RandomState(0)
    frames = [(rng.rand(60, 90, 3) * 255).astype(np.uint8),
              (rng.rand(48, 40, 3) * 255).astype(np.uint8)]
    prompts = ["open the drawer", "where would you grab the cup?"]
    got = Predictor(checkpoint=npz, **kw).predict_batch(frames, prompts)
    want = Predictor(checkpoint=ckpt, **kw).predict_batch(frames, prompts)
    for (t, ml, mr, tax), (rt, rml, rmr, rtax) in zip(got, want):
        assert t == rt
        for a, b in ((ml, rml), (mr, rmr), (tax, rtax)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4)


def test_merge_lora_equals_jax(checkpoint, tmp_path):
    """merge_lora_params = haff_tpu's on the same tree, bit for bit; the
    CLI over (checkpoint directory + the run's initial weights) gives the
    merged export of the trained model, without the vision tower."""
    from haff_tpu_torch.tools.bridge import save_npz
    from haff_tpu_torch.tools.export_params import export_params
    from haff_tpu_torch.tools.merge_lora import main, strip_vision_tower

    ckpt, model, init = checkpoint
    tree = state_dict_to_flax(model)
    jtree = traverse_util.unflatten_dict(
        {tuple(k.split("/")): v for k, v in flat(tree).items()})
    assert_same_flat(flat(merge_lora_params(tree, alpha=8.0)),
                     flat(jax_merge(jtree, alpha=8.0)))
    assert "vision_tower" not in strip_vision_tower(tree)
    base = str(tmp_path / "base.npz")
    save_npz(state_dict_to_flax(init), base, "float32")
    out = str(tmp_path / "merged.npz")
    main(["--checkpoint", ckpt, "--base_params", base, "--out", out,
          "--dtype", "float32"])
    want = flat(load_npz(export_params(ckpt, str(tmp_path / "e.npz"),
                                       dtype="float32", device="cpu")))
    got = flat(load_npz(out))
    assert not any(k.startswith("vision_tower") for k in got)
    assert_same_flat(got, {k: v for k, v in want.items()
                           if not k.startswith("vision_tower")})
    with pytest.raises(SystemExit, match="base_params"):
        main(["--checkpoint", ckpt, "--out", out])
    main(["--checkpoint", str(tmp_path / "e.npz"), "--out",
          str(tmp_path / "again.npz"), "--dtype", "float32",
          "--keep_vision_tower"])
    assert_same_flat(flat(load_npz(str(tmp_path / "again.npz"))), want)


# ---------------------------------------------------------------------------
# convert_cli, delta_weights, bench_to_shards
# ---------------------------------------------------------------------------

def _clip_state_dict(c, seed=1):
    """A seeded HF CLIPVisionModel state dict at the config's widths (the
    keys convert_clip reads, torch layouts)."""
    rng = np.random.default_rng(seed)
    h, f, p = c.hidden_size, c.intermediate_size, c.patch_size
    n_pos = (c.image_size // p) ** 2 + 1
    pre = "vision_model."
    shapes = {"embeddings.class_embedding": (h,),
              "embeddings.patch_embedding.weight": (h, 3, p, p),
              "embeddings.position_embedding.weight": (n_pos, h),
              "pre_layrnorm.weight": (h,), "pre_layrnorm.bias": (h,)}
    for i in range(c.num_layers):
        b = f"encoder.layers.{i}."
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            shapes[f"{b}self_attn.{proj}.weight"] = (h, h)
            shapes[f"{b}self_attn.{proj}.bias"] = (h,)
        for ln in ("layer_norm1", "layer_norm2"):
            shapes[f"{b}{ln}.weight"] = (h,)
            shapes[f"{b}{ln}.bias"] = (h,)
        shapes.update({f"{b}mlp.fc1.weight": (f, h), f"{b}mlp.fc1.bias": (f,),
                       f"{b}mlp.fc2.weight": (h, f), f"{b}mlp.fc2.bias": (h,)})
    return {pre + k: rng.standard_normal(v).astype(np.float32)
            for k, v in shapes.items()}


def test_convert_cli_equals_jax_conversion(tmp_path):
    """A CLIP vision tower at the tiny preset's widths through the port's
    convert_cli: the .npz's vision_tower equals haff_tpu's convert_clip
    tree; every other leaf is the seeded init."""
    from haff_tpu.tools.convert_weights import convert_clip
    from haff_tpu_torch.core.config import ModelConfig
    from haff_tpu_torch.model.lisa import LisaModel
    from haff_tpu_torch.tools.convert_cli import main

    c = ModelConfig.preset("tiny").clip
    sd = _clip_state_dict(c)
    sd_path = str(tmp_path / "clip.bin")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, sd_path)
    out = str(tmp_path / "conv.npz")
    main(["--preset", "tiny", "--out", out, "--clip", sd_path, "--seed", "5"])
    got = flat(load_npz(out))
    want = flat({"vision_tower": convert_clip(
        sd, c.num_layers + c.select_layer + 1)})
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v.astype(np.float32), err_msg=k)
    init = flat(state_dict_to_flax(LisaModel(
        ModelConfig.preset("tiny"), torch.float32, device="cpu",
        generator=torch.Generator().manual_seed(5))))
    assert sorted(got) == sorted(init)
    assert_same_flat({k: v for k, v in got.items() if k not in want},
                     {k: v for k, v in init.items() if k not in want})


def _delta_dicts():
    rng = np.random.default_rng(0)
    base = {"model.layers.0.w.weight": rng.standard_normal((4, 4)),
            "model.embed_tokens.weight": rng.standard_normal((10, 4)),
            "lm_head.weight": rng.standard_normal((10, 4))}
    target = {k: v + 0.1 for k, v in base.items()}
    target["model.embed_tokens.weight"] = rng.standard_normal((12, 4))
    target["lm_head.weight"] = rng.standard_normal((12, 4))
    target["model.mm_projector.weight"] = rng.standard_normal((4, 4))
    return ({k: v.astype(np.float32) for k, v in base.items()},
            {k: v.astype(np.float32) for k, v in target.items()})


def test_delta_weights_equal_jax(tmp_path):
    base, target = _delta_dicts()
    delta = TDW.make_delta(target, base)
    assert_same_flat(delta, JDW.make_delta(target, base))
    assert_same_flat(TDW.apply_delta(base, delta), JDW.apply_delta(base, delta))
    bad = dict(target, **{"model.extra.weight": np.zeros(2, np.float32)})
    for mod in (TDW, JDW):
        with pytest.raises(KeyError, match="allowlist"):
            mod.make_delta(bad, base)
    inv = dict(base, **{"lm_head.weight": np.zeros((20, 4), np.float32)})
    with pytest.raises(ValueError, match="one-directional"):
        TDW.make_delta(target, inv)
    paths = {}
    for name, sd in (("base", base), ("target", target)):
        paths[name] = str(tmp_path / f"{name}.bin")
        torch.save({k: torch.from_numpy(v) for k, v in sd.items()},
                   paths[name])
    for mod, tag in ((TDW, "t"), (JDW, "j")):
        mod.main(["make", "--base", paths["base"], "--target",
                  paths["target"], "--out", str(tmp_path / f"d_{tag}.bin")])
    got = torch.load(str(tmp_path / "d_t.bin"), weights_only=True)
    want = torch.load(str(tmp_path / "d_j.bin"), weights_only=True)
    assert_same_flat({k: v.numpy() for k, v in got.items()},
                     {k: v.numpy() for k, v in want.items()})
    sh = tmp_path / "shards"
    sh.mkdir()
    torch.save({"a.weight": torch.zeros(2)}, str(sh / "m-00001.bin"))
    torch.save({"b.weight": torch.ones(2)}, str(sh / "m-00002.bin"))
    TDW.main(["consolidate", "--src", str(sh), "--out",
              str(tmp_path / "c.safetensors")])
    from safetensors.numpy import load_file

    assert set(load_file(str(tmp_path / "c.safetensors"))) == {"a.weight",
                                                               "b.weight"}


def _bench_dir(root):
    """Benchmark frames of different sizes, one without masks, GT masks on
    another canvas than the image (resized), taxonomies uneven."""
    import cv2

    rng = np.random.RandomState(5)
    specs = [((40, 60), [1, 0, 0, 0], True, True, "open jar"),
             ((50, 44), [0, 1, 0, 0], True, False, "cut onion"),
             ((36, 36), [0, 0, 1, 0], False, False, "wash cup"),
             ((30, 52), [0, 1, 0, 0], False, True, "stir pot")]
    for i, (hw, tax, left, right, narr) in enumerate(specs):
        d = os.path.join(root, "vid", f"{i:07d}")
        os.makedirs(d)
        cv2.imwrite(os.path.join(d, "inpainting.png"),
                    rng.randint(0, 255, hw + (3,)).astype(np.uint8))
        with open(os.path.join(d, "annotation.json"), "w") as f:
            json.dump({"narration": narr, "taxonomy": tax}, f)
        for hand, on in (("left", left), ("right", right)):
            if on:
                m = np.zeros((64, 64), np.uint8)
                m[10:40, 8 + 10 * i:30 + 10 * i] = 255
                cv2.imwrite(os.path.join(d, f"aff_{hand}.png"), m)
    return root


@pytest.mark.parametrize("balance", [False, True])
def test_bench_to_shards_equals_jax(tmp_path, balance):
    from haff_tpu.tools.bench_to_shards import benchmark_to_shards as jb
    from haff_tpu_torch.data.aff_dataset import AffDataset
    from haff_tpu_torch.tools.bench_to_shards import benchmark_to_shards as tb
    from test_torch_pipeline import assert_same_shards

    bench = _bench_dir(str(tmp_path / "bench"))
    n_t = tb(bench, str(tmp_path / "t"), "VAL", 2, balance_taxonomy=balance)
    n_j = jb(bench, str(tmp_path / "j"), "VAL", 2, balance_taxonomy=balance)
    assert n_t == n_j > 0
    assert_same_shards(str(tmp_path / "t"), str(tmp_path / "j"))
    assert AffDataset(str(tmp_path / "t"), samples_per_epoch=1,
                      seed=0).get(0).image.shape[2] == 3
