"""Quantization of the port (haff_tpu_torch/nn/quant.py and the quantized
`QDense`) against haff_tpu/nn/quant.py and flax `QDense` on the same
seeded numpy inputs.

The port keeps a dense weight as (out, in), the JAX package as (in, out),
so every quantized tensor is compared with the transpose of JAX's. The
quantizers must agree bit for bit (IEEE float32 element by element). The
products agree within 1e-5 abs + rel in float32 (summation order; the
int32 sum of the W8A8 product is exact) and within 2e-2 in bfloat16 (the
tolerance of tests/test_quant.py for the same comparison). The JAX Pallas
kernels run in interpret mode, as tests/test_quant.py runs them.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from haff_tpu.nn import quant as jq
from haff_tpu.nn.layers import QDense as JaxQDense
from haff_tpu_torch.kernels import _build
from haff_tpu_torch.nn import quant as tq
from haff_tpu_torch.nn.layers import QDense
from haff_tpu_torch.nn.lora import LoraDense
from haff_tpu_torch.tools.bridge import _torch_name
from test_torch_bridge import jax_tiny_params, port_model

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _weight(rng, din, dout, zero_col=True):
    w = (rng.standard_normal((din, dout)) * din ** -0.5).astype(np.float32)
    if zero_col:
        w[:, 1] = 0.0  # an all-zero channel: scale 1, values 0
    return w


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ----- quantizers: bit-equal to JAX -----

@pytest.mark.parametrize("shape,axis", [((3, 7, 4, 16), -1), ((5, 33), -1),
                                        ((4, 6, 8), 1)])
def test_quantize_activation_bit_equal(shape, axis):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    x[0] = 0.0
    ref = jq.quantize_activation(jnp.asarray(x), axis)
    got = tq.quantize_activation(_t(x), axis)
    assert got.values.dtype == torch.int8 and got.scales.dtype == torch.float32
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(ref.values))
    np.testing.assert_array_equal(got.scales.numpy(), np.asarray(ref.scales))
    np.testing.assert_array_equal(
        tq.dequantize_activation(got, torch.float32).numpy(),
        np.asarray(jq.dequantize_activation(ref, jnp.float32)))


@pytest.mark.parametrize("din,dout", [(128, 48), (37, 5), (256, 1)])
def test_quantize_kernel_bit_equal(din, dout):
    w = _weight(np.random.default_rng(din), din, dout, zero_col=dout > 1)
    q, s = jq.quantize_kernel(jnp.asarray(w))
    tq_, ts = tq.quantize_kernel(_t(w.T))
    assert tq_.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(q).T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s))
    np.testing.assert_array_equal(
        tq.dequantize_kernel(tq_, ts, torch.float32).numpy(),
        np.asarray(jq.dequantize_kernel(q, s, jnp.float32)).T)


@pytest.mark.parametrize("din,dout,group", [(128, 48, 64), (64, 9, 16),
                                            (96, 4, 8), (256, 3, 128)])
def test_quantize_kernel_int4_bit_equal(din, dout, group):
    w = _weight(np.random.default_rng(group), din, dout)
    p, s = jq.quantize_kernel_int4(jnp.asarray(w), group)
    tp, ts = tq.quantize_kernel_int4(_t(w.T), group)
    assert tp.dtype == torch.uint8 and tp.shape == (dout, din // 2)
    assert ts.dtype == torch.float32 and ts.shape == (dout, din // group)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(p).T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(s).T)
    np.testing.assert_array_equal(
        tq.dequantize_kernel_int4(tp, ts, group, torch.float32).numpy(),
        np.asarray(jq.dequantize_kernel_int4(p, s, group, jnp.float32)).T)
    lo, hi = tq._unpack_int4(tp)
    jlo, jhi = jq._unpack_int4(p)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo).T)
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi).T)


def test_quantize_kernel_int4_refuses_an_indivisible_input_dim():
    with pytest.raises(ValueError):
        tq.quantize_kernel_int4(torch.zeros(4, 100), 64)


# ----- products -----

def test_quantized_matmul_w8a16_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 128)).astype(np.float32)
    w = _weight(rng, 128, 48)
    q, s = jq.quantize_kernel(jnp.asarray(w))
    ref = jq.quantized_matmul(jnp.asarray(x), q, s)
    got = tq.quantized_matmul(_t(x), *tq.quantize_kernel(_t(w.T)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


@pytest.mark.parametrize("pallas", [False, True])
@pytest.mark.parametrize("m,k,n", [(40, 128, 48), (2, 256, 7)])
def test_int8_matmul_matches_jax(monkeypatch, pallas, m, k, n):
    """Against JAX's XLA int8 dot and, with HAFF_INT8_PALLAS=1, its Pallas
    kernel in interpret mode."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((m, k)).astype(np.float32)
    x[0] = 0.0  # an all-zero token: activation scale 1
    w = _weight(rng, k, n)
    q, s = jq.quantize_kernel(jnp.asarray(w))
    if pallas:
        monkeypatch.setenv("HAFF_INT8_PALLAS", "1")
    ref = jq.int8_matmul(jnp.asarray(x), q, s)
    got = tq.int8_matmul(_t(x), *tq.quantize_kernel(_t(w.T)))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


def test_int8_matmul_plain_is_the_exact_integer_product():
    rng = np.random.default_rng(4)
    xq = rng.integers(-127, 128, (5, 300)).astype(np.int8)
    q = rng.integers(-127, 128, (9, 300)).astype(np.int8)
    sx = rng.random(5).astype(np.float32)
    sw = rng.random(9).astype(np.float32)
    got = tq.int8_matmul_plain(_t(xq), _t(q), _t(sx), _t(sw), torch.float32)
    acc = xq.astype(np.int64) @ q.astype(np.int64).T
    ref = acc.astype(np.float32) * sx[:, None] * sw[None, :]
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("mode", ["xla", "pallas_env", "pallas_k_tiled"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int4_matmul_matches_jax(monkeypatch, mode, dtype):
    """Against JAX's XLA path, HAFF_INT4_PALLAS=1 (interpret), and
    pallas_int4_matmul(interpret=True) on a K-tiled shape."""
    rng = np.random.default_rng(5)
    k, n, m, group = ((4096, 384, 24, 128) if mode == "pallas_k_tiled"
                      else (256, 72, 40, 64))
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = _weight(rng, k, n)
    p, s = jq.quantize_kernel_int4(jnp.asarray(w), group)
    xj = jnp.asarray(x).astype(jdt)
    if mode == "pallas_k_tiled":
        ref = jq.pallas_int4_matmul(xj, p, s, group=group, dtype=jdt,
                                    interpret=True)
    else:
        if mode == "pallas_env":
            monkeypatch.setenv("HAFF_INT4_PALLAS", "1")
        ref = jq.int4_matmul(xj, p, s, group=group)
    tp, ts = tq.quantize_kernel_int4(_t(w.T), group)
    got = tq.int4_matmul(_t(x).to(tdt), tp, ts, group)
    assert got.dtype == tdt and got.shape == (m, n)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32),
                               **(F32 if dtype == "float32" else BF16))


def test_int4_matmul_splits_on_m_and_group(monkeypatch):
    """Flattened M <= SMALL_M with group % 16 == 0 goes to the kernel's
    function (its plain version on the CPU); larger M, or another group,
    takes the dequantize + matmul route on every device."""
    calls = []
    for name in ("int4_matmul_plain", "int4_matmul_dequant"):
        monkeypatch.setattr(tq, name, lambda *a, _n=name, _f=getattr(tq, name):
                            (calls.append(_n), _f(*a))[1])
    w = torch.randn(8, 96, generator=torch.Generator().manual_seed(0))
    p16, s16 = tq.quantize_kernel_int4(w, 16)
    p8, s8 = tq.quantize_kernel_int4(w, 8)
    assert tq.SMALL_M == 256
    tq.int4_matmul(torch.zeros(2, 128, 96), p16, s16, 16)   # M = 256
    tq.int4_matmul(torch.zeros(257, 96), p16, s16, 16)
    tq.int4_matmul(torch.zeros(2, 96), p8, s8, 8)
    assert calls == ["int4_matmul_plain", "int4_matmul_dequant",
                     "int4_matmul_dequant"]
    x = torch.randn(3, 96, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(
        tq.int4_matmul(x, p8, s8, 8),
        x @ tq.dequantize_kernel_int4(p8, s8, 8, torch.float32).T, **F32)


# ----- QDense -----

@pytest.mark.parametrize("bits,group", [(8, 64), (4, 64), (4, 16)])
def test_quantized_qdense_matches_flax(bits, group):
    """Bias, 3-D input and out_split against flax QDense on the tree
    quantize_dense_tree makes."""
    rng = np.random.default_rng(bits + group)
    x = rng.standard_normal((2, 5, 128)).astype(np.float32)
    w, b = _weight(rng, 128, 96), rng.standard_normal(96).astype(np.float32)
    jmod = JaxQDense(96, dtype=jnp.float32)
    qtree = jq.quantize_dense_tree({"kernel": w, "bias": b}, lambda k: True,
                                   bits=bits, group=group)
    pm = QDense(128, 96)
    with torch.no_grad():
        pm.weight.copy_(_t(w.T))
        pm.bias.copy_(_t(b))
    pm.quantize_(bits, group)
    assert pm.quantized and pm.scale.dtype == torch.float32
    assert pm.weight.dtype == (torch.int8 if bits == 8 else torch.uint8)
    np.testing.assert_array_equal(pm.weight.numpy(),
                                  np.asarray(qtree["kernel"]).T)
    np.testing.assert_array_equal(pm.scale.numpy(),
                                  np.asarray(qtree["scale"]).T)
    with torch.no_grad():
        fused = pm(_t(x))
        parts = pm(_t(x), out_split=(32, 64))
    ref = jmod.apply({"params": qtree}, jnp.asarray(x))
    ref_parts = jmod.apply({"params": qtree}, jnp.asarray(x),
                           out_split=(32, 64))
    np.testing.assert_allclose(fused.numpy(), np.asarray(ref), **F32)
    for a, r in zip(parts, ref_parts):
        assert a.shape == r.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **F32)
    np.testing.assert_allclose(torch.cat(parts, -1).numpy(), fused.numpy(),
                               **F32)


def test_bits4_falls_back_to_int8_where_the_group_does_not_divide():
    pm = QDense(100, 6, bias=False)
    pm.quantize_(4, 64)
    assert pm.weight.dtype == torch.int8 and pm.scale.shape == (6,)


def test_float_qdense_is_unchanged():
    pm = QDense(16, 8)
    x = torch.randn(3, 16, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        ref = torch.nn.functional.linear(x, pm.weight, pm.bias)
        assert not pm.quantized
        assert torch.equal(pm(x), ref)
        a, b = pm(x, out_split=(3, 5))
        assert torch.equal(a, torch.nn.functional.linear(
            x, pm.weight[:3], pm.bias[:3]))
        assert torch.equal(b, torch.nn.functional.linear(
            x, pm.weight[3:], pm.bias[3:]))


@pytest.mark.parametrize("bits", [8, 4])
def test_scale_stays_float32_through_casts(bits):
    """model.to(bfloat16) casts floating parameters and buffers; a scale
    rounded to bfloat16 would be a silent fault."""
    pm = QDense(64, 8)
    pm.quantize_(bits, 16)
    scale = pm.scale.clone()
    assert pm.compute_dtype == torch.float32
    for cast in (lambda m: m.to(torch.bfloat16), lambda m: m.bfloat16(),
                 lambda m: m.half(), lambda m: m.to("cpu", torch.bfloat16)):
        cast(pm)
        assert pm.scale.dtype == torch.float32
        assert torch.equal(pm.scale, scale)
        assert not pm.weight.dtype.is_floating_point
    assert pm.bias.dtype == torch.bfloat16
    sd = pm.state_dict()
    assert set(sd) == {"weight", "scale", "bias"}
    assert sd["scale"].dtype == torch.float32


@pytest.mark.parametrize("bits", [8, 4])
def test_lora_dense_over_a_quantized_base(bits):
    """LoraDense.base is a QDense: quantizing it changes the base product
    only, y = quantized base(x) + (x a) b alpha / r, as flax LoraDense over
    a quantize_dense_tree'd base."""
    from haff_tpu.nn.lora import LoraDense as JaxLoraDense

    rng = np.random.default_rng(bits)
    x = rng.standard_normal((2, 3, 64)).astype(np.float32)
    w = _weight(rng, 64, 32)
    a = rng.standard_normal((64, 4)).astype(np.float32) * 0.1
    b = rng.standard_normal((4, 32)).astype(np.float32) * 0.1
    tree = {"base": {"kernel": w}, "lora_a": a, "lora_b": b}
    qtree = jq.quantize_dense_tree(tree, lambda k: k[-2] == "base", bits=bits,
                                   group=16)
    jmod = JaxLoraDense(features=32, rank=4, alpha=16.0, dropout=0.0,
                        dtype=jnp.float32)
    ref = jmod.apply({"params": qtree}, jnp.asarray(x), deterministic=True)
    pm = LoraDense(64, 32, rank=4, alpha=16.0)
    with torch.no_grad():
        pm.base.weight.copy_(_t(w.T))
        pm.lora_a.copy_(_t(a))
        pm.lora_b.copy_(_t(b))
        pm.base.quantize_(bits, 16)
        got = pm(_t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32)


# ----- predicates and the in-place model quantizer -----

@functools.lru_cache(maxsize=None)
def _flax_paths():
    _, params = jax_tiny_params()
    return sorted(traverse_util.flatten_dict(params))


@pytest.mark.parametrize("name", ["sam_encoder_predicate",
                                  "lisa_serving_predicate",
                                  "default_llm_predicate"])
def test_predicates_agree_on_every_parameter_of_the_tiny_model(name):
    """The port's predicate on each dotted parameter name equals JAX's on
    the flax path of the same parameter; each selects something."""
    jpred, tpred = getattr(jq, name), getattr(tq, name)
    picked = 0
    for path in _flax_paths():
        # A Dense kernel is the only leaf quantize_dense_tree acts on.
        torch_path = tuple(_torch_name(path).split("."))
        assert tpred(torch_path) == jpred(path), (path, torch_path)
        picked += bool(jpred(path)) and path[-1] == "kernel"
    assert picked > 0


def test_sam_encoder_predicate_skip_blocks():
    path = ("visual_model", "image_encoder", "blocks", "1", "attn", "qkv",
            "weight")
    assert tq.sam_encoder_predicate(path)
    assert not tq.sam_encoder_predicate(path, skip_blocks=(1,))
    assert not tq.sam_encoder_predicate(
        ("visual_model", "image_encoder", "neck_conv1", "weight"))


@pytest.mark.parametrize("bits,name", [(8, "lisa_serving_predicate"),
                                       (4, "default_llm_predicate")])
def test_quantize_model_in_place_selects_what_jax_selects(bits, name):
    _, params = jax_tiny_params()
    qtree = jq.quantize_dense_tree(params, getattr(jq, name), bits=bits,
                                   group=16)
    want = {_torch_name(p[:-1] + ("kernel",)).rsplit(".", 1)[0]
            for p in traverse_util.flatten_dict(qtree) if p[-1] == "scale"
            and p[:-1] + ("kernel",) in traverse_util.flatten_dict(qtree)
            and np.asarray(traverse_util.flatten_dict(qtree)[
                p[:-1] + ("kernel",)]).dtype in (np.int8, np.uint8)}
    model = tq.quantize_model_(port_model(params), getattr(tq, name),
                               bits=bits, group=16)
    got = {n for n, m in model.named_modules()
           if isinstance(m, QDense) and m.quantized}
    assert got == want and got
    assert all(p.dtype.is_floating_point for p in model.parameters())
    with pytest.raises(ValueError):
        tq.quantize_model_(model, getattr(tq, name), bits=3)


# ----- wrappers: forward only, CPU tensors never reach a kernel -----

def test_wrappers_raise_under_grad():
    x = torch.randn(2, 64, requires_grad=True)
    q, s = tq.quantize_kernel(torch.randn(8, 64))
    p, s4 = tq.quantize_kernel_int4(torch.randn(8, 64), 16)
    with pytest.raises(RuntimeError, match="forward-only"):
        tq.int8_matmul(x, q, s)
    with pytest.raises(RuntimeError, match="forward-only"):
        tq.int4_matmul(x, p, s4, 16)
    before = dict(_build.LAUNCHES)
    with torch.no_grad():
        assert tq.int8_matmul(x, q, s).shape == (2, 8)
        assert tq.int4_matmul(x, p, s4, 16).shape == (2, 8)
    assert dict(_build.LAUNCHES) == before  # CPU tensors: plain versions


def test_kernel_wrappers_refuse_cpu_tensors():
    q, s = tq.quantize_kernel(torch.randn(8, 64))
    xq, sx = tq.quantize_activation(torch.randn(2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        tq.int8_matmul_kernel(xq, q, sx[:, 0].contiguous(), s, torch.float32)
    p, s4 = tq.quantize_kernel_int4(torch.randn(8, 64), 16)
    with pytest.raises(ValueError, match="CUDA"):
        tq.int4_matmul_kernel(torch.randn(2, 64), p, s4, 16, torch.float32)
