"""Every public entry of haff_tpu_torch/kernels/sam_attention.py against
the JAX entry of the same name, forward and backward, at geometries that
really reach the Pallas kernel named (asserted by a spy on the JAX side,
kernels in interpret mode):

* `sam_window_attention_qkv` -> `_window_qkv_kernel_db` (nh 16, d 16 with
  HAFF_WINDOW_IKBAND=0, and a non-square window, where the in-kernel band
  is off by itself), odd window counts, tile-pad rows on the JAX side only;
* `sam_window_attention_qkv_split` / `_qkv` -> `_window_qkv_kernel` at the
  small preset's geometry (nh 8, d 32, window 8) and ViT-B's heads (nh 12,
  d 64), which fail both of the JAX lane guards;
* `sam_global_attention` -> `_fused_fwd` (16 x 16, nh 2, d 16);
* `sam_window_attention` -> `_window_fwd`.

Float32 on both sides. Forward tolerance 2e-5 (summation order over
<= 256-term softmax sums). Gradients of sum(out * g) for a fixed random g:
within 1e-3 of each leaf's largest magnitude; the rel-pos tables' exactly
zero where the JAX fused global path runs and true elsewhere (tiny's
8 x 8 grid, `train_rel_pos=True`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haff_tpu.kernels import sam_attention as jsa
from haff_tpu_torch.kernels import sam_attention as tsa
from test_torch_sam_attention import TOL, _spy


def _inputs(seed, shapes, scales):
    rng = np.random.default_rng(seed)
    return [(s * rng.standard_normal(shape)).astype(np.float32)
            for shape, s in zip(shapes, scales)]


def _tables(rng_seed, hw, d):
    return _inputs(rng_seed, [(2 * hw[0] - 1, d), (2 * hw[1] - 1, d)],
                   [0.5, 0.5])


def _jax_value_and_grads(fn, arrays, g):
    """fn(*arrays) and the gradients of sum(fn(*arrays) * g) w.r.t. each."""
    arrays = [jnp.asarray(a) for a in arrays]
    out = fn(*arrays)
    grads = jax.grad(lambda *a: jnp.sum(fn(*a) * g),
                     argnums=tuple(range(len(arrays))))(*arrays)
    return np.asarray(out), [np.asarray(x) for x in grads]


def _torch_value_and_grads(fn, arrays, g):
    ts = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    out = fn(*ts)
    grads = torch.autograd.grad(out, ts, torch.from_numpy(g))
    return out.detach().numpy(), [x.numpy() for x in grads]


def _compare(got, ref, names, zero=()):
    out_g, grads_g = got
    out_r, grads_r = ref
    np.testing.assert_allclose(out_g, out_r, **TOL)
    for name, a, b in zip(names, grads_g, grads_r):
        if name in zero:
            assert not b.any(), f"JAX gives {name} a gradient here"
            assert not a.any(), f"{name}: expected exact zeros"
            continue
        scale = float(np.abs(b).max())
        assert scale > 0, name
        err = float(np.abs(a - b).max())
        assert err <= 1e-3 * scale, (name, err, scale)


# --------------------------------------------------------------------------
# Row 9: the fused-operand window entry onto _window_qkv_kernel_db
# --------------------------------------------------------------------------

@pytest.mark.parametrize("nwin,hw,ikband", [(5, (8, 8), "0"), (3, (6, 4), "1"),
                                            (1, (5, 7), "1")])
def test_window_qkv_matches_db_kernel(monkeypatch, nwin, hw, ikband):
    """(5, 7): 35 rows, tile-padded to 40 on the JAX side only."""
    monkeypatch.setenv("HAFF_WINDOW_IKBAND", ikband)
    nh, d = 16, 16
    c, lcont = nh * d, hw[0] * hw[1]
    lpad = -(-lcont // 8) * 8
    qkv, = _inputs(nwin, [(nwin, lpad, 3 * c)], [1.0])
    rel_h, rel_w = _tables(1, hw, d)
    g, = _inputs(2, [(nwin, lcont, c)], [1.0])
    gpad = np.zeros((nwin, lpad, c), np.float32)
    gpad[:, :lcont] = g
    calls = _spy(monkeypatch, "_window_qkv_kernel_db")
    out, grads = _jax_value_and_grads(
        lambda a, rh, rw: jsa.sam_window_attention_qkv(a, rh, rw, hw, nh,
                                                       interpret=True),
        [qkv, rel_h, rel_w], gpad)
    assert calls, "the JAX call did not reach _window_qkv_kernel_db"
    ref = (out[:, :lcont], [grads[0][:, :lcont]] + grads[1:])
    got = _torch_value_and_grads(
        lambda a, rh, rw: tsa.sam_window_attention_qkv(a, rh, rw, hw, nh),
        [qkv[:, :lcont], rel_h, rel_w], g)
    _compare(got, ref, ("qkv", "rel_h", "rel_w"))


# --------------------------------------------------------------------------
# Row 10: geometries that fail both lane guards -> _window_qkv_kernel
# --------------------------------------------------------------------------

@pytest.mark.parametrize("nh,d,w,nwin", [(8, 32, 8, 3), (12, 64, 6, 2)])
def test_window_split_and_fused_match_head_loop_kernel(monkeypatch, nh, d, w,
                                                       nwin):
    c, l = nh * d, w * w
    hw = (w, w)
    q3, kv3 = _inputs(nh, [(nwin, l, c), (nwin, l, 2 * c)], [1.0, 1.0])
    rel_h, rel_w = _tables(3, hw, d)
    g, = _inputs(4, [(nwin, l, c)], [1.0])
    calls = _spy(monkeypatch, "_window_qkv_kernel")
    ref = _jax_value_and_grads(
        lambda a, b, rh, rw: jsa.sam_window_attention_qkv_split(
            a, b, rh, rw, hw, nh, interpret=True),
        [q3, kv3, rel_h, rel_w], g)
    assert calls, "the JAX split call did not reach _window_qkv_kernel"
    got = _torch_value_and_grads(
        lambda a, b, rh, rw: tsa.sam_window_attention_qkv_split(
            a, b, rh, rw, hw, nh), [q3, kv3, rel_h, rel_w], g)
    _compare(got, ref, ("q3", "kv3", "rel_h", "rel_w"))

    # The fused-operand entry on the same numbers: the same kernel on the
    # JAX side, the same values and gradients on both.
    del calls[:]
    qkv = np.concatenate([q3, kv3], axis=-1)
    ref_f = _jax_value_and_grads(
        lambda a, rh, rw: jsa.sam_window_attention_qkv(a, rh, rw, hw, nh,
                                                       interpret=True),
        [qkv, rel_h, rel_w], g)
    assert calls, "the JAX fused call did not reach _window_qkv_kernel"
    got_f = _torch_value_and_grads(
        lambda a, rh, rw: tsa.sam_window_attention_qkv(a, rh, rw, hw, nh),
        [qkv, rel_h, rel_w], g)
    _compare(got_f, ref_f, ("qkv", "rel_h", "rel_w"))
    np.testing.assert_allclose(got_f[0], got[0], rtol=0, atol=0)
    np.testing.assert_allclose(
        got_f[1][0], np.concatenate([got[1][0], got[1][1]], -1), rtol=1e-6,
        atol=1e-7)


# --------------------------------------------------------------------------
# Rows 11 and 12: the per-head entries
# --------------------------------------------------------------------------

def _per_head(seed, b, hw, nh, d):
    l = hw[0] * hw[1]
    q, k, v = _inputs(seed, [(b, l, nh, d)] * 3, [0.5, 0.5, 1.0])
    rel_h, rel_w = _tables(seed + 1, hw, d)
    g, = _inputs(seed + 2, [(b, l, nh, d)], [1.0])
    return [q, k, v, rel_h, rel_w], g


def test_global_per_head_matches_fused_kernel(monkeypatch):
    hw, nh, d = (16, 16), 2, 16
    arrays, g = _per_head(5, 2, hw, nh, d)
    calls = _spy(monkeypatch, "_fused_fwd")
    ref = _jax_value_and_grads(
        lambda *a: jsa.sam_global_attention(*a, hw, interpret=True), arrays, g)
    assert calls, "the JAX call did not reach _fused_fwd"
    got = _torch_value_and_grads(
        lambda *a: tsa.sam_global_attention(*a, hw), arrays, g)
    assert tsa.global_tables_frozen(hw)
    _compare(got, ref, ("q", "k", "v", "rel_h", "rel_w"),
             zero=("rel_h", "rel_w"))


@pytest.mark.parametrize("hw", [(14, 14), (4, 6)])
def test_window_per_head_matches_window_kernel(monkeypatch, hw):
    nh, d = 2, 32
    arrays, g = _per_head(8, 4, hw, nh, d)
    calls = _spy(monkeypatch, "_window_fwd")
    ref = _jax_value_and_grads(
        lambda *a: jsa.sam_window_attention(*a, hw, interpret=True), arrays, g)
    assert calls, "the JAX call did not reach _window_fwd"
    got = _torch_value_and_grads(
        lambda *a: tsa.sam_window_attention(*a, hw), arrays, g)
    _compare(got, ref, ("q", "k", "v", "rel_h", "rel_w"))


# --------------------------------------------------------------------------
# The global fused-qkv entry's gradients, and the table-gradient rule
# --------------------------------------------------------------------------

@pytest.mark.parametrize("hw,nh,d,kw,zero", [
    ((32, 32), 2, 128, {}, True),        # JAX: _global_qkv, tables frozen
    ((16, 16), 2, 16, {}, True),         # JAX: falls to _fused, frozen
    ((16, 16), 2, 16, dict(train_rel_pos=True), False),
    ((8, 8), 2, 16, {}, False),          # tiny's grid: JAX leaves for XLA
    ((12, 20), 2, 16, {}, False),        # W % 8 != 0: XLA; ragged 64-row tile
])
def test_global_qkv_gradients_and_table_rule(hw, nh, d, kw, zero):
    l, c = hw[0] * hw[1], nh * d
    qkv, = _inputs(l, [(1, l, 3 * c)], [0.5])
    rel_h, rel_w = _tables(6, hw, d)
    g, = _inputs(7, [(1, l, c)], [1.0])
    ref = _jax_value_and_grads(
        lambda a, rh, rw: jsa.sam_global_attention_qkv(
            a, rh, rw, hw, nh, interpret=True, **kw), [qkv, rel_h, rel_w], g)
    got = _torch_value_and_grads(
        lambda a, rh, rw: tsa.sam_global_attention_qkv(a, rh, rw, hw, nh, **kw),
        [qkv, rel_h, rel_w], g)
    assert tsa.global_tables_frozen(hw) == (zero or bool(kw))
    _compare(got, ref, ("qkv", "rel_h", "rel_w"),
             zero=("rel_h", "rel_w") if zero else ())


def test_force_xla_takes_the_plain_version_with_true_table_gradients():
    hw, nh, d = (16, 16), 2, 8
    arrays, g = _per_head(11, 1, hw, nh, d)
    out, grads = _torch_value_and_grads(
        lambda *a: tsa.sam_global_attention(*a, hw, force_xla=True), arrays, g)
    ref = _torch_value_and_grads(
        lambda *a: tsa.relpos_attention_plain(*a, hw, d ** -0.5), arrays, g)
    np.testing.assert_array_equal(out, ref[0])
    assert grads[3].any() and grads[4].any()
    for a, b in zip(grads, ref[1]):
        np.testing.assert_array_equal(a, b)


def test_banded_backward_never_builds_an_l_by_l_tensor(monkeypatch):
    """The largest tensor the banded backward makes has L * max(H, W, d)
    elements a (batch, head): checked by wrapping torch.empty_like / exp."""
    hw, nh, d = (32, 32), 1, 8
    l = hw[0] * hw[1]
    arrays, g = _per_head(12, 1, hw, nh, d)
    seen = []
    real_exp = torch.exp
    monkeypatch.setattr(torch, "exp", lambda t: seen.append(t.numel())
                        or real_exp(t))
    _torch_value_and_grads(lambda *a: tsa.sam_global_attention(*a, hw),
                           arrays, g)
    assert seen and max(seen) <= l * max(hw) * nh


def test_operand_views_are_not_copies():
    """The entries hand the kernels views of the caller's storage."""
    qkv = torch.zeros(2, 16, 3 * 16)
    views = [tsa.head_view(qkv, 3, i, 2) for i in range(3)]
    for i, v in enumerate(views):
        assert v.shape == (2, 16, 2, 8)
        assert v.untyped_storage().data_ptr() == qkv.untyped_storage().data_ptr()
        assert v.storage_offset() == i * 16 and v.stride() == (768, 48, 8, 1)
    with pytest.raises(ValueError, match="heads wide"):
        tsa.head_view(qkv, 3, 0, 5)
