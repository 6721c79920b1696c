"""The split decode attention of the port (csrc/decode_attn.cu's algorithm,
haff_tpu_torch/kernels/decode_attention.py `decode_plan` and
`decode_attention_split`), checked on the CPU before the card sees it:

* the split plan is a pure function of the shapes (batch, heads, kv heads,
  cache slots), never of the mask, keeps each split to at most 64 slots,
  covers the cache with no empty split, and gives several blocks an SM at
  LLaMA-7B's decode step (batch 2, 32 heads, 591 slots);
* the split-and-merge algorithm (each split's softmax state, an empty one
  for a split with no live slot, then the online-softmax merge) in float32
  agrees with the plain version and, through it, with haff_tpu's
  `flash_decode_attention` (its XLA path at 591 slots, its Pallas kernel
  in interpret mode at the 1024 slots it takes): dead splits, an all-dead
  row (exactly 0), int8 and bf16 caches, GQA, live lengths (590, 1) and
  (590, 590) at narrow heads.

Tolerances as tests/test_torch_decode_attention.py: 2e-5 for a float
cache, 2e-4 against JAX for an int8 cache (JAX's XLA path multiplies each
int8 value by its scale before the dot); the emulation against the plain
version differs only by summation order (2e-5 either way).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haff_tpu.kernels import decode_attention as jda
from haff_tpu.nn import quant as jq
from haff_tpu_torch.kernels import decode_attention as da
from haff_tpu_torch.nn import quant as tq

FP = dict(rtol=2e-5, atol=2e-5)
INT8 = dict(rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("b,nh,nkv,lmax", [
    (2, 32, 32, 591), (2, 32, 32, 1), (1, 32, 32, 591), (2, 32, 8, 591),
    (2, 64, 4, 300), (3, 4, 4, 5), (2, 8, 2, 70), (2, 16, 4, 1500),
    (64, 32, 32, 2048), (1, 4, 1, 33), (2, 32, 32, 0)])
def test_plan_covers_the_cache(b, nh, nkv, lmax):
    splits, chunk = da.decode_plan(b, nh, nkv, lmax)
    assert 1 <= chunk <= da.CHUNK_MAX and splits >= 1
    assert splits * chunk >= lmax
    assert splits == 1 or (splits - 1) * chunk < lmax  # no empty split
    assert (splits, chunk) == da.decode_plan(b, nh, nkv, lmax)  # pure


def test_plan_depends_on_shapes_only():
    """Its inputs are four integers (no mask, no lengths, no tensor), so a
    decode step chooses its split with no device sync; at LLaMA-7B's
    decode step it gives several blocks an SM of the H100's 132."""
    assert list(inspect.signature(da.decode_plan).parameters) == [
        "b", "nh", "nkv", "lmax"]
    splits, chunk = da.decode_plan(2, 32, 32, 591)
    assert 2 * 32 * splits >= 4 * 132 and chunk >= da.MIN_CHUNK
    # More rows or heads need fewer splits; a longer cache keeps <= 64 slots.
    assert da.decode_plan(64, 32, 32, 591)[0] <= splits
    assert da.decode_plan(64, 32, 32, 4096) == (64, 64)


def make_inputs(b, lmax, nh, nkv, hd, lengths, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, nh, hd).astype(np.float32) * 0.3
    k = rng.randn(b, lmax, nkv, hd).astype(np.float32) * 0.3
    v = rng.randn(b, lmax, nkv, hd).astype(np.float32)
    mask = (np.arange(lmax)[None] < np.asarray(lengths)[:, None]).astype(
        np.int32)
    return q, k, v, mask


def _caches(k, v, kind):
    k, v = torch.from_numpy(k), torch.from_numpy(v)
    if kind == "int8":
        return tq.quantize_activation(k), tq.quantize_activation(v)
    if kind == "bf16":
        return k.bfloat16(), v.bfloat16()
    return k, v


def _jax(q, k, v, mask, kind, use_kernel):
    """haff_tpu's decode attention on the same values as the port's caches
    (a bf16 cache handed over as its float32 values)."""
    q, mask = jnp.asarray(q), jnp.asarray(mask)
    if kind == "int8":
        k, v = jq.quantize_activation(jnp.asarray(k)), jq.quantize_activation(
            jnp.asarray(v))
    else:
        if kind == "bf16":
            k, v = (torch.from_numpy(a).bfloat16().float().numpy()
                    for a in (k, v))
        k, v = jnp.asarray(k), jnp.asarray(v)
    if use_kernel:
        return np.asarray(jda.flash_decode_attention(
            q, k, v, mask, use_kernel=True, interpret=True))
    return np.asarray(jda._xla_path(q, k, v, mask, q.shape[-1] ** -0.5))


SPLIT_CASES = [
    # b, lmax, nh, nkv, hd, live lengths
    (2, 591, 4, 4, 32, (590, 1)),     # row 1: every split but the first dead
    (2, 591, 4, 4, 32, (590, 590)),
    (2, 591, 8, 2, 16, (590, 1)),     # GQA, 4 query heads a kv head
    (2, 200, 16, 1, 16, (7, 200)),    # 16 a kv head: two head blocks
    (3, 70, 4, 4, 16, (70, 18, 36)),  # a split boundary at 18, 36
]


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("b,lmax,nh,nkv,hd,lengths", SPLIT_CASES)
def test_split_and_merge_matches_plain_and_jax(kind, b, lmax, nh, nkv, hd,
                                               lengths):
    q, k, v, mask = make_inputs(b, lmax, nh, nkv, hd, lengths,
                                seed=lmax + nh + hd)
    kc, vc = _caches(k, v, kind)
    tqv, tmask = torch.from_numpy(q), torch.from_numpy(mask)
    scale = hd ** -0.5
    assert da.decode_plan(b, nh, nkv, lmax)[0] > 1  # the merge is exercised
    got = da.decode_attention_split(tqv, kc, vc, tmask, scale)
    plain = da.decode_attention_plain(tqv, kc, vc, tmask, scale)
    assert got.dtype == torch.float32 and got.shape == (b, nh, hd)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), **FP)
    ref = _jax(q, k, v, mask, kind, use_kernel=False)
    np.testing.assert_allclose(got.numpy(), ref,
                               **(INT8 if kind == "int8" else FP))


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_split_and_merge_matches_the_pallas_kernel(kind):
    """At 1024 slots and head_dim 128, a geometry the Pallas kernel takes
    (interpret mode), with an all-dead row: the port's merge gives exactly
    0 there, as the Pallas kernel's clamped denominator does."""
    q, k, v, mask = make_inputs(2, 1024, 8, 4, 128, (0, 700), seed=3)
    kc, vc = _caches(k, v, kind)
    got = da.decode_attention_split(torch.from_numpy(q), kc, vc,
                                    torch.from_numpy(mask), 128 ** -0.5)
    assert not got[0].any() and got[1].abs().sum() > 0
    ref = _jax(q, k, v, mask, kind, use_kernel=True)
    np.testing.assert_allclose(got.numpy(), ref,
                               **(INT8 if kind == "int8" else FP))


@pytest.mark.parametrize("plan", [(1, 591), (10, 60), (37, 16), (591, 1)])
def test_any_split_gives_the_same_softmax(plan):
    """The merge is exact algebra: one split, the 7B plan, many short
    splits and one slot a split agree with the plain version; dead splits
    (every split of row 1 but the first) and an all-dead row carry no
    weight."""
    q, k, v, mask = make_inputs(3, 591, 4, 4, 16, (590, 1, 0), seed=11)
    kc, vc = _caches(k, v, "int8")
    args = (torch.from_numpy(q), kc, vc, torch.from_numpy(mask), 0.25)
    got = da.decode_attention_split(*args, plan=plan)
    np.testing.assert_allclose(got.numpy(),
                               da.decode_attention_plain(*args).numpy(), **FP)
    assert not got[2].any()
