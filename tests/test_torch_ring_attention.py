"""The port's ring attention (haff_tpu_torch/parallel/ring_attention.py)
against haff_tpu's `sequence_sharded_attention` on its 8-device `sp` mesh
(Pallas in interpret mode, as tests/test_ring_attention.py runs it).

The port runs in 4 gloo ranks on the CPU (tests/torch_mesh_workers.py,
one spawn for every case): sp = 4; sp = 2 x tensor = 2 with the heads
sharded (`heads_axis`); data = 2 x sp = 2 with the batch sharded
(`batch_axes`). Cases: causal and not, the rectangular cross-attention
(Lk = 2 Lq), padding segment ids (a row whose tail chunks hold no key),
and packed sequences. Forward and gradients of sum(out * g) within 2e-5
(float32); each rank's chunk relations counted (causal: rank i runs i
past chunks, one diagonal and skips 3 - i).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from haff_tpu.parallel.ring_attention import \
    sequence_sharded_attention as jax_ring
from torch_mesh_workers import Ranks

B, L, H, D = 2, 128, 2, 32
TOL = 2e-5
SP4 = (("data", 1), ("sp", 4))
SP2_TP2 = (("data", 1), ("sp", 2), ("tensor", 2))
DP2_SP2 = (("data", 2), ("sp", 2))


def _inputs():
    rng = np.random.default_rng(0)
    r = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)  # noqa
    pad = (np.arange(L)[None, :] < np.array([[100], [40]])).astype(np.int32)
    packed = np.zeros((B, L), np.int32)
    packed[:, :50] = 1
    packed[:, 50:110] = 2
    return dict(q=r(B, L, H, D), k=r(B, L, H, D), v=r(B, L, H, D),
                k2=r(B, 2 * L, H, D), v2=r(B, 2 * L, H, D), g=r(B, L, H, D),
                pad=pad, packed=packed)


def _cases(x):
    """(name, mesh, kwargs of the call, k/v names, segment ids, weight)."""
    cases = []
    for mesh, extra in ((SP4, {}), (SP2_TP2, {"heads_axis": "tensor"}),
                        (DP2_SP2, {"batch_axes": "data"})):
        for causal in (False, True):
            cases.append((f"{dict(mesh)}-causal{causal}", mesh,
                          dict(causal=causal, **extra), "kv", None))
        cases.append((f"{dict(mesh)}-packed", mesh,
                      dict(causal=True, **extra), "kv", "packed"))
    cases.append(("rectangular", SP4, dict(causal=False), "kv2", None))
    cases.append(("padding", SP4, dict(causal=False), "kv", "pad"))
    return cases


def _valid(x, seg):
    return (np.ones((B, L, 1, 1), np.float32) if seg is None
            else (x[seg] != 0).astype(np.float32)[:, :, None, None])


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    x = _inputs()
    cases = _cases(x)
    payload = dict(meshes=[SP4, SP2_TP2, DP2_SP2], cases=[])
    for _, mesh, kw, kv, seg in cases:
        k, v = (x["k"], x["v"]) if kv == "kv" else (x["k2"], x["v2"])
        payload["cases"].append(dict(
            mesh=mesh, q=torch.tensor(x["q"]), k=torch.tensor(k),
            v=torch.tensor(v), g=torch.tensor(x["g"]),
            seg=None if seg is None else torch.tensor(x[seg]),
            weight=torch.tensor(_valid(x, seg)), **kw))
    ranks = Ranks("ring", payload, 4, tmp_path_factory.mktemp("ring"))
    # JAX on its 8-device sp mesh, one reference a distinct call.
    mesh = Mesh(np.array(jax.devices()).reshape(8), ("sp",))
    refs = {}
    for name, _, kw, kv, seg in cases:
        key = (kw["causal"], kv, seg)
        if key in refs:
            continue
        k, v = (x["k"], x["v"]) if kv == "kv" else (x["k2"], x["v2"])
        s = None if seg is None else jnp.asarray(x[seg])
        w = jnp.asarray(_valid(x, seg))

        def loss(q, k, v, s=s, w=w, causal=kw["causal"]):
            out = jax_ring(mesh, "sp", q, k, v, q_segment_ids=s,
                           causal=causal)
            return jnp.sum(out * jnp.asarray(x["g"]) * w), out

        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(
                jnp.asarray(x["q"]), jnp.asarray(k), jnp.asarray(v))
        refs[key] = (np.asarray(out),) + tuple(np.asarray(g) for g in grads)
    got = ranks.join()
    return cases, refs, got, x


def test_forward_and_gradients_match_jax_ring(results):
    cases, refs, got, x = results
    for i, (name, _, kw, kv, seg) in enumerate(cases):
        out, dq, dk, dv = refs[(kw["causal"], kv, seg)]
        w = _valid(x, seg)
        for r in range(4):
            res = got[r][i]
            np.testing.assert_allclose(res["out"].numpy() * w, out * w,
                                       atol=TOL, err_msg=f"{name} rank {r}")
            for what, want in (("dq", dq), ("dk", dk), ("dv", dv)):
                np.testing.assert_allclose(res[what].numpy(), want, atol=TOL,
                                           err_msg=f"{name} {what} rank {r}")


@pytest.mark.parametrize("mesh,n", [(SP4, 4), (SP2_TP2, 2), (DP2_SP2, 2)])
def test_each_rank_runs_its_chunk_relations(results, mesh, n):
    """Causal: the rank at ring index i runs i past chunks (dense), its
    diagonal (causal) and skips the n - 1 - i future ones, forward and
    backward: n (n + 1) / 2 kernel calls a ring. Not causal: n dense."""
    cases, _, got, _ = results
    for i, (name, m, kw, _, _) in enumerate(cases):
        if m != mesh:
            continue
        for r in range(4):
            idx = r // (2 if mesh == SP2_TP2 else 1) % n
            rel = got[r][i]["relations"]
            for kind in ("fwd", "bwd"):
                if kw["causal"]:
                    want = {f"{kind}/past": idx, f"{kind}/diagonal": 1,
                            f"{kind}/future": n - 1 - idx}
                else:
                    want = {f"{kind}/past": n}
                have = {k: v for k, v in rel.items() if k.startswith(kind)}
                assert have == {k: v for k, v in want.items() if v}, (
                    name, r, rel)


def test_chunks_must_be_8_aligned():
    from haff_tpu_torch.core.mesh import Mesh as PortMesh
    from haff_tpu_torch.parallel.ring_attention import \
        sequence_sharded_attention

    q = torch.zeros((1, 60, 2, 8))
    jmesh = Mesh(np.array(jax.devices()).reshape(8), ("sp",))
    with pytest.raises(ValueError) as want:
        jax_ring(jmesh, "sp", jnp.zeros((1, 60, 2, 8)),
                 jnp.zeros((1, 60, 2, 8)), jnp.zeros((1, 60, 2, 8)))
    with pytest.raises(ValueError) as got:
        sequence_sharded_attention(PortMesh((1, 1, 1, 1, 8, 1)), "sp", q, q,
                                   q)
    assert str(got.value) == str(want.value)
