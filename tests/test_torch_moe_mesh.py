"""MoE on a mesh (haff_tpu_torch/nn/moe.py under parallel/sharding.py
`shard_moe_`): expert parallelism, tensor-parallel experts and JAX's
global routing over a batch sharded over (data, fsdp), against the
one-process module and against haff_tpu's expert-parallel mesh
(tests/test_moe.py:142: MeshConfig(data=2, ep=2, tensor=2)).

A 4-expert top-2 MLP (hidden 8, mlp 16, float32, JAX's initialized
weights bridged), x of 4 rows x 8 tokens, in 4 gloo ranks (one spawn) on
data 2 x ep 2, ep 2 x tensor 2 and data 2 x fsdp 2: y, the aux term (the
shares summed over the batch shards), dx and every parameter's gradient
of sum(y^2) + aux within 1e-5 (+1e-4 relative) of the one-process
module's. Two cases: capacity factor 2 (no token drops), and capacity
factor 0.5 with a token mask, where the capacity binds and routing each
shard on its own would give another y and aux (asserted): the port
equals the global pool. Both cases against JAX's jitted module on its
MeshConfig(data=2, ep=2, tensor=2) mesh (x and the token mask sharded
over the batch, the Switch term sown and added to the loss): y, aux, dx
and every parameter's gradient, the router's included, within the same
1e-5 (+1e-4 relative).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from haff_tpu.core.config import LlamaConfig as JaxLlamaConfig
from haff_tpu.core.config import MeshConfig as JaxMeshConfig
from haff_tpu.core.mesh import build_mesh as jax_build_mesh
from haff_tpu.nn.moe import MoEMLP as JaxMoEMLP
from haff_tpu.parallel.sharding import param_shardings as jax_shardings
from haff_tpu.parallel.sharding import shard_batch_tree
from haff_tpu_torch.core.config import LlamaConfig
from haff_tpu_torch.nn.moe import MoEMLP
from haff_tpu_torch.tools.bridge import flax_to_state_dict
from torch_mesh_workers import run_ranks

MESHES = [(("data", 2), ("ep", 2)), (("ep", 2), ("tensor", 2)),
          (("data", 2), ("fsdp", 2))]
IDS = ["data2_ep2", "ep2_tensor2", "data2_fsdp2"]
FACTORS = (2.0, 0.5)


def _kw(cf):
    return dict(hidden_size=8, intermediate_size=16, num_layers=2,
                num_heads=2, num_kv_heads=2, head_dim=4, vocab_size=64,
                max_seq_len=32, moe_num_experts=4, moe_top_k=2,
                moe_capacity_factor=cf)


def _one_process(cfg, sd, x, mask):
    """y, aux, dx and the gradients of sum(y^2) + aux of one process."""
    mod = MoEMLP(cfg)
    mod.load_state_dict(sd)
    xt = x.clone().requires_grad_(True)
    y, aux = mod(xt, mask)
    (y.square().sum() + aux).backward()
    return dict(y=y.detach(), aux=aux.detach(), dx=xt.grad,
                grads={n: p.grad for n, p in mod.named_parameters()})


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    x = np.random.default_rng(7).standard_normal((4, 8, 8)).astype(
        np.float32)
    mask = np.ones((4, 8), bool)
    mask[1, 5:] = mask[3, 2:] = False
    jcfg = JaxLlamaConfig(**_kw(2.0))
    jmod = JaxMoEMLP(cfg=jcfg)
    boxed = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(np.asarray, fnn.unbox(boxed))
    sd = {k: torch.as_tensor(v).clone()
          for k, v in flax_to_state_dict(params).items()}
    out, refs = {}, {}
    for cf in FACTORS:
        m = None if cf == 2.0 else torch.tensor(mask)
        got = run_ranks("moe", dict(cfg=_kw(cf), sd=sd, x=torch.tensor(x),
                                    mask=m, meshes=MESHES), 4,
                        tmp_path_factory.mktemp(f"moe{cf}"))
        out[cf] = got
        refs[cf] = _one_process(LlamaConfig(**_kw(cf)), sd,
                                torch.tensor(x), m)

    mesh = jax_build_mesh(JaxMeshConfig(data=2, ep=2, tensor=2))
    placed = jax.tree_util.tree_map(jax.device_put, params,
                                    jax_shardings(mesh, boxed))
    jax_ref = {}
    for cf in FACTORS:
        jm = JaxMoEMLP(cfg=JaxLlamaConfig(**_kw(cf)))
        m = None if cf == 2.0 else jnp.asarray(mask)

        def loss(p, xx, mm, jm=jm):
            y, sown = jm.apply({"params": p}, xx, mm, mutable=("moe_aux",))
            aux = sown["moe_aux"]["load_balance"][0]
            return jnp.sum(y ** 2) + aux, (y, aux)

        with mesh:
            xs, ms = shard_batch_tree(mesh, (jnp.asarray(x), m))
            (_, (y, aux)), (g, dx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(placed, xs, ms)
        jax_ref[cf] = dict(y=np.asarray(y), aux=float(aux),
                           dx=np.asarray(dx), grads={
            k: np.asarray(v) for k, v in flax_to_state_dict(
                jax.tree_util.tree_map(np.asarray, g)).items()})
    return out, refs, jax_ref, sd, x, mask


def _close(have, want, what):
    have, want = np.asarray(have), np.asarray(want)
    err = np.abs(have - want).max()
    assert err <= 1e-5 + 1e-4 * np.abs(want).max(), (what, err)


@pytest.mark.parametrize("cf", FACTORS, ids=["cf2", "cf0.5_mask"])
@pytest.mark.parametrize("i", range(len(MESHES)), ids=IDS)
def test_moe_mesh_equals_one_process_global_routing(results, i, cf):
    out, refs, _, _, _, _ = results
    ref = refs[cf]
    for r in range(4):
        res = out[cf][r][i]
        _close(res["y"], ref["y"], ("y", r))
        _close(res["aux"], ref["aux"], ("aux", r))
        _close(res["dx"], ref["dx"], ("dx", r))
        for name, g in ref["grads"].items():
            _close(res["grads"][name], g, (name, r))


def test_capacity_binds_and_per_shard_routing_would_differ(results):
    """At capacity factor 0.5 routing each half of the batch alone (the
    per-shard pool) gives another output and aux than the global pool,
    which the mesh runs reproduce."""
    _, refs, _, sd, x, mask = results
    cfg = LlamaConfig(**_kw(0.5))
    halves = [_one_process(cfg, sd, torch.tensor(x[h * 2:(h + 1) * 2]),
                           torch.tensor(mask[h * 2:(h + 1) * 2]))
              for h in range(2)]
    y_local = torch.cat([h["y"] for h in halves])
    assert float((y_local - refs[0.5]["y"]).abs().max()) > 1e-3
    # The aux of the global pool is not the mean of the halves' terms.
    assert abs(float(sum(h["aux"] for h in halves)) / 2
               - float(refs[0.5]["aux"])) > 1e-4


@pytest.mark.parametrize("cf", FACTORS, ids=["cf2", "cf0.5_mask"])
@pytest.mark.parametrize("i", range(len(MESHES)), ids=IDS)
def test_moe_mesh_equals_jax_expert_parallel_mesh(results, i, cf):
    out, _, jax_ref, _, _, _ = results
    ref = jax_ref[cf]
    assert set(ref["grads"]) == set(out[cf][0][i]["grads"])
    for r in range(4):
        res = out[cf][r][i]
        _close(res["y"], ref["y"], ("y", r))
        _close(res["aux"], ref["aux"], ("aux", r))
        _close(res["dx"], ref["dx"], ("dx", r))
        for name, g in ref["grads"].items():
            _close(res["grads"][name], g, (name, r))
