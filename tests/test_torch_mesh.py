"""The port's mesh (haff_tpu_torch/core/mesh.py), batch sharding
(parallel/sharding.py `shard_batch_tree`) and collectives
(parallel/collectives.py) against haff_tpu's on its 8-device CPU mesh.

* `build_mesh`: the axes, the data = -1 fill, the rank layout (row-major,
  as JAX lays out `jax.devices()`) and both errors word for word.
* `shard_batch_tree`: every rank's block equal to JAX's shard on the
  device at the same mesh coordinates, the small-table replication, and
  the mis-sized batch error word for word.
* In 4 gloo ranks (one spawn): `maybe_initialize_distributed` is a no-op
  under an existing group, the groups' ranks, and the collectives'
  transposes (slice -> gather gives the gradient back unsummed,
  reduce_from_tp gives 1 where torch's differentiable all_reduce gives the
  group size, copy_to_tp sums the ranks' partials, ppermute's gradient
  travels back).
"""

import jax
import numpy as np
import pytest
import torch

from haff_tpu.core.config import MeshConfig as JaxMeshConfig
from haff_tpu.core.mesh import AXES as JAX_AXES
from haff_tpu.core.mesh import build_mesh as jax_build_mesh
from haff_tpu.parallel.sharding import shard_batch_tree as jax_shard_batch
from haff_tpu_torch.core.config import MeshConfig
from haff_tpu_torch.core.mesh import (AXES, Mesh, build_mesh,
                                     maybe_initialize_distributed)
from haff_tpu_torch.parallel.sharding import shard_batch_tree
from torch_mesh_workers import run_ranks

CONFIGS = [dict(data=-1), dict(data=-1, fsdp=2), dict(data=2, fsdp=2,
                                                      tensor=2),
           dict(data=-1, sp=4, tensor=2), dict(data=1, pp=2, fsdp=2, sp=2)]


def test_axes_match_jax():
    assert AXES == JAX_AXES


@pytest.mark.parametrize("kw", CONFIGS, ids=str)
def test_layout_matches_jax(kw):
    jm = jax_build_mesh(JaxMeshConfig(**kw))
    pm = build_mesh(MeshConfig(**kw), world_size=8)
    assert dict(pm.shape) == dict(jm.shape)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    np.testing.assert_array_equal(pm.ranks, ids)
    # each rank's coordinates: where JAX put the device of that id
    for r in range(8):
        where = dict(zip(AXES, (int(i[0]) for i in np.nonzero(ids == r))))
        assert Mesh(pm.sizes, rank=r).coords == where


@pytest.mark.parametrize("kw", [dict(data=-1, fsdp=3),
                                dict(data=3, fsdp=2)], ids=str)
def test_errors_match_jax(kw):
    with pytest.raises(ValueError) as want:
        jax_build_mesh(JaxMeshConfig(**kw))
    with pytest.raises(ValueError) as got:
        build_mesh(MeshConfig(**kw), world_size=8)
    assert str(got.value) == str(want.value)


def test_shard_batch_tree_matches_jax_shards():
    kw = dict(data=2, fsdp=2, tensor=2)
    jm = jax_build_mesh(JaxMeshConfig(**kw))
    batch = {"rows": np.arange(24, dtype=np.float32).reshape(8, 3),
             "table": np.arange(3, dtype=np.float32),   # < 4 shards
             "images": np.arange(16, dtype=np.float32).reshape(4, 4)}
    with jm:
        placed = jax_shard_batch(jm, {k: jax.numpy.asarray(v)
                                      for k, v in batch.items()})
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for r in range(8):
        mesh = Mesh(build_mesh(MeshConfig(**kw), world_size=8).sizes, rank=r)
        local = shard_batch_tree(mesh, {k: torch.tensor(v)
                                        for k, v in batch.items()})
        for k, arr in placed.items():
            shard = next(s for s in arr.addressable_shards
                         if s.device.id == int(ids.reshape(-1)[r]))
            np.testing.assert_array_equal(local[k].numpy(),
                                          np.asarray(shard.data), err_msg=k)


def test_mis_sized_batch_error_matches_jax():
    kw = dict(data=2, fsdp=2, tensor=2)
    jm = jax_build_mesh(JaxMeshConfig(**kw))
    with pytest.raises(ValueError) as want:
        jax_shard_batch(jm, {"x": jax.numpy.zeros((6, 2))})
    mesh = build_mesh(MeshConfig(**kw), world_size=8)
    with pytest.raises(ValueError) as got:
        shard_batch_tree(mesh, {"x": torch.zeros((6, 2))})
    assert str(got.value) == str(want.value)


def test_maybe_initialize_distributed_without_a_launcher_is_a_no_op(
        monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    maybe_initialize_distributed("cpu")
    assert not torch.distributed.is_initialized()
    assert build_mesh().size == 1


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks("mesh", {}, 4, tmp_path_factory.mktemp("mesh"))


def test_ranks_groups_and_batch_blocks(ranks):
    for r, out in enumerate(ranks):
        assert out["still_gloo"] == "gloo"
        assert out["shape"] == dict(zip(AXES, (2, 1, 2, 1, 1, 1)))
        assert out["batch_ranks"] == [0, 1, 2, 3]
        np.testing.assert_array_equal(out["local"]["x"].numpy(),
                                      np.arange(8.0).reshape(4, 2)[r:r + 1])
        np.testing.assert_array_equal(out["local"]["table"].numpy(),
                                      np.arange(3.0))
        assert "does not divide 4 batch shards" in out["error"]


def test_collectives_take_jax_transposes(ranks):
    """Slice then gather of a replicated input returns the gradient
    unsummed; reduce_from_tp into a replicated loss passes 1 back (torch's
    differentiable all_reduce gives the group size, 4, there); copy_to_tp
    into per-rank partial losses (rank r weighs by r + 1) sums them, 10;
    ppermute moves values one rank ahead and the gradient back."""
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["slice_gather_grad"].numpy(),
                                      np.arange(8.0))
        np.testing.assert_array_equal(out["reduce_grad"].numpy(),
                                      np.ones(8))
        np.testing.assert_array_equal(out["copy_grad"].numpy(),
                                      np.full(8, 10.0))
        np.testing.assert_array_equal(out["ppermute"].numpy(),
                                      np.full(3, float((r - 1) % 4)))
        np.testing.assert_array_equal(out["ppermute_grad"].numpy(),
                                      np.ones(3))


def test_broadcast_from_sends_the_holders_bytes(ranks):
    """broadcast_from (the pipeline's last-stage output and stage-0
    cotangent) gives every rank the source rank's tensor bit for bit, in
    float32 and in the 2-byte dtypes gloo does not reduce."""
    for out in ranks:
        for dt in (torch.float32, torch.bfloat16, torch.float16):
            want = torch.arange(5.0).to(dt) / 3 + 2
            got = out["broadcast"][str(dt)]
            assert got.dtype == dt and torch.equal(got, want), dt
