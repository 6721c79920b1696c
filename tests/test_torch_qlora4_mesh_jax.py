"""The int4 QLoRA base (packed int4, group 16, row-parallel splits keeping
their groups whole) under tensor 2 x fsdp 2 against JAX's sharded QLoRA
step: as tests/test_torch_qlora_mesh_jax.py does for int8, loss terms and
grad_norm within rtol 1e-4."""

import pytest

from test_torch_qlora_mesh_jax import assert_equals_jax, mesh_results
from test_torch_sharded_train import weights


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return mesh_results(tmp_path_factory.mktemp("qlora4_jax"),
                        {"int4": (dict(bits=4), weights())})


def test_sharded_qlora4_step_equals_jax_sharded_qlora_step(results):
    assert_equals_jax(results, "int4")
