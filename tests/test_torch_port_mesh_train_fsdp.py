"""The port's trainer over dp 1 x fsdp 2 on the CPU (two gloo ranks, tiny
widths, float32): the AdamW moments, 8-bit Adam's int8 blocks and scales,
and the EMA sharded in ``mesh.FlatShards``'s flat layout, the weights whole
on both ranks. One step (AdamW + EMA, and 8-bit Adam) against the JAX
package's TrainStepBuilder over make_mesh(dp=1, fsdp=2) on ``shard_params``
state (tests/test_sharding.py:288-319 builds it so), to the tolerances of
tests/test_torch_port_mesh_train.py, whose helpers and rank script this
file uses; and bit-equal (``torch.equal``) to the port's one process on the
same global batch, since AdamW, the EMA and the block absmax are
elementwise or blockwise.
"""
import numpy as np
import pytest
import torch

from test_torch_port_mesh_train import _assert_step_close, _configs, _jax_runs, _run_ranks

NAMES = ("adamw", "8bit")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return _jax_runs(tmp_path_factory.mktemp("mesh_train_fsdp"), [((1, 2), NAMES)])


@pytest.fixture(scope="module")
def fsdp2(jax_runs, tmp_path_factory):
    """Two gloo ranks over dp 1, fsdp 2, and beside them the port's one
    process (no mesh) on the same global batch."""
    tmp = tmp_path_factory.mktemp("fsdp2")
    *ranks, alone = _run_ranks(_configs(tmp, jax_runs, 2, 1, 2, NAMES, "rank") + _configs(tmp, jax_runs, 1, 1, 1, NAMES,
                                                                                             "one"))
    return ranks, alone


@pytest.mark.parametrize("name", NAMES)
def test_fsdp2_step_matches_jax_and_one_process_bit_for_bit(fsdp2, jax_runs, name):
    """Over dp 1, fsdp 2: the loss, parameters and EMA as JAX's dp=1 fsdp=2
    step, and bit-equal to the port's one process; the ranks' moments
    together hold every element (8-bit: every block) once, each rank a part
    of them."""
    ranks, alone = fsdp2
    want, one = jax_runs["results"][(1, 2, name)], alone[name]
    for r in ranks:
        got = r[name]
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
        _assert_step_close(got["params"], want["params"])
        _assert_step_close(got["ema"], want["ema"])
        assert got["losses"] == one["losses"]
        for part in ("params", "ema"):
            assert set(got[part]) == set(one[part])
            for k, v in one[part].items():
                assert torch.equal(got[part][k], v), (part, k)
    shares = [r[name]["moment_elems"] for r in ranks]
    assert sum(shares) == one["moment_elems"] and max(shares) < one["moment_elems"]
