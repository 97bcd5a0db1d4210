"""The port's trainer over dp 2 on the CPU (two gloo ranks, tiny widths,
float32) against the JAX package's TrainStepBuilder over make_mesh(dp=2,
fsdp=1): accumulation over 2 micro-steps into the bf16 accumulator (the
gradients all-reduced at every micro-step before the add, as in JAX), and a
LoRA r2 step from JAX's factors with b drawn nonzero (only the factors'
gradients reduced). The helpers, the rank script and the tolerances are
tests/test_torch_port_mesh_train.py's; this file holds the variants whose
JAX steps would take that file past its time.
"""
import pytest

from test_torch_port_mesh_train import _check_dp2_step, _configs, _jax_runs, _run_ranks

NAMES = ("accum_bf16", "lora")


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return _jax_runs(tmp_path_factory.mktemp("mesh_train_accum_lora"), [((2, 1), NAMES)])


@pytest.fixture(scope="module")
def dp2(jax_runs, tmp_path_factory):
    return _run_ranks(_configs(tmp_path_factory.mktemp("dp2"), jax_runs, 2, 2, 1, NAMES, "rank"))


@pytest.mark.parametrize("name", NAMES)
def test_dp2_step_matches_jax(dp2, jax_runs, name):
    """Losses, parameters and EMA after two micro-steps of accumulation, or
    one LoRA step, as JAX's over dp 2; the ranks hold the same of both."""
    _check_dp2_step([r[name] for r in dp2], jax_runs["results"][(2, 1, name)])
