"""The control: the reference computed one precision below the one the
configuration states, in the program's place, fails the cell's limits.
fp8 for the bf16 cells runs here at tiny size; the float32 cell's TF32
control needs the card (the CPU has no TF32)."""
import pytest
import torch

from portbench.tests.common import control


def _fails(readings, limits):
    return any(not (readings[k] <= limits[k]) for k in limits)


@pytest.mark.parametrize("cell", ["sweep-512", "xray-1024", "train-ftt-256"])
def test_fp8_control_fails(cell):
    readings, limits = control(cell, "fp8")
    assert _fails(readings, limits), readings


@pytest.mark.cuda
def test_tf32_control_fails_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    readings, limits = control("clip-rank-448", "tf32", device="cuda")
    assert _fails(readings, limits), readings
