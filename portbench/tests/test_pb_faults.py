"""A whole run at tiny size with the timed path broken underneath comes out
not correct, once for each fault a cell can have; unbroken, it comes out
correct. (One chip: no exchange between chips to leave out.)"""
import pytest

from portbench.tests.common import result

FAULTS = [
    ("sweep-512", "altered"), ("sweep-512", "half_batch"),
    ("xray-1024", "altered"), ("xray-1024", "half_batch"),
    ("clip-rank-448", "altered"), ("clip-rank-448", "half_batch"),
    ("train-ftt-256", "unchanged"), ("train-ftt-256", "half_batch"),
]


@pytest.mark.parametrize("cell", ["sweep-512", "xray-1024", "clip-rank-448", "train-ftt-256"])
def test_sound_run_is_correct(cell):
    out = result(cell)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert set(out) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert "setup_s" in out["metrics"] and out["attempted"] > 0


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_fault_is_caught(cell, fault):
    out = result(cell, fault)
    assert not out["correct"], out["checks"]
