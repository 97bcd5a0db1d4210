"""The command refuses to measure without the chips a cell needs: it exits
with another code than 0 and prints no result line."""
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "sweep-512", "--seed", "3",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr


def test_unknown_cell_is_refused():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "no-such-cell", "--seed", "3",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""
