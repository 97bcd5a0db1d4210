"""A whole run of a cell at tiny widths and sizes on the CPU (or the card),
the harness's look for a chip skipped."""
import tempfile
import time

from portbench import harness
from portbench.tests import tiny

SIZES = {
    "sweep-512": ({"height": 64, "width": 64, "N": 4, "batch_images": 4, "distinct_images": 4}, {"draws": 2}),
    "xray-1024": ({"height": 64, "width": 64, "N": 4, "chunk": 2, "distinct_images": 2, "batch_images": 2},
                  {"draws": 2}),
    "clip-rank-448": ({"height": 128, "width": 128, "crop": 96, "images_per_call": 8, "distinct_images": 16}, {}),
    "train-ftt-256": ({"height": 32, "width": 32, "resolution": 32, "distinct_images": 8, "train_batch_size": 4},
                      {}),
}


def tiny_run(cell: str, scratch: str, fault=None, seed: int = 2 ** 33 + 17, device: str = "cpu", seconds=0.5):
    traffic, check = SIZES[cell]
    wl = tiny.workload(cell, **traffic)
    wl["check"].update(check)
    cfg = tiny.SD if wl["config"] == "sd15" else tiny.CLIP
    return harness.make_run(cell, seed, seconds, False, device, scratch, workload=wl, config=cfg, fault=fault)


def result(cell: str, fault=None, device: str = "cpu"):
    with tempfile.TemporaryDirectory() as scratch:
        return harness.run_cell(tiny_run(cell, scratch, fault, device=device), time.perf_counter())


def control(cell: str, precision: str, device: str = "cpu"):
    """The cell's numbers with the reference computed in ``precision`` in
    the program's place, and the cell's limits."""
    with tempfile.TemporaryDirectory() as scratch:
        run = tiny_run(cell, scratch, device=device)
        ent = harness.entry(run.workload["entry"])
        cell_ = ent.setup(run)
        ent.window(run, cell_)
        outputs = ent.release(run, cell_)
        return ent.check(run, outputs, "fp32", control=precision), run.workload["limits"]
