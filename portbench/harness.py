"""One run of one cell: set-up, the measured (or traced) window, the
comparison with the reference, and the result line.

Everything a cell is made of is found by name: ``BENCHMARK.json`` at the
checkout's root lists the cell's metrics, ``portbench/workloads/<cell>.json``
names its configuration, the entry it drives (``portbench/entries/
<entry>.py``), its traffic, what its check samples and the limit of each
number compared, ``portbench/configs/<config>.json`` holds the model's sizes,
and ``portbench/metrics/<metric>.py`` reads one per-layer metric from a
traced run.

An entry module provides:

- ``setup(run) -> cell``: models, weights, inputs, warm-up of the cell's
  shapes (all of it counts as set-up);
- ``window(run, cell) -> Window``: the measured work, for ``run.seconds``;
- ``traced(run, cell) -> (() -> Window)``: a fixed amount of the same
  work, with the spans and counters of the metric readers around the calls
  into the program, ready to run under the profiler (what it counts from
  shapes is counted before);
- ``release(run, cell) -> outputs``: what the check needs; the program's
  state freed;
- ``check(run, outputs, precision) -> {name: number}``: the reference's
  comparison, each number to be at most its limit;
- ``metrics(run, window) -> {end-to-end metric: value}``.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import torch

from portbench.tracing import Counters

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent
BANNED = ("jax", "jaxlib", "flax", "diffmining_tpu")
GIB = float(1 << 30)


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict[str, Any]:
    return load_json(ROOT / "BENCHMARK.json")


@dataclasses.dataclass
class Run:
    cell: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    scratch: str
    fault: Optional[str] = None  # a planted fault, for the benchmark's own tests
    counters: Counters = dataclasses.field(default_factory=Counters)
    work: List[tuple] = dataclasses.field(default_factory=list)  # (kind, params) of the traced work

    @property
    def traffic(self) -> Dict[str, Any]:
        return self.workload["traffic"]


@dataclasses.dataclass
class Window:
    units: int  # images or steps completed
    seconds: float  # host clock from the first call to the last result


def entry(name: str):
    return importlib.import_module(f"portbench.entries.{name}")


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: Dict[str, Any], cell: str, kind: str) -> List[Dict[str, Any]]:
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def make_run(cell: str, seed: int, seconds: float, trace: bool, device, scratch: str,
             workload: Optional[Dict] = None, config: Optional[Dict] = None, fault: Optional[str] = None) -> Run:
    workload = workload or load_json(HERE / "workloads" / f"{cell}.json")
    config = config or load_json(HERE / "configs" / f"{workload['config']}.json")
    return Run(cell, workload, config, int(seed), float(seconds), bool(trace), torch.device(device), scratch,
               fault=fault)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def compare(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict[str, float]]:
    return {k: {"value": readings.get(k, float("nan")), "limit": limits[k]} for k in limits}


def is_correct(checks: Dict[str, Dict[str, float]]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())


def build_kernels(device: torch.device) -> float:
    """Build every CUDA kernel the program has into the checkout's
    ``build/kernels/`` (the program's own cache, keyed by source hash); a
    later run finds them built. Returns the seconds it took."""
    if device.type != "cuda":
        return 0.0
    from diffmining_tpu_torch.ops import flash_attention

    t = time.perf_counter()
    flash_attention.build()
    return time.perf_counter() - t


def run_cell(run: Run, t_start: float, bench: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Set-up, window, check; the result line as a dict. ``t_start`` is the
    host clock when the process began its set-up."""
    bench = bench or benchmark()
    ent = entry(run.workload["entry"])
    t_import = time.perf_counter() - t_start
    build_s = build_kernels(run.device)
    t_entry = time.perf_counter()
    cell = ent.setup(run)
    if run.device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    setup_s = time.perf_counter() - t_start
    print(f"portbench: {run.cell} seed {run.seed}: set-up {setup_s:.3f} s (imports {t_import:.3f} s, kernel build "
          f"{build_s:.3f} s, the entry's set-up {time.perf_counter() - t_entry:.3f} s)", file=sys.stderr, flush=True)

    breakdown = None
    if run.trace:
        from portbench import tracing

        win, trace = tracing.profile(ent.traced(run, cell), run.scratch)
        metrics = {}
        for m in cell_metrics(bench, run.cell, "per_layer"):
            value = metric_reader(m["name"]).read(run, trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        busy, window_s = trace.busy_s(), trace.window_s
        breakdown = trace.breakdown()
        print(f"portbench: card {power_limit()}", file=sys.stderr, flush=True)
    else:
        win = ent.window(run, cell)
        values = dict(ent.metrics(run, win), setup_s=setup_s)
        metrics = {}
        for m in cell_metrics(bench, run.cell, "end_to_end"):
            if m["name"] == "peak_mem_gib":
                values["peak_mem_gib"] = peak_bytes(run.device) / GIB
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    peak = peak_bytes(run.device)

    outputs = ent.release(run, cell)
    del cell
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    readings = ent.check(run, outputs, "fp32")
    checks = compare(readings, run.workload["limits"])
    for name in sorted(set(readings) - set(checks)):
        print(f"reading {name} {readings[name]!r} (not compared)", file=sys.stderr)
    correct = is_correct(checks)
    device = {"platform": "gpu" if run.device.type == "cuda" else run.device.type,
              "kind": torch.cuda.get_device_name(0) if run.device.type == "cuda" else "cpu",
              "count": int(run.workload.get("chips", 1)), "memory_peak_bytes": int(peak)}
    if run.trace:
        device["busy_s"], device["window_s"] = busy, window_s
    out = {"correct": correct, "attempted": win.units,
           "failed": sum(1 for c in checks.values() if not (c["value"] <= c["limit"])),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def peak_bytes(device: torch.device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def banned_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in BANNED)


def scratch_dir() -> str:
    """A directory for the run's outputs (artifacts, the trace), under the
    run's TMPDIR; removed when the run ends."""
    return tempfile.mkdtemp(prefix="portbench-")


def remove(path: str) -> None:
    shutil.rmtree(path, ignore_errors=True)


def main(argv=None, t_start: Optional[float] = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    p = argparse.ArgumentParser(description="Run one benchmark cell once and print its result line.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench = benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    scratch = scratch_dir()
    try:
        run = make_run(args.workload, args.seed, args.seconds, bool(args.trace), "cuda", scratch)
        out = run_cell(run, t_start, bench)
    finally:
        remove(scratch)
    bad = banned_modules()
    if bad:
        print(f"portbench: modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
