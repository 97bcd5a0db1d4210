"""Tracing and metrics (counterpart of diffmining_tpu/utils/observability.py).

  * Timer         — the reference's wall-clock context manager.
  * trace         — a torch.profiler trace of a block, one Chrome trace file
                    a rank (the JAX package writes a jax.profiler trace).
  * annotate      — a named span in that trace.
  * MetricsLogger — append-only JSONL, one object per logging step (step,
                    wall seconds since the logger opened, values).
  * StepTimer     — EMA-smoothed wall time between steps.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Optional

import torch


class Timer:
    """Wall-clock context manager (reference doersch.py:31-44)."""

    def __init__(self, tag: str):
        self.tag = tag
        self.elapsed = 0.0

    def __enter__(self):
        self.start_time = time.time()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self.elapsed = time.time() - self.start_time
        minutes = int(self.elapsed // 60)
        print(f"{self.tag} took {minutes}m {self.elapsed % 60:.2f}s")


@contextlib.contextmanager
def trace(log_dir: str):
    """torch.profiler trace of the block (host ops, and the card's kernels
    where there is one) written to ``log_dir/trace_rank{r}.json`` (Chrome
    trace format: chrome://tracing or Perfetto), ``r`` the process group's
    rank (0 without one)."""
    import torch.distributed as dist

    rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_rank{rank}.json"))


def annotate(name: str):
    """Named span visible in profiler timelines."""
    return torch.profiler.record_function(name)


class MetricsLogger:
    def __init__(self, path: str):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self.path = path
        self._f = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, step: int, **values: Any) -> None:
        rec = {"step": int(step), "wall_s": round(time.time() - self._t0, 3)}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v) for k, v in values.items()})
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class StepTimer:
    """EMA-smoothed per-step timing for throughput reporting."""

    def __init__(self, smoothing: float = 0.9):
        self.smoothing = smoothing
        self.ema: Optional[float] = None
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self.ema = dt if self.ema is None else self.smoothing * self.ema + (1 - self.smoothing) * dt
        self._last = now
        return self.ema

    def steps_per_sec(self) -> Optional[float]:
        return (1.0 / self.ema) if self.ema else None
