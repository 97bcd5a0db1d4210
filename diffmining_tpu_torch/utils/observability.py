"""Training metrics (counterpart of diffmining_tpu/utils/observability.py
``MetricsLogger`` and ``StepTimer``).

  * MetricsLogger — append-only JSONL, one object per logging step (step,
                    wall seconds since the logger opened, values).
  * StepTimer     — EMA-smoothed wall time between steps.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Optional


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
