"""Shared arithmetic of the per-layer metric readers (portbench/metrics/).
Each returns None where the traced run holds nothing to read."""
from __future__ import annotations

from typing import Optional

from portbench import counts
from portbench.entries.common import attn_bound_and_count


def roofline(run, trace) -> Optional[float]:
    """% of their bound that the gated attention calls reach: the seconds
    their work needs at the card's peaks over the device seconds of every
    activity launched inside their spans (forward, and backward under grad)."""
    bound, n = attn_bound_and_count(run)
    device_s = trace.span_device_s("pb.attn") + trace.span_device_s("pb.attn.bwd")
    if n == 0 or device_s <= 0:
        return None
    return 100.0 * bound / device_s


def mfu(run, trace, precision: str) -> Optional[float]:
    """% of the card's peak: the model FLOPs of the traced work (from the
    cell's shapes, portbench/counts.py) over the traced window."""
    flops = sum(p for k, p in run.work if k == "flops")
    if flops <= 0 or trace.window_s <= 0:
        return None
    return 100.0 * flops / trace.window_s / counts.PEAK_FLOPS[precision]


def idle_share(trace) -> Optional[float]:
    """% of the traced window in which no device activity ran."""
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)


def per(run, num: str, den: str) -> Optional[float]:
    if not run.counters.get(den):
        return None
    return run.counters.get(num, 0) / run.counters[den]
