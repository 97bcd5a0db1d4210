"""The traced run: spans and counters the benchmark puts around its calls
into the program, and the device trace that ``torch.profiler`` takes.

``Spans`` opens a ``record_function`` span around a call (names start
"pb."); a span may also be opened and closed across two autograd hooks of
one backward node (``around_backward``). ``profile(fn)`` runs ``fn`` under
the profiler (CPU and CUDA activities), writes the Chrome trace under the
run's scratch directory, reads it back and deletes it. ``Trace`` holds what
the metric readers need:

- every device activity (kernels, copies, sets) with its launch's
  correlation id;
- the host runtime call of each launch (its thread and time);
- the spans by name;
- the traced window, from the first span "pb.window" opens to its end.

A kernel belongs to a span when the runtime call that launched it lies
inside the span on the same thread. Device busy time is the union of the
device activities inside the window.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def span(name: str):
    return torch.profiler.record_function(name)


def around_backward(node, name: str) -> None:
    """A span named ``name`` over the execution of the autograd node
    ``node`` (a pre-hook opens it, a post-hook closes it)."""
    state = {}

    def pre(grad_outputs):
        state["rf"] = torch.profiler.record_function(name)
        state["rf"].__enter__()

    def post(grad_inputs, grad_outputs):
        rf = state.pop("rf", None)
        if rf is not None:
            rf.__exit__(None, None, None)

    node.register_prehook(pre)
    node.register_hook(post)


class Trace:
    def __init__(self, events: List[dict]):
        self.device: List[Tuple[float, float, str, int]] = []  # ts, end, name, correlation
        self.launch: Dict[int, Tuple[int, float]] = {}  # correlation -> (tid, ts)
        spans: Dict[str, List[Tuple[int, float, float]]] = defaultdict(list)
        self.host_ops: List[Tuple[int, float, float, str]] = []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat", "")
            ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
            args = e.get("args") or {}
            if cat in DEVICE_CATS:
                self.device.append((ts, ts + dur, e.get("name", ""), int(args.get("correlation", -1))))
            elif cat in RUNTIME_CATS:
                self.launch[int(args.get("correlation", -1))] = (e.get("tid"), ts)
            elif cat == "user_annotation":
                spans[e.get("name", "")].append((e.get("tid"), ts, ts + dur))
            elif cat == "cpu_op":
                self.host_ops.append((e.get("tid"), ts, ts + dur, e.get("name", "")))
        self.spans = {k: sorted(v, key=lambda s: (s[0], s[1])) for k, v in spans.items()}
        win = self.spans.get("pb.window")
        if not win:
            raise RuntimeError("the trace holds no pb.window span")
        self.window = (win[0][1], win[0][2])
        self.window_s = (self.window[1] - self.window[0]) * 1e-6
        self.device.sort()

    def _in_window(self) -> List[Tuple[float, float, str, int]]:
        lo, hi = self.window
        return [(max(a, lo), min(b, hi), n, c) for a, b, n, c in self.device if b > lo and a < hi]

    def busy_s(self) -> float:
        """Seconds of the window in which some device activity ran."""
        total, end = 0.0, None
        for a, b, _, _ in self._in_window():
            if end is None or a > end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total * 1e-6

    def span_device_s(self, name: str) -> float:
        """Device seconds of the activities launched inside spans ``name``."""
        return sum(b - a for a, b, _, _ in self.launched_in(name)) * 1e-6

    def launched_in(self, name: str) -> List[Tuple[float, float, str, int]]:
        intervals = self.spans.get(name, [])
        by_tid: Dict[object, Tuple[List[float], List[float]]] = {}
        for tid, a, b in intervals:
            starts, ends = by_tid.setdefault(tid, ([], []))
            starts.append(a)
            ends.append(b)
        out = []
        for act in self.device:
            launch = self.launch.get(act[3])
            if launch is None or launch[0] not in by_tid:
                continue
            starts, ends = by_tid[launch[0]]
            i = bisect.bisect_right(starts, launch[1]) - 1
            if i >= 0 and launch[1] <= ends[i]:
                out.append(act)
        return out

    def count(self, name: str) -> int:
        return len(self.spans.get(name, []))

    def breakdown(self, top: int = 10) -> Dict[str, List[List]]:
        """The device operations that took most time in the window, and the
        idle gaps summed by the innermost host op or span that was running
        at each gap's middle."""
        by_name: Dict[str, float] = defaultdict(float)
        acts = self._in_window()
        for a, b, n, _ in acts:
            by_name[n] += (b - a) * 1e-6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        host = sorted(self.host_ops + [(t, a, b, n) for n, v in self.spans.items() for t, a, b in v],
                      key=lambda h: h[1])
        starts = [h[1] for h in host]
        gaps: Dict[str, float] = defaultdict(float)
        end = self.window[0]
        for a, b, _, _ in acts + [(self.window[1], self.window[1], "", -1)]:
            if a > end:
                gaps[self._host_at(host, starts, (a + end) / 2)] += (a - end) * 1e-6
            end = max(end, b)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in idle]}

    @staticmethod
    def _host_at(host, starts, t: float, look_back: int = 4000) -> str:
        """The innermost (latest-starting) host op or span running at ``t``."""
        i = bisect.bisect_right(starts, t) - 1
        for h in host[max(0, i - look_back):i + 1][::-1]:
            if h[2] >= t:
                return h[3]
        return "no host op"


def profile(fn: Callable[[], object], scratch: str) -> Tuple[object, Trace]:
    """Run ``fn`` under the profiler inside a "pb.window" span; return its
    result and the parsed trace."""
    from torch.profiler import ProfilerActivity

    path = os.path.join(scratch, "trace.json")
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with span("pb.window"):
            out = fn()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return out, Trace(events)


class Counters(dict):
    """Named counts the benchmark keeps at its boundaries with the program."""

    def add(self, name: str, n: float = 1) -> None:
        self[name] = self.get(name, 0) + n


def launches() -> int:
    """The flash wrappers' ``.launches`` counters (ops/flash_attention.py,
    ops/fused_norm.py), summed."""
    from diffmining_tpu_torch.ops import flash_attention, fused_norm

    total = 0
    for mod in (flash_attention, fused_norm):
        for v in vars(mod).values():
            if callable(v) and isinstance(getattr(v, "launches", None), int):
                total += v.launches
    return total


@contextlib.contextmanager
def patched(obj, attr: str, wrapper_factory):
    """``obj.attr`` replaced by ``wrapper_factory(original)`` inside the block."""
    orig = getattr(obj, attr)
    setattr(obj, attr, wrapper_factory(orig))
    try:
        yield orig
    finally:
        setattr(obj, attr, orig)
