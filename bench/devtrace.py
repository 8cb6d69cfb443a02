"""Host spans and the device trace of a run's window.

``Spans`` records the harness's own host spans (name, start, end) around
its calls into the program.  ``DeviceTrace`` wraps ``torch.profiler`` over
the window (device activity only: kernels, copies, fills) and reduces its
events to the device's busy time (the union of its activity), each
kernel's summed time, the longest device operations and the longest idle
gaps, each gap named by the host span it fell in.  The profiler stamps its
events on the wall clock (``time.time_ns``); the spans are taken on
``perf_counter`` and moved onto that clock by one offset read at the start.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Optional


class Spans:
    def __init__(self):
        self.items: list = []          # (name, t0, t1) on perf_counter
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self._sorted: list = []
        self._starts: list = []

    def add(self, name: str, t0: float, t1: float) -> None:
        self.items.append((name, t0, t1))

    def total(self, name: str) -> float:
        """Seconds of the spans called ``name``."""
        return sum(b - a for n, a, b in self.items if n == name)

    def at(self, wall_ns: int) -> str:
        """The span that holds the wall-clock instant (spans do not
        overlap), or ``host``."""
        if len(self._sorted) != len(self.items):
            self._sorted = sorted((a, b, n) for n, a, b in self.items)
            self._starts = [a for a, _, _ in self._sorted]
        t = (wall_ns - self.offset_ns) / 1e9
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and self._sorted[i][1] >= t:
            return self._sorted[i][2]
        return "host"


KINDS = (("attention", ("flash_attention",)),
         ("gemm", ("gemm", "nvjet", "cutlass", "gemv", "sm90_xmma")),
         ("decode_kernel", ("decode_gop_blocks", "dct_quant", "idct")),
         ("copy", ("copy", "Memcpy", "CatArray", "cat_")),
         ("index", ("gather", "scatter", "index", "take_along")),
         ("reduce", ("reduce", "softmax", "norm", "cumsum", "sort")),
         ("elementwise", ("elementwise", "Memset", "fill")))


def by_kind(kernel_s: dict) -> dict:
    """Device seconds by kind of operation (the first kind whose marks
    are in the name; ``other`` for the rest)."""
    out = {k: 0.0 for k, _ in KINDS}
    out["other"] = 0.0
    for name, s in kernel_s.items():
        kind = next((k for k, marks in KINDS
                     if any(m in name for m in marks)), "other")
        out[kind] += s
    return out


def _merge(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class DeviceTrace:
    """The profiler over ``[start(), stop()]``; ``reduce`` after."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self._prof = None
        self.t0_ns = self.t1_ns = 0

    def start(self) -> None:
        if not self.enabled:
            return
        from torch.profiler import ProfilerActivity, profile

        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.t0_ns = time.time_ns()

    def stop(self) -> None:
        if self._prof is None:
            return
        import torch

        torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self._prof.__exit__(None, None, None)

    def reduce(self, spans: Optional[Spans] = None) -> Optional[dict]:
        """{"busy_s", "window_s", "kernel_s": {name: s}, "device_ops":
        [[name, s]] (10 longest by summed time), "idle_gaps": [[host span,
        s]] (10 longest)}, or None when no device activity was recorded."""
        if self._prof is None:
            return None
        t0, t1 = self.t0_ns, self.t1_ns
        intervals, by_name = [], defaultdict(float)
        for e in self._prof.profiler.kineto_results.events():
            if "CUDA" not in str(e.device_type()):
                continue
            a, b = max(e.start_ns(), t0), min(e.end_ns(), t1)
            if b <= a:
                continue
            intervals.append((a, b))
            by_name[e.name()] += (b - a) / 1e9
        if not intervals:
            return None
        busy = _merge(intervals)
        busy_s = sum(b - a for a, b in busy) / 1e9
        gaps, prev = [], t0
        for a, b in busy + [[t1, t1]]:
            if a > prev:
                gaps.append((a - prev, prev, a))
            prev = max(prev, b)
        named = defaultdict(float)
        for width, a, b in gaps:
            where = spans.at((a + b) // 2) if spans is not None else "host"
            named[where] += width / 1e9
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        idle = sorted(named.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy_s, "window_s": (t1 - t0) / 1e9,
                "kernel_s": dict(by_name),
                "device_ops": [[n[:160], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in idle]}
