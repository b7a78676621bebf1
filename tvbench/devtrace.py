"""The device trace of a traced run's steady sub-window, and what the
benchmark reads from it.

torch.profiler records device activity only (kernels, copies, fills):
host-side op recording would slow the host path that the per-layer host
metrics measure. The profiler's event times are nanoseconds since the
epoch, the clock of `time.time()`, so the host spans the benchmark and
the program record line up with them.
"""

from __future__ import annotations

import time
from collections import defaultdict


class DeviceTrace:
    """Start and stop torch.profiler around a sub-window, then reduce."""

    def __init__(self) -> None:
        self._prof = None
        self.t0 = self.t1 = None
        self.start_s = 0.0
        self.events: list[tuple[str, float, float, int]] = []

    @staticmethod
    def warm() -> None:
        """Start and stop the profiler once, in set-up: its first start
        initialises the device tracing (seconds), which inside the window
        would stall an open loop's schedule."""
        import torch
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]):
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        t = time.time()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self.t0 = time.time()
        self.start_s = self.t0 - t

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = time.time()
        self._prof.__exit__(None, None, None)
        self.events = device_events(self._prof)
        self._prof = None

    @property
    def open(self) -> bool:
        """Started and not yet stopped."""
        return self.t0 is not None and self.t1 is None

    @property
    def done(self) -> bool:
        return self.t1 is not None


def device_events(prof) -> list[tuple[str, float, float, int]]:
    """(name, start, end, card index), times in seconds since the epoch,
    of every device activity the profiler saw."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        start = e.start_ns() * 1e-9
        out.append((e.name(), start, start + e.duration_ns() * 1e-9,
                    e.device_index()))
    return out


def union(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The union of (start, end) intervals clipped to [lo, hi], as
    disjoint sorted intervals."""
    merged: list[list[float]] = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_seconds(intervals, lo: float, hi: float) -> float:
    return sum(e - s for s, e in union(intervals, lo, hi))


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The idle stretches of [lo, hi] between the union's intervals."""
    out, cur = [], lo
    for s, e in union(intervals, lo, hi):
        if s > cur:
            out.append((cur, s))
        cur = max(cur, e)
    if hi > cur:
        out.append((cur, hi))
    return out


def overlap(a, b) -> float:
    """Seconds that two lists of disjoint sorted intervals share."""
    i = j = 0
    out = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            out += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def in_spans(intervals, spans, lo: float, hi: float) -> dict:
    """For each host span name, [device busy seconds inside the name's
    spans, seconds the name's spans cover], both clipped to [lo, hi]."""
    busy = union(intervals, lo, hi)
    by_name: dict[str, list] = defaultdict(list)
    for n, s, e in spans:
        by_name[n].append((s, e))
    out = {}
    for n, ivals in by_name.items():
        cover = union(ivals, lo, hi)
        if cover:
            out[n] = [overlap(busy, cover), sum(e - s for s, e in cover)]
    return out


def label(spans, t: float) -> str:
    """The name of the shortest host span open at time t."""
    open_ = [(e - s, n) for n, s, e in spans if s <= t <= e]
    return min(open_)[1] if open_ else "no host span"


def reduce(trace: DeviceTrace, spans, top: int = 10) -> dict:
    """busy_s (the time any card was busy), busy_s_by_device (each card's
    own, by its index), window_s, kernel durations by name, device busy
    time inside each host span name's spans (`in_spans`), and the
    breakdown: the device operations that took most time and the longest
    idle gaps, each named by the host span open at its middle. An event
    without a card index is card 0's."""
    lo, hi = trace.t0, trace.t1
    inside = [(n, s, e, *dev) for n, s, e, *dev in trace.events
              if e > lo and s < hi]
    by_name: dict[str, list[float]] = defaultdict(list)
    by_device: dict[int, list[tuple[float, float]]] = defaultdict(list)
    for n, s, e, *dev in inside:
        by_name[n].append(e - s)
        by_device[dev[0] if dev else 0].append((s, e))
    ivals = [(s, e) for _, s, e, *_ in inside]
    ops = sorted(((n[:160], sum(d)) for n, d in by_name.items()),
                 key=lambda x: -x[1])[:top]
    idle = sorted(gaps(ivals, lo, hi), key=lambda g: g[0] - g[1])[:top]
    return {
        "busy_s": busy_seconds(ivals, lo, hi),
        "busy_s_by_device": {str(d): busy_seconds(v, lo, hi)
                             for d, v in sorted(by_device.items())},
        "window_s": hi - lo,
        "kernels": dict(by_name),
        "events": len(inside),
        "in_spans": in_spans(ivals, spans, lo, hi),
        "start_s": trace.start_s,
        "breakdown": {
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[label(spans, (a + b) / 2), b - a]
                          for a, b in idle],
        },
    }
