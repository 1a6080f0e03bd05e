"""What a ``torch.profiler`` trace says of the device: the intervals in
which an operation ran on it, the time they cover, the idle gaps between
them and what the host was doing in each gap.

Times are seconds on the profiler's clock, on which the host's and the
device's events lie together.
"""

from __future__ import annotations

import collections
import heapq
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

Interval = Tuple[str, float, float]  # (name, start_s, end_s)
WINDOW = "perfbench.window"          # the annotation around a traced window
JOB = "perfbench.job"                # the annotation around one job
TOP = 10                             # entries in each list of the breakdown


def _is_device(event) -> bool:
    return "cuda" in str(event.device_type()).lower()


def _is_annotation(event) -> bool:
    """A ``record_function`` range, which the trace also draws on the
    device's timeline: it marks time, it is no operation."""
    flag = getattr(event, "is_user_annotation", None)
    return bool(flag and flag()) or event.name().startswith("perfbench.")


def _span(event) -> Tuple[float, float]:
    if hasattr(event, "start_ns"):
        start, dur = event.start_ns() * 1e-9, event.duration_ns() * 1e-9
    else:  # older profilers count microseconds
        start, dur = event.start_us() * 1e-6, event.duration_us() * 1e-6
    return start, start + dur


def events(prof) -> Tuple[List[Interval], List[Interval]]:
    """(device, host) intervals of a finished ``torch.profiler.profile``."""
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start, end = _span(e)
        if not _is_device(e):
            host.append((e.name(), start, end))
        elif not _is_annotation(e):
            device.append((e.name(), start, end))
    return device, host


def window(host: Sequence[Interval]) -> Optional[Tuple[float, float]]:
    """The traced window's bounds, from its annotation."""
    spans = [(s, e) for name, s, e in host if name == WINDOW]
    if not spans:
        return None
    return min(s for s, _ in spans), max(e for _, e in spans)


def merged(intervals: Iterable[Interval], lo: float,
           hi: float) -> List[Tuple[float, float]]:
    """The union of intervals clipped to [lo, hi], as sorted disjoint
    (start, end) pairs."""
    spans = sorted((max(s, lo), min(e, hi)) for _, s, e in intervals
                   if e > lo and s < hi)
    out: List[List[float]] = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_seconds(intervals: Iterable[Interval], lo: float, hi: float) -> float:
    """Seconds of [lo, hi] in which at least one interval ran."""
    return sum(e - s for s, e in merged(intervals, lo, hi))


def gaps(intervals: Iterable[Interval], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The idle stretches of [lo, hi] between the intervals."""
    out, at = [], lo
    for s, e in merged(intervals, lo, hi):
        if s > at:
            out.append((at, s))
        at = e
    if hi > at:
        out.append((at, hi))
    return out


def host_at(host: Sequence[Interval],
            points: Sequence[float]) -> List[str]:
    """For each point, the innermost host event covering it (the one that
    started last), or "host, outside any event"."""
    order = sorted(range(len(host)), key=lambda i: host[i][1])
    found = {}
    live: List[Tuple[float, int]] = []  # (-start, index), latest start first
    i = 0
    for p in sorted(points):
        while i < len(order) and host[order[i]][1] <= p:
            j = order[i]
            heapq.heappush(live, (-host[j][1], j))
            i += 1
        while live and host[live[0][1]][2] < p:
            heapq.heappop(live)  # ended: later points lie later still
        found[p] = host[live[0][1]][0] if live else "host, outside any event"
    return [found[p] for p in points]


def top(totals: Dict[str, float]) -> List[List]:
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name[:200], seconds] for name, seconds in ranked]


def breakdown(device: Sequence[Interval], host: Sequence[Interval], lo: float,
              hi: float) -> dict:
    """The device operations that took most time, and the idle time by what
    the host was doing, both over [lo, hi]."""
    ops: Dict[str, float] = collections.defaultdict(float)
    for name, s, e in device:
        if e > lo and s < hi:
            ops[name] += min(e, hi) - max(s, lo)
    idle = gaps(device, lo, hi)
    names = host_at(host, [(s + e) / 2 for s, e in idle])
    waits: Dict[str, float] = collections.defaultdict(float)
    for (s, e), name in zip(idle, names):
        waits[name] += e - s
    return {"device_ops": top(ops), "idle_gaps": top(waits)}
