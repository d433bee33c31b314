"""The measured window's arithmetic and the reduction of a profiler
trace, frozen with the benchmark.

- ``percentile``: nearest rank over every step of the window;
- ``busy_union``: the seconds in which some operation ran on the
  device, the union of the device events' intervals (events on several
  streams may overlap, so their sum can exceed it);
- ``device_ops`` and ``idle_gaps``: the breakdown a traced run prints.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence, Tuple

Interval = Tuple[float, float]


def percentile(values: Sequence[float], p: float) -> float:
    """The nearest-rank ``p``-th percentile of every value: the smallest
    value with at least ``p`` percent of the values at or below it."""
    if not values:
        raise ValueError("percentile of no values")
    s = sorted(values)
    rank = max(1, math.ceil(p / 100.0 * len(s)))
    return s[rank - 1]


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """Disjoint, sorted intervals covering the same points."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_union(intervals: Iterable[Interval]) -> float:
    return sum(e - s for s, e in merge(intervals))


def device_ops(kernels: Sequence[Tuple[str, float, float]],
               top: int = 10) -> List[List]:
    """The device operations that took most time: [name, seconds]."""
    by: Dict[str, float] = {}
    for name, s, e in kernels:
        by[name] = by.get(name, 0.0) + (e - s)
    return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])
            [:top]]


def idle_gaps(kernels: Sequence[Tuple[str, float, float]],
              host: Sequence[Tuple[str, float, float]],
              span: Interval, top: int = 10) -> List[List]:
    """The device's idle time inside ``span``, by what the host was
    doing: each gap between busy intervals goes to the innermost host
    operation that covers its middle ("host: none" where none does);
    [name, seconds], the largest sums first."""
    busy = merge((s, e) for _, s, e in kernels)
    gaps: List[Interval] = []
    t = span[0]
    for s, e in busy:
        if s > t:
            gaps.append((t, min(s, span[1])))
        t = max(t, e)
    if t < span[1]:
        gaps.append((t, span[1]))
    import numpy as np
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])
    names = [h[0] for h in host]
    hs = np.array([h[1] for h in host], dtype=np.float64)
    he = np.array([h[2] for h in host], dtype=np.float64)
    width = he - hs
    by: Dict[str, float] = {}
    # the longest gaps one by one; the many short ones in one entry
    for i, (gs, ge) in enumerate(gaps):
        if i >= _NAMED_GAPS:
            key = "other gaps, each shorter than the named ones"
        else:
            mid = 0.5 * (gs + ge)
            cover = np.nonzero((hs <= mid) & (he >= mid))[0]
            key = ("host: none" if cover.size == 0
                   else "host: " + names[cover[np.argmin(width[cover])]])
        by[key] = by.get(key, 0.0) + (ge - gs)
    return [[n, t] for n, t in sorted(by.items(), key=lambda kv: -kv[1])
            [:top]]


#: gaps attributed to a host operation one by one, longest first
_NAMED_GAPS = 400

