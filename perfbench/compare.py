"""The numbers that decide ``correct``, frozen with the benchmark.

A training cell compares the program's first steps with the plain
reference's:

- ``loss_gap``: each step's loss, the largest relative gap;
- ``norm_gap``: a state's norm by leaf, the worst leaf's gap between the
  program's norm and the reference's (not the norm of their
  difference), measured against the reference's norm of that leaf or of
  the median leaf, whichever is larger. Leaves whose reference gradient
  is nought to rounding (under a thousandth of the median leaf's) are
  left out: they move by round-off alone.

A non-finite reading compares as infinitely far.
"""
from __future__ import annotations

import math
import statistics
from typing import List, Optional, Sequence, Tuple


def loss_gap(prog: Sequence[float], ref: Sequence[float]) -> float:
    if len(prog) != len(ref):
        return math.inf
    worst = 0.0
    for p, r in zip(prog, ref):
        if not (math.isfinite(p) and math.isfinite(r)):
            return math.inf
        worst = max(worst, abs(p - r) / abs(r))
    return worst


def counted(grad_ref: Sequence[float]) -> List[int]:
    """The leaves whose reference gradient norm is at least a thousandth
    of the median leaf's."""
    med = statistics.median(grad_ref)
    return [i for i, g in enumerate(grad_ref) if g >= 1e-3 * med]


def leaf_gaps(prog: Sequence[float], ref: Sequence[float],
              leaves: Optional[Sequence[int]] = None) -> List[float]:
    """Each leaf's gap of norms over ``leaves`` (default: all), against
    the reference's norm of the leaf or of the median leaf, whichever is
    larger; a non-finite reading gives an infinite gap."""
    idx = list(range(len(ref))) if leaves is None else list(leaves)
    if len(prog) != len(ref) or not idx:
        return [math.inf]
    med = statistics.median(ref[i] for i in idx)
    out = []
    for i in idx:
        p, r = prog[i], ref[i]
        finite = math.isfinite(p) and math.isfinite(r)
        out.append(abs(p - r) / max(r, med) if finite else math.inf)
    return out


def norm_gap(prog: Sequence[float], ref: Sequence[float],
             leaves: Optional[Sequence[int]] = None) -> float:
    """The worst leaf's gap of norms."""
    return max(leaf_gaps(prog, ref, leaves))


def verdict(rows: Sequence[Tuple[str, float, float]]) -> bool:
    """Correct when every number is finite and within its limit."""
    return bool(rows) and all(math.isfinite(v) and v <= lim
                              for _, v, lim in rows)
