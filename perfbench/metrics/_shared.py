"""Helpers of the metric readers: the table of peaks and the reductions
of the traced window that several readers share."""
from __future__ import annotations

import json
from pathlib import Path
from typing import Optional

_PEAKS = json.loads((Path(__file__).resolve().parent.parent
                     / "peaks.json").read_text())


def peak_flops(precision: str) -> float:
    return float(_PEAKS["flops_per_s"][precision])


def hbm_bytes_per_s() -> float:
    return float(_PEAKS["hbm_bytes_per_s"])


def kernel_seconds(ctx, *fragments: str) -> float:
    """Device seconds of the traced kernels whose name holds one of
    ``fragments``."""
    return sum(e - s for name, s, e in ctx.trace["kernels"]
               if any(f in name for f in fragments))


def work(steps, key: str) -> float:
    return float(sum(s.get(key, 0) for s in steps))


def window_rate(ctx, key: str) -> Optional[float]:
    """The window's ``key`` (such as rounds) a second, over all the work
    and all the time of the window."""
    w = work(ctx.steps, key)
    return w / ctx.window_s if w and ctx.window_s > 0 else None


def idle_percent(ctx) -> Optional[float]:
    t = ctx.trace
    if t is None or not t["kernels"] or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
