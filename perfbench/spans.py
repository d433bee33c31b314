"""Spans the benchmark records around calls into the program's layers.

``CallTimers`` wraps module functions named ``"module:function"`` with
CUDA events and keeps the outermost call of each span only (a wrapped
function that calls another wrapped one of the same span counts once).
The card seconds are read after the caller has synchronized. The spans
are installed in traced runs only.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

import torch


class CallTimers:
    def __init__(self, spans: Dict[str, List[str]]):
        self.events: Dict[str, list] = {name: [] for name in spans}
        self._depth = {name: 0 for name in spans}
        self._patched = []
        for span, targets in spans.items():
            for target in targets:
                mod_name, fn_name = target.split(":")
                mod = importlib.import_module(mod_name)
                orig = getattr(mod, fn_name)
                self._patched.append((mod, fn_name, orig))
                setattr(mod, fn_name, self._wrap(orig, span))

    def _wrap(self, fn, span):
        def timed(*args, **kw):
            outer = self._depth[span] == 0
            self._depth[span] += 1
            if outer:
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                a.record()
            try:
                return fn(*args, **kw)
            finally:
                self._depth[span] -= 1
                if outer:
                    b.record()
                    self.events[span].append((a, b))
        return timed

    def seconds(self) -> Dict[str, float]:
        """Card seconds of each span's outermost calls so far."""
        return {k: sum(a.elapsed_time(b) for a, b in v) / 1e3
                for k, v in self.events.items()}

    def close(self) -> None:
        for mod, name, orig in reversed(self._patched):
            setattr(mod, name, orig)
