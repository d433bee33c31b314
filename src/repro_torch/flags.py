"""Process-wide analysis-mode switch (port of ``repro.flags``).

The reference's switch unrolls its layer and attention scans so that
XLA's cost analysis counts every iteration. Nothing in the port
unrolls: its layer loops are Python and run every layer. So the switch
has one job here: under :func:`analysis`, a ``meta`` tensor that
reaches the flash-attention or SSD kernel's dispatch
(``models.layers.attention_core``, ``models.ssm.ssd_chunked``) takes the
kernel's shape-only twin (``kernels.flash_attention.attend_shape``,
``kernels.ssd_scan.intra_states_shape``) instead of raising, which lets
the dry-run (``launch.dryrun``) run a rank's program on ``meta``
tensors. A CUDA tensor still launches the kernel, a CPU tensor still
takes the plain version, and a ``meta`` tensor outside :func:`analysis`
still raises.
"""
from __future__ import annotations

import contextlib
import threading

_state = threading.local()


def analysis_mode() -> bool:
    return getattr(_state, "analysis", False)


@contextlib.contextmanager
def analysis(enabled: bool = True):
    prev = analysis_mode()
    _state.analysis = enabled
    try:
        yield
    finally:
        _state.analysis = prev
