"""device_idle.round: the share of the traced rounds' wall time in which
no operation ran on the device (1 - the union of the device events'
intervals over the traced window), in %."""
from perfbench.metrics import _shared


def read(ctx):
    return _shared.idle_percent(ctx)
