"""round_s: the window's seconds over the whole rounds it completed
(the window ends at a round's end, in a synchronize)."""
from perfbench.metrics import _shared


def read(ctx):
    rate = _shared.window_rate(ctx, "rounds")
    return None if rate is None else 1.0 / rate
