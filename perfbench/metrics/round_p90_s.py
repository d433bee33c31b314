"""round_p90_s: the nearest-rank 90th percentile of every round's time
in the window, each round timed from its start to the synchronize after
its evaluation. Needs ten rounds at the least."""
from perfbench import window


def read(ctx):
    times = [s["seconds"] for s in ctx.steps if s.get("rounds")]
    if len(times) < 10:
        return None
    return window.percentile(times, 90)
