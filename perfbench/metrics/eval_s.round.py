"""eval_s.round: the mean over the window's rounds of the program's own
host seconds of the evaluation (``run_wall_clock``'s ``eval_s``)."""


def read(ctx):
    vals = [s["eval_s"] for s in ctx.steps if "eval_s" in s]
    return sum(vals) / len(vals) if vals else None
