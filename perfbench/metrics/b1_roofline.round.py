"""b1_roofline.round: B1's (``gossip_mix``) share of its bound over the
traced rounds, in %: the least time its bytes take at the card's HBM
rate, over its profiled device time.

Frozen counts: a launch of the (k, n) operator on (n, T) f32 rows reads
the n input rows and writes the k output rows once (the operator itself,
n·k·4 bytes, is left out); at n = k = 64 and T = 6,603,710 that is
3.381 GB, 1.009 ms at 3.35 TB/s, and the (8, 64) projection 0.568 ms.
A round of the resident bank launches q boundaries of (n, n) (the last
one W_inter·V fused), one more with an upload (its last block mixes the
uploaded deltas by V, then W_inter), and the edge projection (m, n).
The reader holds the program's launch counter to that plan and reads
nothing where they differ.
"""
from perfbench.metrics import _shared


def launch_bytes(n_in: int, k_out: int, cols: int, itemsize: int = 4
                 ) -> float:
    return float((n_in + k_out) * cols * itemsize)


def round_launches(cfg, upload: bool):
    """[(n_in, k_out)] of one round's launches."""
    n = cfg["num_clusters"] * cfg["devices_per_cluster"]
    m = cfg["num_clusters"]
    return [(n, n)] * (cfg["q"] + (1 if upload else 0)) + [(n, m)]


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    rounds = sum(s.get("rounds", 0) for s in t["steps"])
    plan = round_launches(ctx.cfg, bool(ctx.mix.get("compression")))
    if not rounds or t["counters"].get("b1_launches") != rounds * len(plan):
        return None
    secs = _shared.kernel_seconds(ctx, "gossip_mix_kernel")
    if secs <= 0:
        return None
    bound = rounds * sum(launch_bytes(n, k, ctx.cfg["params"])
                         for n, k in plan) / _shared.hbm_bytes_per_s()
    return 100.0 * bound / secs
