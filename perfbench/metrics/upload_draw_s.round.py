"""upload_draw_s.round: card seconds a traced round in the upload's
draws: CUDA events around ``repro_torch.random.uniform`` and
``normal``, the outermost call only (the mix's span
``upload_draw``)."""


def read(ctx):
    t = ctx.trace
    if t is None or "upload_draw" not in t["spans"]:
        return None
    rounds = sum(s.get("rounds", 0) for s in t["steps"])
    s = t["spans"]["upload_draw"]
    return s / rounds if rounds and s > 0 else None
