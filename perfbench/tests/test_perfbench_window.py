"""The window's arithmetic, the reduction of a trace and the frozen counts
of the metric readers."""
import json

import pytest

from perfbench_tiny import ROOT
from perfbench import registry, window
from perfbench import run as harness

FEMNIST = registry.config("femnist_cnn")


def _ctx(**kw):
    base = dict(cfg=FEMNIST, mix={}, steps=[], window_s=0.0, trace=None,
                setup_s=1.0, peak_bytes=0)
    base.update(kw)
    return harness.Context(**base)


def test_percentile_is_the_nearest_rank():
    vals = [float(v) for v in range(1, 101)]
    assert window.percentile(vals, 90) == 90.0
    assert window.percentile(vals[:10], 90) == 9.0
    assert window.percentile([5.0, 1.0, 3.0], 50) == 3.0


def test_round_metrics_are_over_whole_rounds_and_every_round():
    secs = [0.2] * 95 + [0.5] * 5
    steps = [{"rounds": 1, "seconds": s, "eval_s": 0.01} for s in secs]
    ctx = _ctx(steps=steps, window_s=sum(secs))
    assert registry.metric("round_s").read(ctx) == pytest.approx(
        sum(secs) / 100)
    assert registry.metric("round_p90_s").read(ctx) == 0.2
    assert registry.metric("round_p90_s").read(_ctx(steps=steps[:9])) is None
    assert registry.metric("eval_s.round").read(ctx) == pytest.approx(0.01)


def test_busy_union_counts_overlaps_once():
    assert window.busy_union([(0, 2), (1, 3), (5, 6)]) == 4
    assert window.merge([(3, 4), (0, 1), (0.5, 2)]) == [(0, 2), (3, 4)]


def test_breakdown_names_the_host_op_over_each_gap():
    kernels = [("k1", 0.0, 1.0), ("k2", 3.0, 4.0), ("k1", 4.0, 4.5)]
    host = [("outer", 0.0, 10.0), ("aten::item", 1.0, 3.0)]
    gaps = dict(map(tuple, window.idle_gaps(kernels, host, (0.0, 5.0))))
    assert gaps == {"host: aten::item": 2.0, "host: outer": 0.5}
    ops = window.device_ops(kernels)
    assert ops[0] == ["k1", 1.5] and ops[1] == ["k2", 1.0]


def test_idle_share_of_the_traced_window():
    trace = {"kernels": [("k", 0.0, 0.9)], "busy_s": 0.9, "window_s": 1.0}
    assert registry.metric("device_idle.round").read(
        _ctx(trace=trace)) == pytest.approx(10.0)


def test_b1_bound_is_perf_tables():
    b1 = registry.metric("b1_roofline.round")
    T = FEMNIST["params"]
    hbm = json.loads((ROOT / "perfbench" / "peaks.json").read_text()
                     )["hbm_bytes_per_s"]
    assert b1.launch_bytes(64, 64, T) / hbm * 1e3 == pytest.approx(1.009,
                                                                   abs=5e-4)
    assert b1.launch_bytes(64, 8, T) / hbm * 1e3 == pytest.approx(0.568,
                                                                  abs=5e-4)
    assert b1.round_launches(FEMNIST, False) == [(64, 64)] * 8 + [(64, 8)]
    assert len(b1.round_launches(FEMNIST, True)) == 10


def test_b1_reader_holds_the_launch_counter_to_the_plan():
    b1 = registry.metric("b1_roofline.round")
    bound = sum(b1.launch_bytes(n, k, FEMNIST["params"]) for n, k in
                b1.round_launches(FEMNIST, False)) / 3.35e12
    trace = {"steps": [{"rounds": 1}], "counters": {"b1_launches": 9},
             "kernels": [("void gossip_mix_kernel<float>", 0.0, 2 * bound)]}
    ctx = _ctx(trace=trace, mix={"compression": None})
    assert b1.read(ctx) == pytest.approx(50.0)
    trace["counters"]["b1_launches"] = 8
    assert b1.read(ctx) is None


def test_cnn_round_flops():
    mfu = registry.metric("mfu.round")
    layers = mfu.cnn_layer_flops(FEMNIST)
    assert layers == [1_254_400, 20_070_400, 12_845_056, 253_952]
    fwd = sum(layers)
    want = 64 * 16 * 16 * (3 * fwd - layers[0]) + 8 * 512 * fwd
    assert mfu.round_flops(FEMNIST) == want
