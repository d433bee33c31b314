"""The dry-run (``repro_torch.launch.dryrun``): its fake worlds, its
records and its predicted traffic.

- ``lower_combo`` leaves no process group up, whether it returns or
  raises;
- both packages' ``report.dryrun_table`` read the same records and give
  the same table;
- the predicted traffic of a round of reduced qwen2, zamba2 and mixtral
  at dp 2 x mp 2 (rank 0 on ``meta`` tensors in a fake world of 4)
  equals what a real gloo world of 4 CPU ranks counts, in bytes and
  calls by group and kind (``tests/torch_tp_cases.py`` ``round_job``,
  whose count holds 2 rounds and the gathers of the replica's params
  and momentum that follow them, counted here in the fake world)."""
import json
import os

import pytest
import torch.distributed as dist

import torch_tp_cases as cases
import tp_reference as ref
from repro.launch import report as r_report
from repro_torch.config import ShapeConfig
from repro_torch.core.sharded import ShardedCEFedAvg
from repro_torch.launch import dryrun as dr
from repro_torch.launch import mesh as lm
from repro_torch.launch import report as t_report

TRAFFIC_FAMILIES = ["dense", "hybrid", "moe"]


def test_lower_combo_leaves_no_world():
    rec = dr.lower_combo("qwen2-0.5b", "decode_32k")
    assert rec["production"]["coll_bytes"] > 0
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="not divisible"):
        dr.lower_combo("qwen2-0.5b", "train_4k",
                       fl_overrides={"num_clusters": 3})
    assert not dist.is_initialized()


def test_fake_world_refuses_a_world_that_is_up():
    with lm.fake_world(lm.make_mesh((2, 2), ("data", "model"))) as mesh:
        assert (mesh.world_size, mesh.model, mesh.device.type) == (4, 2,
                                                                   "meta")
        with pytest.raises(RuntimeError, match="already in a world"):
            with lm.fake_world(lm.make_mesh((1, 1), ("data", "model"))):
                pass
    assert not dist.is_initialized()


def test_both_reports_read_the_records_alike(tmp_path):
    for arch, shape in (("qwen2-0.5b", "prefill_32k"),
                        ("mamba2-2.7b", "decode_32k"),
                        ("mixtral-8x7b", "long_500k")):
        rec = dr.lower_combo(arch, shape)
        with open(os.path.join(tmp_path, f"{arch}_{shape}_16x16.json"),
                  "w") as f:
            json.dump(rec, f)
    recs = t_report.load(str(tmp_path), "16x16")
    assert len(recs) == 3
    assert recs == r_report.load(str(tmp_path), "16x16")
    assert t_report.dryrun_table(recs) == r_report.dryrun_table(recs)
    ours = t_report.roofline_table(recs).splitlines()
    theirs = r_report.roofline_table(recs).splitlines()
    # the same cells but the advice, which names the card's counterparts
    assert [row.rsplit("|", 2)[0] for row in ours[2:]] == \
        [row.rsplit("|", 2)[0] for row in theirs[2:]]


def _rows(traffic, times=1):
    return {g: {k: (v["calls"] * times, v.get("sent", v.get("bytes"))
                    * times) for k, v in ops.items()}
            for g, ops in traffic.items() if ops}


def _add(a, b):
    return {g: {k: tuple(x + y for x, y in zip(a.get(g, {}).get(k, (0, 0)),
                                                 b.get(g, {}).get(k, (0, 0))))
                for k in set(a.get(g, {})) | set(b.get(g, {}))}
            for g in set(a) | set(b)}


@pytest.fixture(scope="module")
def gloo_traffic():
    jobs = [("round", f, 2, 2, ref.ref_init(f, 2))
            for f in TRAFFIC_FAMILIES]
    out = lm.run_local_ranks(cases.tp_world, 4, args=(jobs,), device="cpu",
                             timeout_s=600)
    return {f: [rank[i]["traffic"] for rank in out]
            for i, f in enumerate(TRAFFIC_FAMILIES)}


@pytest.mark.parametrize("family", TRAFFIC_FAMILIES)
def test_predicted_traffic_equals_gloo_world(gloo_traffic, family):
    exp = cases.experiment("repro_torch", family, 2)
    mesh = lm.make_mesh((2, 2), ("data", "model"))
    fig = dr.count_train(exp, mesh, ShapeConfig(family, cases.S,
                                                cases.B * 2, "train"),
                         analysis=False)
    rounds = _rows(fig["production"]["coll"]["by_group"], cases.ROUNDS)
    # round_job then gathers the replica's params and momentum whole
    with lm.fake_world(mesh) as rmesh:
        trn = ShardedCEFedAvg(exp, rmesh)
        params = trn.shard(trn.param_shapes)
        trn.gather(params)
        trn.gather(trn.opt_init(params)["mu"])
        gathers = _rows(rmesh.traffic_by_group())
    assert set(gathers) == {"model"} and set(gathers["model"]) == {
        "all_gather"}
    assert _add(rounds, gathers) == _rows(gloo_traffic[family][0])
    assert rounds["model"] and rounds["data"]
