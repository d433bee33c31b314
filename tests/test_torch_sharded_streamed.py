"""The port's sharded streamed bank (``repro_torch.core.sharded.
ShardedStreamedBank``) on one gloo world of 4 CPU ranks, against the
reference's single-process streamed engine.

The configuration is ``tests/test_clientstore.py``'s (MLP 16-32-4, m = 4
clusters of 4 data shards on a ring, tau 2, q 2, pi 2, lr 0.1, seed 1)
under its mobile population of 400 virtual clients. The world is spawned
once for the module (``torch_dist_cases.sharded_streamed_world``); while
it runs, this process computes the reference's ``FLSimulator(...,
store_shards=4, min_bucket=4)`` — the reference's ``ShardedStreamedBank``
without its placement, the oracle of its own sharded test, which needs
no 8-device XLA host here.

- Trajectories: three rounds within 2e-4 of the reference (the boundary
  sums run in another order: the reduce-scatter of the ranks' partials);
  pipelined equals serial bit for bit at f32 and at int8, store
  snapshots included; a world of one is the single-process engine, bit
  for bit.
- Structure: every bucket divisible by R, a rank's slab block S/R lanes,
  one store shard a rank; a round's reduce-scatter bytes equal
  (R - 1)/R·S·T·4 a boundary and no gather runs.
- Kill-and-resume bit for bit; checkpoints cross to and from both
  packages' single-process streamed engines; the launcher's rank
  function resumes bit for bit.
"""
import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from repro.checkpoint import RunCheckpoint as RefRunCheckpoint
from repro.config import FLConfig
from repro.core.cefedavg import FLSimulator
from repro.models.cnn import apply_mlp_classifier, init_mlp_classifier
from repro_torch.checkpoint import RunCheckpoint
from repro_torch.config import FLConfig as TFLConfig
from repro_torch.convert import tree_from_numpy
from repro_torch.core.cefedavg import FLSimulator as TSim
from repro_torch.core.sharded import ShardedStreamedBank
from repro_torch.launch import mesh as lm
from repro_torch.models.cnn import apply_mlp_classifier as t_apply

ATOL = 2e-4
R = cases.SSB_RANKS
ROUNDS = cases.SSB_ROUNDS
INIT = jax.device_get(init_mlp_classifier(jax.random.PRNGKey(1), 16, 32, 4))


def _ref(**kw):
    data = {k: jnp.asarray(v) for k, v in cases.ssb_data().items()}
    return FLSimulator(lambda k: init_mlp_classifier(k, 16, 32, 4),
                       apply_mlp_classifier, FLConfig(**cases.SSB_FL), data,
                       **cases.ssb_kwargs("repro"), **kw)


def _port(**kw):
    return TSim(lambda g: tree_from_numpy(INIT), t_apply,
                TFLConfig(**cases.SSB_FL), cases.ssb_data(), device="cpu",
                **cases.ssb_kwargs("repro_torch"), **kw)


def _flat(tree, m=None):
    """A model tree (either package's) as one f32 row, or (m, T) rows of
    a stacked one."""
    leaves = [np.asarray(leaf.numpy() if isinstance(leaf, torch.Tensor)
                         else leaf) for leaf in jax.tree.leaves(tree)]
    if m is None:
        return np.concatenate([leaf.reshape(-1) for leaf in leaves])
    return np.concatenate([leaf.reshape(m, -1) for leaf in leaves], 1)


def _state(sim) -> dict:
    """Global row, edge rows and store snapshot of a single-process sim of
    either package."""
    if isinstance(sim, TSim):
        return cases.streamed_state(sim)
    return {"global": _flat(sim.global_model()),
            "edge": _flat(sim.edge_models(), sim.fl.num_clusters),
            "store": sim.store.snapshot()}


@pytest.fixture(scope="module")
def crossing(tmp_path_factory):
    """Checkpoints of the reference's and the port's single-process
    streamed engines after one round, for the world to restore, and each
    engine's state then and after one more round."""
    d = tmp_path_factory.mktemp("ssb")
    out = {"dir": str(d)}
    for what, sim, rc_cls in (("ref", _ref(), RefRunCheckpoint),
                              ("port", _port(), RunCheckpoint)):
        sim.step_round()
        path = str(d / what)
        rc_cls(path).save(sim, round_idx=1)
        out[what] = path
        out[what + "_saved"] = _state(sim)
        sim.step_round()
        out[what + "_next"] = _state(sim)
    return out


@pytest.fixture(scope="module")
def world(crossing):
    ex = concurrent.futures.ThreadPoolExecutor(1)
    fut = ex.submit(lm.run_local_ranks, cases.sharded_streamed_world, R,
                    args=(INIT, crossing["dir"], crossing["ref"],
                          crossing["port"]),
                    device="cpu", timeout_s=600)
    yield fut
    ex.shutdown(wait=True)


@pytest.fixture(scope="module")
def oracle(world):
    """The reference's ``FLSimulator(store_shards=4, min_bucket=4)``, three
    serial rounds, computed while the world runs."""
    sim = _ref(store_shards=R, min_bucket=R)
    rounds = []
    for _ in range(ROUNDS):
        sim.step_round()
        rounds.append(_flat(sim.global_model()))
    return dict(_state(sim), rounds=rounds, buckets=sim._buckets,
                S=sim.last_bucket)


@pytest.fixture(scope="module")
def ranks(world):
    return world.result()


def _same_store(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["serial", "pipelined"])
def test_trajectory_matches_reference(oracle, ranks, pipeline):
    run = ranks[0]["runs"][("f32", pipeline)]
    gaps = [float(np.abs(r["global"] - o).max())
            for r, o in zip(run["rounds"], oracle["rounds"])]
    store = {k: float(np.abs(run["store"][k] - oracle["store"][k]).max())
             for k in ("cluster", "mom_q")}
    edge = float(np.abs(run["edge"] - oracle["edge"]).max())
    print(f"sharded streamed ({'pipelined' if pipeline else 'serial'}) "
          f"against the reference's store_shards=4 engine: global by round "
          f"{gaps}, edge {edge:.3e}, store {store} (atol {ATOL})")
    assert max(gaps) < ATOL and edge < ATOL and max(store.values()) < ATOL
    np.testing.assert_array_equal(run["store"]["ids"],
                                  oracle["store"]["ids"])
    assert run["buckets"] == tuple(oracle["buckets"])
    assert run["rounds"][-1]["S"] == oracle["S"]


@pytest.mark.parametrize("codec", ["f32", "int8"])
def test_pipelined_equals_serial_bitwise(ranks, codec):
    for r in ranks:
        ser, pip = r["runs"][(codec, False)], r["runs"][(codec, True)]
        for a, b in zip(ser["rounds"], pip["rounds"]):
            np.testing.assert_array_equal(a["global"], b["global"])
        np.testing.assert_array_equal(ser["edge"], pip["edge"])
    _same_store(ranks[0]["runs"][(codec, False)]["store"],
                ranks[0]["runs"][(codec, True)]["store"])


@pytest.mark.parametrize("pipeline", [False, True],
                         ids=["serial", "pipelined"])
def test_world_of_one_is_the_single_process_engine(pipeline):
    single = _port(pipeline=pipeline)
    with lm.single_rank_world("gloo", "cpu") as mesh:
        shd = ShardedStreamedBank(lambda g: tree_from_numpy(INIT), t_apply,
                                  TFLConfig(**cases.SSB_FL),
                                  cases.ssb_data(), mesh, pipeline=pipeline,
                                  **cases.ssb_kwargs("repro_torch"))
        for _ in range(ROUNDS):
            single.step_round()
            shd.step_round()
        a, b = _state(single), cases.streamed_state(shd)
    np.testing.assert_array_equal(a["global"], b["global"])
    np.testing.assert_array_equal(a["edge"], b["edge"])
    _same_store(a["store"], b["store"])
    assert shd.last_bucket == single.last_bucket
    assert shd.peak_slab_bytes == shd.peak_rank_slab_bytes \
        == single.peak_slab_bytes


def test_world_is_bitwise_the_card_checks_witness(ranks):
    """``chip_smoke.py``'s oracle for the sharded population phase: the
    single-process engine stepping its trainers in the ranks' blocks of
    S/R lanes and summing each boundary's per-rank B1 partials in rank
    order (``_rank_order``) reproduces the world bit for bit."""
    sim = _port(store_shards=R, min_bucket=R)
    cases.chip_smoke()._rank_order(sim, R)
    run = ranks[0]["runs"][("f32", False)]
    for x in run["rounds"]:
        sim.step_round()
        np.testing.assert_array_equal(
            sim.layout.flatten_one(sim.global_model()).numpy(), x["global"])
    _same_store(sim.store.snapshot(), run["store"])


def test_slab_and_store_are_split_over_the_ranks(ranks):
    for rank, r in enumerate(ranks):
        for run in r["runs"].values():
            assert all(b % R == 0 for b in run["buckets"])
            S, T = run["rounds"][-1]["S"], run["T"]
            assert run["peak_slab"] == max(
                2 * 4 * x["S"] * T for x in run["rounds"])
            assert run["peak_rank_slab"] * R == run["peak_slab"]
            assert S in run["buckets"] and run["shards"] == R
            assert (run["own"] % R == rank).all() and run["own"].size
    own = np.sort(np.concatenate([r["runs"][("f32", False)]["own"]
                                  for r in ranks]))
    np.testing.assert_array_equal(own,
                                  ranks[0]["runs"][("f32", False)]["store"]
                                  ["ids"])


def test_traffic_matches_the_model(ranks):
    """A round's boundaries are q reduce-scatters of (R - 1)/R·S·T·4
    bytes each way (the slab is never gathered); page-in, page-out and the
    reference broadcast are exchanges of encoded and synced rows."""
    fl = TFLConfig(**cases.SSB_FL)
    for r in ranks:
        for (codec, pipeline), run in r["runs"].items():
            for x in run["rounds"]:
                t, S, T = x["traffic"], x["S"], run["T"]
                per = (R - 1) * (S // R) * T * 4
                assert t["reduce_scatter"] == {
                    "calls": fl.q, "sent": fl.q * per, "recv": fl.q * per}
                assert not {"gather", "all_gather", "all_reduce"} & set(t)
                assert t["exchange_rows"]["calls"] >= 1


def test_new_collectives(ranks):
    xs = [np.random.default_rng(me).standard_normal(
        (2 * R, 5)).astype(np.float32) for me in range(R)]
    total = np.sum(xs, 0)
    counts = ranks[0]["collectives"]["counts"]
    for me, r in enumerate(ranks):
        c = r["collectives"]
        np.testing.assert_allclose(c["reduce_scatter"],
                                   total[2 * me:2 * me + 2], rtol=1e-6)
        exp = []
        for src in range(R):
            off = int(counts[src, :me].sum())
            rows = np.arange(int(counts[src].sum()) * 3).reshape(-1, 3) \
                + 1000 * src
            exp.append(rows[off:off + counts[src, me]])
        np.testing.assert_array_equal(c["exchange"], np.concatenate(exp))
        rs = c["traffic"]["reduce_scatter"]
        assert rs["sent"] == rs["recv"] == (R - 1) * 2 * 5 * 4
        ex = c["traffic"]["exchange_rows"]
        assert ex["sent"] == (counts[me].sum() - counts[me, me]) * 3 * 8
        assert ex["recv"] == (counts[:, me].sum() - counts[me, me]) * 3 * 8


def test_kill_and_resume_is_bitwise(ranks):
    res = ranks[0]["resume"]
    assert res["round"] == ROUNDS - 1 and res["engine"] == "streamed"
    np.testing.assert_array_equal(res["full"]["global"],
                                  res["resumed"]["global"])
    np.testing.assert_array_equal(*res["key"])
    _same_store(res["full"]["store"], res["resumed"]["store"])


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_checkpoint_crosses_to_single_process(ranks, pkg):
    """The world's checkpoint (the ranks' shards merged on rank 0) in
    either package's single-process streamed engine: its store is the
    world's, and one more round lands within 2e-4 of the world's."""
    ck = ranks[0]["ckpt"]
    sim = _ref() if pkg == "ref" else _port()
    rc = (RefRunCheckpoint if pkg == "ref" else RunCheckpoint)(ck["dir"])
    meta = rc.restore(sim)
    assert meta["round"] == 1 and meta["engine"] == "streamed"
    _same_store(ck["saved"]["store"], sim.store.snapshot())
    sim.step_round()
    nxt = _state(sim)
    gap = float(np.abs(nxt["global"] - ck["next"]["global"]).max())
    print(f"world checkpoint continued in the {pkg} single-process engine: "
          f"{gap:.3e} from the world's next round")
    assert gap < ATOL


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_checkpoint_crosses_from_single_process(crossing, ranks, pkg):
    got = ranks[0]["ckpt"]["from_" + pkg]
    _same_store(crossing[pkg + "_saved"]["store"], got["restored"]["store"])
    np.testing.assert_array_equal(crossing[pkg + "_saved"]["global"],
                                  got["restored"]["global"])
    gap = float(np.abs(got["next"]["global"]
                       - crossing[pkg + "_next"]["global"]).max())
    assert gap < ATOL, gap


def test_launcher_resumes_bitwise(ranks):
    for r in ranks:
        full, res = r["launcher"]["full"], r["launcher"]["resumed"]
        np.testing.assert_array_equal(full["global_row"], res["global_row"])
        _same_store(full["store"], res["store"])
        assert full["traffic"]["reduce_scatter"]["calls"] > 0


def test_engine_guards():
    from repro_torch.config import ScenarioConfig
    from repro_torch.launch.mesh import ReplicaMesh
    mesh = ReplicaMesh(world_size=2, rank=0, pods=1, data=1,
                       device=torch.device("cpu"), backend="gloo", model=2)
    kw = cases.ssb_kwargs("repro_torch")

    def build(**over):
        return ShardedStreamedBank(lambda g: tree_from_numpy(INIT), t_apply,
                                   TFLConfig(**cases.SSB_FL),
                                   cases.ssb_data(), mesh, **dict(kw, **over))
    with pytest.raises(ValueError, match="virtual population"):
        build(scenario=ScenarioConfig(**cases.SSB_MOBILE))
    with pytest.raises(ValueError, match="not tensor-parallel"):
        build()
    with pytest.raises(ValueError, match="bank engine"):
        build(bank=False)
