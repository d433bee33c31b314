"""The port's collectives over the flat replica axis
(``repro_torch.core.collectives``), the device half of its gossip
lowerings (``repro_torch.core.gossip``) and its replica meshes
(``repro_torch.launch.mesh``), on one gloo world of 8 CPU ranks spawned
for the module (``torch_dist_cases.collectives_world``).

Every collective is held to its numpy meaning on the stacked rows (8 × 37
f32 from a seed): ``ppermute`` moves rows along (src, dst) pairs and
zero-fills unmatched receivers, ``psum_groups`` sums over each group of a
partition, and each call counts the bytes it moves. The lowerings are
held to the dense operators they realize within 1e-6: π rounds of the
edge-colored matchings to H^π, the exact mode's weighted rotations to
H^π, ``dense_mix_rows`` to W @ X, the grouped means to block averages
(the reference's ``tests/test_gossip_schedule.py`` builds the same plans
host-side; the reference lowers them in ``shard_map``)."""
import concurrent.futures

import numpy as np
import pytest
import torch

import torch_dist_cases as cases
from repro_torch.config import FLConfig
from repro_torch.core import topology as topo
from repro_torch.core.cefedavg import make_w_schedule
from repro_torch.launch import mesh as lm

NDEV = cases.NDEV
TOL = 1e-6


@pytest.fixture(scope="module")
def ranks():
    return lm.run_local_ranks(cases.collectives_world, NDEV, device="cpu",
                              timeout_s=300)


def _stack(ranks, key, i=None):
    return np.concatenate([r[key] if i is None else r[key][i]
                           for r in ranks])


X = cases.rows_of(0)
ROW_BYTES = X.shape[1] * 4


def test_mesh_places_each_rank(ranks):
    for r, res in enumerate(ranks):
        m = res["mesh"]
        assert m["rank"] == m["replica"] == r
        assert m["transport"] == "gloo"
        assert m["shape"] == {"data": NDEV, "model": 1}
        assert m["axis_names"] == ("data", "model")
        assert m["flat"] == (NDEV, r)
        p = res["pods"]
        assert (p["pod"], p["data"]) == divmod(r, NDEV // 2)
        assert p["replica"] == r
        assert p["shape"] == {"pod": 2, "data": NDEV // 2, "model": 1}
        assert p["axis_names"] == ("pod", "data", "model")
        assert p["rotate"] == tuple(((d + 2) % NDEV, d) for d in range(NDEV))


@pytest.mark.parametrize("name", sorted(cases.PERMS))
def test_ppermute_moves_rows_and_zero_fills(ranks, name):
    perm = cases.PERMS[name]
    want = np.zeros_like(X)
    for src, dst in perm:
        want[dst] = X[src]
    np.testing.assert_array_equal(_stack(ranks, "ppermute_" + name, 0),
                                  want)
    for r, res in enumerate(ranks):
        traffic = res["ppermute_" + name][1]
        assert traffic["calls"] == 1
        sends = any(s == r and d != r for s, d in perm)
        recvs = any(d == r and s != r for s, d in perm)
        assert traffic["sent"] == ROW_BYTES * sends
        assert traffic["recv"] == ROW_BYTES * recvs


def test_ppermute_rejects_a_non_permutation(ranks):
    assert "not a partial permutation" in ranks[0]["bad_perm"]


@pytest.mark.parametrize("name", sorted(cases.PARTITIONS))
def test_psum_groups_sums_each_group(ranks, name):
    want = np.empty_like(X)
    for g in cases.PARTITIONS[name]:
        want[list(g)] = X[list(g)].sum(0)
    np.testing.assert_allclose(_stack(ranks, "psum_" + name, 0), want,
                               atol=TOL, rtol=0)
    for res in ranks:
        assert res["psum_" + name][1] == {"calls": 1, "sent": ROW_BYTES,
                                          "recv": ROW_BYTES}


def test_subgroups_are_made_once_per_partition(ranks):
    for res in ranks:
        before, after = res["groups_cached"]
        assert before == after == len(cases.PARTITIONS)


def test_all_reduce_and_gather(ranks):
    want = np.broadcast_to(2 * X.sum(0), X.shape)
    np.testing.assert_allclose(_stack(ranks, "all_reduce"), want,
                               atol=TOL, rtol=0)
    rows, traffic = ranks[0]["gather"]
    np.testing.assert_array_equal(rows, X)
    assert traffic == {"calls": 1, "sent": 0,
                       "recv": ROW_BYTES * (NDEV - 1)}
    for res in ranks[1:]:
        assert res["gather"][0] is None
        assert res["gather"][1] == {"calls": 1, "sent": ROW_BYTES,
                                    "recv": 0}


def _cluster_op(M):
    """(n, n) operator applying the (M, M) cluster operator to every
    device of a cluster (devices of one cluster hold one model)."""
    fl = FLConfig(**cases.FL)
    return np.kron(M, np.eye(fl.devices_per_cluster))


@pytest.mark.parametrize("mode", ["rounds", "exact"])
def test_gossip_in_body_applies_h_pi(ranks, mode):
    """π single rounds and the π-round schedule both give H^π (per
    device column of its cluster), and a rank receives at most
    ``models_received_per_replica`` rows."""
    fl = FLConfig(**cases.FL)
    H = make_w_schedule(fl).H
    want = _cluster_op(np.linalg.matrix_power(H, fl.pi).T) @ X.astype(
        np.float64)
    got = _stack(ranks, "gossip_" + mode, 0)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    if mode == "rounds":
        np.testing.assert_allclose(_stack(ranks, "gossip_rounds", 1), want,
                                   atol=TOL, rtol=0)
    for res in ranks:
        _, _, traffic, models = res["gossip_" + mode]
        per = 2 if mode == "rounds" else 1   # two schedules ran in rounds
        assert traffic["recv"] == per * models * ROW_BYTES


def test_dense_mix_rows_is_w_at_x(ranks):
    W = cases.stochastic(1)
    want = W.astype(np.float64) @ X.astype(np.float64)
    np.testing.assert_allclose(_stack(ranks, "dense_mix", 0), want,
                               atol=TOL, rtol=0)
    np.testing.assert_array_equal(_stack(ranks, "dense_mix", 1),
                                  _stack(ranks, "dense_mix", 0))
    for res in ranks:
        t = res["dense_mix"][2]
        assert t["calls"] == 2 * (NDEV - 1)
        assert t["recv"] == t["sent"] == 2 * (NDEV - 1) * ROW_BYTES


def test_group_and_cluster_means(ranks):
    strided = np.empty_like(X)
    for g in cases.PARTITIONS["strided"]:
        strided[list(g)] = X[list(g)].mean(0)
    np.testing.assert_allclose(_stack(ranks, "group_mean"), strided,
                               atol=TOL, rtol=0)
    V = topo.intra_cluster_operator([2] * 4)
    np.testing.assert_allclose(_stack(ranks, "cluster_mean"), V @ X,
                               atol=TOL, rtol=0)


def test_tree_lowerings_keep_each_leaf_dtype(ranks):
    """apply_gossip / apply_cluster_mean mix a pytree in f32 and cast
    each leaf back (a bf16 leaf stays bf16)."""
    fl = FLConfig(**cases.FL)
    H = make_w_schedule(fl).H
    ops = {"gossip": _cluster_op(np.linalg.matrix_power(H, fl.pi).T),
           "cluster": topo.intra_cluster_operator([2] * 4)}
    w_in = np.stack([r["tree"]["input"][1].reshape(-1) for r in ranks])
    b_in = np.concatenate([r["tree"]["input"][2][None] for r in ranks])
    for what, op in ops.items():
        dt = {r["tree"][what][0] for r in ranks}
        assert dt == {"torch.bfloat16"}
        w = np.stack([r["tree"][what][1].reshape(-1) for r in ranks])
        b = np.concatenate([r["tree"][what][2][None] for r in ranks])
        np.testing.assert_allclose(b, op @ b_in, atol=TOL, rtol=0)
        # bf16 leaves: within one bf16 step of the f32 mix
        np.testing.assert_allclose(w, op @ w_in, atol=0, rtol=2 ** -7)


def test_run_local_ranks_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="(?s)rank 1:.*boom on rank 1"):
        lm.run_local_ranks(_fail_on_rank_one, 2, device="cpu",
                           timeout_s=120)


def _fail_on_rank_one():
    import torch.distributed as dist
    if dist.get_rank() == 1:
        raise ValueError("boom on rank 1")
    return dist.get_rank()


def test_mesh_needs_a_world_and_a_device():
    with pytest.raises(RuntimeError, match="initialised default process "
                                           "group"):
        lm.make_replica_mesh(8)
    with pytest.raises(ValueError, match="NCCL moves CUDA tensors"):
        lm.rank_device("nccl", "cpu")
    with pytest.raises(ValueError, match="backend"):
        lm.rank_device("mpi", "cpu")
    assert lm.rank_device("gloo", "cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="pass device='cpu'"):
            lm.rank_device("gloo")


def _rank_and_size():
    import torch.distributed as dist
    return dist.get_rank(), dist.get_world_size()


def test_concurrent_worlds_keep_their_own_rendezvous():
    """Worlds spawned at once on one host (as under pytest-xdist) each
    join through their own file store, never another world's."""
    with concurrent.futures.ThreadPoolExecutor(3) as ex:
        futs = [ex.submit(lm.run_local_ranks, _rank_and_size, size,
                          device="cpu", timeout_s=120) for size in (2, 3, 2)]
        got = [f.result() for f in futs]
    assert got == [[(r, size) for r in range(size)] for size in (2, 3, 2)]
