"""The port's host-side numpy layer equals the reference exactly: mixing
operators, ζ, canonical programs, lowering plans, resolved matrices,
partitions, synthetic data and the eq. 8 runtime/clock pricing."""
import jax.numpy as jnp
import numpy as np
import pytest

from repro.config import FLConfig
from repro.core import clock as rclock
from repro.core import program as rprg
from repro.core import topology as rtopo
from repro.core.cefedavg import FLSimulator
from repro.core.cefedavg import make_w_schedule as r_schedule
from repro.core.runtime import paper_runtime_model as r_runtime
from repro.data import federated as rfed
from repro.models.cnn import apply_mlp_classifier, init_mlp_classifier
from repro_torch.config import FLConfig as TFLConfig
from repro_torch.convert import tree_from_numpy
from repro_torch.core import clock as tclock
from repro_torch.core import program as tprg
from repro_torch.core import topology as ttopo
from repro_torch.core.cefedavg import FLSimulator as TSim
from repro_torch.core.cefedavg import make_w_schedule as t_schedule
from repro_torch.core.runtime import paper_runtime_model as t_runtime
from repro_torch.data import federated as tfed
from repro_torch.models.cnn import apply_mlp_classifier as t_apply

ALGOS = ("ce_fedavg", "hier_favg", "fedavg", "local_edge", "dec_local_sgd")
TOPOLOGIES = ("ring", "complete", "star", "torus", "erdos_renyi")


def _kw(algo, topology, **over):
    kw = dict(algorithm=algo, num_clusters=4,
              devices_per_cluster=1 if algo == "dec_local_sgd" else 2,
              tau=2, q=3, pi=5, topology=topology)
    kw.update(over)
    return kw


@pytest.mark.parametrize("topology", TOPOLOGIES)
@pytest.mark.parametrize("algo", ALGOS)
def test_w_schedule_equal(algo, topology):
    r = r_schedule(FLConfig(**_kw(algo, topology)))
    t = t_schedule(TFLConfig(**_kw(algo, topology)))
    for name in ("W_intra", "W_inter", "H", "adj"):
        np.testing.assert_array_equal(getattr(t, name), getattr(r, name))
    assert t.zeta == r.zeta
    assert t.cluster_sizes == r.cluster_sizes
    np.testing.assert_array_equal(t.degrees, r.degrees)


@pytest.mark.parametrize("variant", [
    {}, {"privatize": True}, {"compress": True},
    {"privatize": True, "compress": True}, {"faults": True}])
@pytest.mark.parametrize("kw", [
    _kw("ce_fedavg", "ring"), _kw("ce_fedavg", "ring", q=1),
    _kw("hier_favg", "star"),
    dict(algorithm="ce_fedavg", num_clusters=4, devices_per_cluster=2,
         hierarchy=(2, 2, 2), tau=3, q=2, pi=4)])
def test_programs_and_lowering_plans_equal(kw, variant):
    r = rprg.canonical_program(FLConfig(**kw), **variant)
    t = tprg.canonical_program(TFLConfig(**kw), **variant)
    assert [repr(o) for o in t.ops] == [repr(o) for o in r.ops]
    assert repr(t.blocks()) == repr(r.blocks())
    for fuse in (True, False):
        rp = rprg.lowering_plan(r, fuse=fuse)
        tp = tprg.lowering_plan(t, fuse=fuse)
        assert repr(tp) == repr(rp)
        assert ([(repr(b), c) for b, c in tprg.block_runs(tp)]
                == [(repr(b), c) for b, c in rprg.block_runs(rp)])


@pytest.mark.parametrize("algo,topology", [
    ("ce_fedavg", "ring"), ("ce_fedavg", "torus"), ("hier_favg", "ring"),
    ("fedavg", "complete"), ("local_edge", "star"),
    ("dec_local_sgd", "erdos_renyi")])
def test_resolved_matrices_equal(algo, topology):
    """The simulator's cached round operands: the reference's static
    ``_resolve_args`` against the port's, fused as the banks fuse."""
    kw = _kw(algo, topology)
    x, y = rfed.make_synthetic_classification(64, 4, 3, seed=0)
    parts = rfed.dirichlet_partition(y, FLConfig(**kw).n, 0.5, seed=1)
    data = rfed.build_fl_data(x, y, parts, x[:8], y[:8], 8)
    ref = FLSimulator(lambda k: init_mlp_classifier(k, 4, 5, 3),
                      apply_mlp_classifier, FLConfig(**kw),
                      {k: jnp.asarray(v) for k, v in data.items()},
                      batch_size=4)
    port = TSim(lambda g: tree_from_numpy(
        {"f1": {"w": np.zeros((4, 5), np.float32),
                "b": np.zeros(5, np.float32)},
         "f2": {"w": np.zeros((5, 3), np.float32),
                "b": np.zeros(3, np.float32)}}),
        t_apply, TFLConfig(**kw), data, batch_size=4, device="cpu")
    r_mats = ref._resolve_args(ref._canonical, None, fuse=True).mats
    t_mats = port._resolve_args(port._canonical).mats
    assert len(t_mats) == len(r_mats)
    for a, b in zip(t_mats, r_mats):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_hierarchy_operators_equal():
    for levels in ((2, 2, 2), (3, 2), (2, 3, 2, 2)):
        r, t = rtopo.Hierarchy(levels), ttopo.Hierarchy(levels)
        for lvl in range(r.depth):
            np.testing.assert_array_equal(
                t.tier_operator(lvl, 3, "ring"),
                r.tier_operator(lvl, 3, "ring"))
            assert t.num_groups(lvl) == r.num_groups(lvl)


def test_cluster_operators_equal():
    labels = np.array([0, 2, 1, 1, 0, 2, 2])
    mask = np.array([1, 0, 1, 1, 0, 1, 1.0])
    H = rtopo.mixing_matrix(rtopo.ring(3))
    rB = rtopo.assignment_matrix(labels, 3)
    tB = ttopo.assignment_matrix(labels, 3)
    np.testing.assert_array_equal(tB, rB)
    np.testing.assert_array_equal(ttopo.masked_cluster_average(tB, mask),
                                  rtopo.masked_cluster_average(rB, mask))
    np.testing.assert_array_equal(
        ttopo.masked_inter_operator(tB, H, 4, mask),
        rtopo.masked_inter_operator(rB, H, 4, mask))
    np.testing.assert_array_equal(
        ttopo.renormalize_rows(H, np.array([1, 0, 1.0])),
        rtopo.renormalize_rows(H, np.array([1, 0, 1.0])))


def test_partitions_and_data_equal():
    x, y = rfed.make_synthetic_classification(500, 8, 6, seed=3, noise=2.0)
    tx, ty = tfed.make_synthetic_classification(500, 8, 6, seed=3,
                                                noise=2.0)
    np.testing.assert_array_equal(tx, x)
    np.testing.assert_array_equal(ty, y)
    xi, yi = rfed.make_synthetic_images(40, 28, 1, 62, seed=4)
    txi, tyi = tfed.make_synthetic_images(40, 28, 1, 62, seed=4)
    np.testing.assert_array_equal(txi, xi)
    np.testing.assert_array_equal(tyi, yi)
    for a, b in [
            (tfed.dirichlet_partition(y, 8, 0.3, 5),
             rfed.dirichlet_partition(y, 8, 0.3, 5)),
            (tfed.shard_by_label(y, 8, 2, 5), rfed.shard_by_label(y, 8, 2, 5)),
            (tfed.cluster_partition(y, 4, 2, cluster_iid=True, seed=5),
             rfed.cluster_partition(y, 4, 2, cluster_iid=True, seed=5)),
            (tfed.cluster_partition(y, 4, 2, cluster_iid=False, seed=5),
             rfed.cluster_partition(y, 4, 2, cluster_iid=False, seed=5))]:
        assert len(a) == len(b)
        for pa, pb in zip(a, b):
            np.testing.assert_array_equal(pa, pb)
    parts = rfed.dirichlet_partition(y, 8, 0.3, 5)
    rd = rfed.build_fl_data(x, y, parts, x[:9], y[:9], 40)
    td = tfed.build_fl_data(x, y, parts, x[:9], y[:9], 40)
    for k in rd:
        np.testing.assert_array_equal(td[k], rd[k])


@pytest.mark.parametrize("algo", ALGOS)
def test_runtime_and_program_pricing_equal(algo):
    kw = _kw(algo, "ring")
    fr, ft = FLConfig(**kw), TFLConfig(**kw)
    rr, tr_ = r_runtime(), t_runtime()
    assert (tr_.round_time(algo, 2, 3, 5, 0.5)
            == rr.round_time(algo, 2, 3, 5, 0.5))
    rp, tp = rprg.canonical_program(fr), tprg.canonical_program(ft)
    speeds = np.linspace(1e11, 7e11, fr.n)
    mask = (np.arange(fr.n) % 3 != 0).astype(float)
    assert (tclock.program_compute_time(tr_, tp, speeds, mask)
            == rclock.program_compute_time(rr, rp, speeds, mask))
    assert (tclock.program_comm_time(tr_, algo, tp, 0.25)
            == rclock.program_comm_time(rr, algo, rp, 0.25))
    rc, tc = rclock.EventClock(rr, fr), tclock.EventClock(tr_, ft)
    for _ in range(3):
        assert tc.charge_program(tp) == rc.charge_program(rp)
        assert tc.charge_round() == rc.charge_round()
