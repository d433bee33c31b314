"""The port's federated LM trainer (``repro_torch.core.sharded.
ShardedCEFedAvg``, one replica a rank) on one gloo world of 8 CPU ranks,
against the reference.

The world is spawned once for the module (``torch_dist_cases.
sharded_lm_world``); while it runs, this process computes the
reference's side from the same numpy inputs:

- The reference's eq. (10) oracle (``tests/test_sharded.py::
  test_sharded_matches_simulator``): the literal loop of vmapped grads,
  SGD steps and ``mix`` with the static operators, in-process on one JAX
  CPU device, from the reference's own replicas. The port's round — for
  CE-FedAvg and for each baseline of ``test_baseline_algorithms_lower``
  — within 1e-5 of it, params and loss (f32 sums in another order).
- ``test_sparse_equals_dense_{singlepod,multipod,star_multipod}``: the
  sparse and ringweight backends within the reference's 1e-4 of the
  dense one; the dense rounds all-gather, the sparse ones never do.
- The component steps (local step, intra, inter) composed by hand equal
  the global round bit for bit; the launcher's rank function runs 2
  rounds and its checkpoint loads in the reference's ``load_checkpoint``.

In this process: a world of one against the reference's
``ShardedCEFedAvg`` on a 1 x 1 mesh over 2 rounds with momentum 0.9
(params and loss within 1e-5), and the abstract shapes against the
reference's.
"""
import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_dist_cases as cases
from repro.checkpoint import load_checkpoint
from repro.core.cefedavg import make_w_schedule, mix
from repro.core.sharded import ShardedCEFedAvg as RSharded
from repro.core.sharded import stacked_abstract as r_stacked
from repro.models import model as rm
from repro_torch import tree as tr
from repro_torch.configs import ARCHS
from repro_torch.convert import tree_from_numpy
from repro_torch.core import sharded as ts
from repro_torch.launch import mesh as lm

NDEV = cases.NDEV
TOL = 1e-5
ORACLE = ("simulator", "fedavg", "hier_favg", "local_edge", "dec_local_sgd")


def _ref_replicas(exp, R: int, seed: int = 0):
    """The reference trainer's init: R replicas from split(key, R)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), R)
    return jax.device_get(jax.vmap(
        lambda k: rm.init_model(k, exp.model)[0])(keys))



@pytest.fixture(scope="module")
def stacked():
    return _ref_replicas(cases.lm_experiment("repro", "simulator"), NDEV)


@pytest.fixture(scope="module")
def world(stacked, tmp_path_factory):
    ex = concurrent.futures.ThreadPoolExecutor(1)
    fut = ex.submit(lm.run_local_ranks, cases.sharded_lm_world, NDEV,
                    args=(stacked, str(tmp_path_factory.mktemp("lm"))),
                    device="cpu", timeout_s=600)
    yield fut
    ex.shutdown(wait=True)


@pytest.fixture(scope="module")
def oracles(world, stacked):
    """The eq. (10) loop of every ORACLE case (computed while the world
    runs): final stacked params and the mean loss."""
    exp = cases.lm_experiment("repro", "simulator")
    grad_fn = jax.jit(jax.vmap(jax.value_and_grad(
        lambda p, b: rm.lm_loss(exp.model, p, b))))
    out = {}
    for name in ORACLE:
        fl = cases.lm_experiment("repro", name).fl
        sched = make_w_schedule(fl)
        lr = cases.LM_CASES[name][2]["learning_rate"]
        batch = {k: jnp.asarray(v) for k, v in cases.lm_batch(name).items()}
        p = jax.tree.map(jnp.asarray, stacked)
        losses = []
        for qi in range(fl.q):
            for ti in range(fl.tau):
                mb = {k: v[qi, ti] for k, v in batch.items()}
                loss, g = grad_fn(p, mb)
                losses.append(float(jnp.mean(loss)))
                p = jax.tree.map(lambda a, b: a - lr * b.astype(a.dtype),
                                 p, g)
            p = mix(sched.W_intra, p)
        p = mix(sched.W_inter, p)
        out[name] = (jax.tree.map(np.asarray, p), float(np.mean(losses)))
    return out


@pytest.fixture(scope="module")
def ranks(world):
    return world.result()


def _stacked(ranks, name):
    """The ranks' final params of case ``name``, stacked by replica."""
    leaves = [tr.tree_leaves(r[name]["params"]) for r in ranks]
    return [np.stack(col) for col in zip(*leaves)]


def _gap(a, b) -> float:
    return max(float(np.abs(np.asarray(x, np.float32) -
                            np.asarray(y, np.float32)).max())
               for x, y in zip(a, b))


def _oracle_gap(ranks, oracles, name):
    ref, loss = oracles[name]
    gap = _gap(_stacked(ranks, name), jax.tree.leaves(ref))
    print(f"{name}: max abs gap to the eq. 10 oracle {gap:.3e}, loss "
          f"{ranks[0][name]['loss']:.6f} against {loss:.6f}")
    assert gap < TOL, gap
    for r in ranks:
        assert abs(r[name]["loss"] - loss) < TOL
        assert r[name]["step"] == 4


def test_sharded_matches_simulator(ranks, oracles):
    """The port's round reproduces the paper-faithful eq. (10) loop (same
    data, the reference's replicas, SGD without momentum)."""
    _oracle_gap(ranks, oracles, "simulator")


@pytest.mark.parametrize("algo", ORACLE[1:])
def test_baseline_algorithms_lower(ranks, oracles, algo):
    assert np.isfinite(ranks[0][algo]["loss"])
    _oracle_gap(ranks, oracles, algo)


def _sparse_equals_dense(ranks, where, impls=("sparse",)):
    dense = _stacked(ranks, f"dense_{where}")
    for impl in impls:
        gap = _gap(dense, _stacked(ranks, f"{impl}_{where}"))
        print(f"{impl} against dense ({where}): max abs diff {gap:.3e}")
        assert gap < 1e-4, (impl, gap)
        for r in ranks:
            assert "all_gather" in r[f"dense_{where}"]["traffic"]
            traffic = r[f"{impl}_{where}"]["traffic"]
            assert "all_gather" not in traffic
            assert traffic["ppermute"]["calls"] > 0


def test_sparse_equals_dense_singlepod(ranks):
    _sparse_equals_dense(ranks, "singlepod")


def test_sparse_equals_dense_multipod(ranks):
    _sparse_equals_dense(ranks, "multipod")


def test_sparse_equals_dense_star_multipod(ranks):
    """Non-ring backhaul through the full trainer, pods crossed."""
    _sparse_equals_dense(ranks, "star_multipod", ("sparse", "ringweight"))


def test_component_steps_compose_to_the_round(ranks):
    assert all(r["components"]["bitwise"] for r in ranks)


def test_launcher_rounds_and_checkpoint(ranks):
    hist = [r["launcher"]["hist"] for r in ranks]
    assert all(h["round"] == [0, 1] for h in hist)
    assert all(np.isfinite(h["loss"]).all() for h in hist)
    # the round loss is the mean over replicas: the same on every rank
    assert len({tuple(h["loss"]) for h in hist}) == 1
    from repro.configs import get_model_config
    shapes = jax.eval_shape(lambda k: rm.init_model(
        k, get_model_config("qwen2-0.5b").reduced())[0],
        jax.random.PRNGKey(0))
    tree, meta = load_checkpoint(ranks[0]["launcher"]["ckpt"], like=shapes)
    assert meta == {"arch": "qwen2-0.5b", "rounds": 2}
    for a, s in zip(jax.tree.leaves(tree), jax.tree.leaves(shapes)):
        assert a.shape == s.shape and a.dtype == np.float32
        assert np.isfinite(a).all()


# ---------------------------------------------------------------------------
# in this process
# ---------------------------------------------------------------------------

def _sgd_momentum(exp):
    """``exp`` in a world of one: 1 cluster of 1, SGD with momentum 0.9
    at lr 0.05."""
    return dataclasses.replace(
        exp, fl=dataclasses.replace(exp.fl, num_clusters=1,
                                    devices_per_cluster=1),
        train=dataclasses.replace(exp.train, momentum=0.9,
                                  learning_rate=0.05))


def _world_of_one(rexp, texp, batches):
    """The port's trainer in a world of one against the reference's on a
    1 x 1 mesh, a round a batch, from the reference's init: loss, params
    and ``mu`` within TOL."""
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    rtr = RSharded(rexp, mesh)
    with mesh:
        rp, ro = jax.jit(rtr.init_fn())(jax.random.PRNGKey(0))
        host = jax.device_get(rp)
        round_fn = jax.jit(rtr.make_global_round())
        step = jnp.zeros((), jnp.int32)
        rlosses = []
        for b in batches:
            rp, ro, m, step = round_fn(
                rp, ro, {k: jnp.asarray(v) for k, v in b.items()}, step)
            rlosses.append(float(m["loss"]))
    with lm.single_rank_world("gloo", "cpu") as tmesh:
        ttr = ts.ShardedCEFedAvg(texp, tmesh)
        assert ttr.geo.num_replicas == 1 and ttr.replica == 0
        params = tree_from_numpy(tr.tree_map(lambda a: a[0], host))
        opt = ttr.opt_init(params)
        round_fn = ttr.make_global_round()
        step, tlosses = 0, []
        for b in batches:
            params, opt, m, step = round_fn(params, opt, b, step)
            tlosses.append(m["loss"])
    assert step == int(rtr.fl.q * rtr.fl.tau * len(batches))
    np.testing.assert_allclose(tlosses, rlosses, atol=TOL, rtol=0)
    gap = _gap([t.numpy() for t in tr.tree_leaves(params)],
               [a[0] for a in jax.tree.leaves(jax.device_get(rp))])
    print(f"{texp.model.name}, world of one: max abs gap to the reference "
          f"trainer {gap:.3e}")
    assert gap < TOL
    mu = _gap([t.numpy() for t in tr.tree_leaves(opt["mu"])],
              [a[0] for a in jax.tree.leaves(jax.device_get(ro["mu"]))])
    assert mu < TOL
    return host


def test_world_of_one_matches_reference_trainer():
    """The port's trainer in a world of one against the reference's on a
    1 x 1 mesh: 2 rounds of SGD with momentum 0.9, params and loss."""
    from repro_torch.data.lm import synthetic_lm_batch
    name = "simulator"
    texp = _sgd_momentum(cases.lm_experiment("repro_torch", name))
    batches = [synthetic_lm_batch((2, 2, 1, 2, 16),
                                  texp.model.vocab_size, seed=s)
               for s in (1, 2)]
    _world_of_one(_sgd_momentum(cases.lm_experiment("repro", name)), texp,
                  batches)


#: the families' worlds of one: arch -> ``reduced`` overrides (mixtral's
#: capacity binds: both rounds drop assignments)
FAMILY_WORLDS = {"mixtral-8x7b": dict(capacity_factor=0.5),
                 "whisper-medium": {}}


@pytest.mark.parametrize("arch", sorted(FAMILY_WORLDS))
def test_world_of_one_families_match_reference_trainer(arch):
    """The MoE (binding capacity) and encoder-decoder (the ``frames``
    batch key) families through both trainers: 2 rounds of SGD with
    momentum 0.9 at lr 0.05, loss, params and ``mu`` within TOL."""
    from repro.config import ExperimentConfig as RExp
    from repro.configs import get_model_config as rcfg
    from repro_torch.config import ExperimentConfig as TExp
    from repro_torch.configs import get_model_config as tcfg
    from repro_torch.data.lm import synthetic_lm_batch
    from repro_torch.models import model as tm
    kw = FAMILY_WORLDS[arch]
    fl = dict(num_clusters=1, devices_per_cluster=1, tau=2, q=2, pi=2)
    rexp = _sgd_momentum(RExp(model=rcfg(arch).reduced(**kw)))
    rexp = dataclasses.replace(rexp, fl=dataclasses.replace(rexp.fl, **fl))
    texp = _sgd_momentum(TExp(model=tcfg(arch).reduced(**kw)))
    texp = dataclasses.replace(texp, fl=dataclasses.replace(texp.fl, **fl))
    cfg = texp.model
    lead = (fl["q"], fl["tau"], 1, 2)
    batches = []
    for s in (1, 2):
        b = synthetic_lm_batch(lead + (16,), cfg.vocab_size, seed=s)
        if cfg.family == "encdec":
            b["frames"] = (np.random.default_rng(s).standard_normal(
                lead + (cfg.encoder_seq, cfg.d_model)) * 0.02
            ).astype(np.float32)
        batches.append(b)
    host = _world_of_one(rexp, texp, batches)
    if cfg.family == "moe":
        params = tree_from_numpy(tr.tree_map(lambda a: a[0], host))
        for b in batches:
            drops = []
            tm.forward(cfg, params, {k: v[0, 0, 0] for k, v in b.items()},
                       drops=drops)
            assert len(drops) == cfg.num_layers
            assert sum(int(d) for d in drops) > 0, drops


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_abstract_shapes_match_reference(arch):
    """The stacked shapes and dtypes of every registered arch against the
    reference's ``stacked_abstract``, and one replica's against them."""
    from repro.configs import get_model_config as rcfg
    from repro_torch.configs import get_model_config as tcfg
    shapes, _ = r_stacked(rcfg(arch), 4)
    got = ts.stacked_abstract(tcfg(arch), 4)
    assert all(t.is_meta for t in tr.tree_leaves(got))
    exp = jax.tree.leaves(shapes)
    assert len(exp) == len(tr.tree_leaves(got))
    for t, s in zip(tr.tree_leaves(got), exp):
        assert tuple(t.shape) == s.shape
        assert str(t.dtype).removeprefix("torch.") == str(s.dtype)
    one = ts.abstract_model(tcfg(arch))
    assert [tuple(t.shape) for t in tr.tree_leaves(one)] == \
        [s.shape[1:] for s in exp]


def test_replica_seeds_differ_and_repeat():
    seeds = [ts.replica_seed(0, r) for r in range(8)]
    assert len(set(seeds)) == 8 and seeds == [ts.replica_seed(0, r)
                                              for r in range(8)]
    assert ts.replica_seed(1, 0) not in seeds
    cfg = cases.lm_experiment("repro_torch", "simulator").model
    from repro_torch.models import model as tm
    a = tm.init_model(torch.Generator().manual_seed(seeds[0]), cfg, "cpu")
    b = tm.init_model(torch.Generator().manual_seed(seeds[0]), cfg, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(tr.tree_leaves(a),
                                                 tr.tree_leaves(b)))
