"""Rank-side halves of the port's multi-rank tests
(``test_torch_collectives.py``, ``test_torch_groups.py``,
``test_torch_sharded_bank.py``, ``test_torch_sharded_lm.py``,
``test_torch_sharded_streamed.py``).

Each test file spawns ONE gloo world of 8 ranks (4 for the sharded
streamed bank) on the CPU for its module
(``repro_torch.launch.mesh.run_local_ranks``, one intra-op thread a rank,
a free port) and runs one of the ``*_world`` functions below on every
rank. They import the port only (no JAX: the ranks start from a fresh
import) and return host arrays, by case, that the test process compares
with the reference and with dense numpy operators. The configurations
are plain dicts, built into either package's objects by :func:`build`.
"""
from __future__ import annotations

import dataclasses
import importlib
import os
import time

import numpy as np
import torch

NDEV = 8
LR, BATCH = 0.1, 16

FL = dict(algorithm="ce_fedavg", num_clusters=4, devices_per_cluster=2,
          tau=2, q=2, pi=4, topology="ring")
FL3 = dict(FL, pi=2, hierarchy=(2, 2, 2))
#: lognormal speeds + mobility + sampling (0.5 of each 2-device cluster:
#: every round has a partial cohort)
SAMPLED = dict(name="t", speed_dist="lognormal", speed_spread=0.6,
               sample_fraction=0.5, move_prob=0.3, seed=7)

#: name -> (FLConfig kwargs, rounds, options); the reference's own cases
#: (tests/test_sharded_bank.py) and the port's scenario, fault, int8 and
#: async ones
CASES = {
    "static": (FL, 3, {}),
    "scenario": (FL, 4, {"scenario": SAMPLED}),
    "mobile_chaos": (FL, 3, {"scenario": "mobile_sampled",
                             "faults": "chaos"}),
    "int8_ef": (FL, 2, {"compression": dict(kind="int8")}),
    "fedavg": (dict(algorithm="fedavg", num_clusters=1,
                    devices_per_cluster=8, tau=2, q=2, pi=2), 1, {}),
    "hier_favg": (dict(algorithm="hier_favg", num_clusters=4,
                       devices_per_cluster=2, tau=2, q=2, pi=2), 1, {}),
    "local_edge": (dict(algorithm="local_edge", num_clusters=4,
                        devices_per_cluster=2, tau=2, q=2, pi=2), 1, {}),
    "dec_local_sgd": (dict(algorithm="dec_local_sgd", num_clusters=8,
                           devices_per_cluster=1, tau=2, q=2, pi=2), 1, {}),
    "pods2": (FL, 2, {"pods": 2}),
    "depth3": (FL3, 3, {}),
    "depth3_scenario": (FL3, 3, {"scenario": SAMPLED}),
    "adaptive_tau": (dict(FL, tau=4), 2, {
        "scenario": dict(name="t", speed_dist="lognormal",
                         speed_spread=0.6, seed=9),
        "schedule": "adaptive_tau"}),
    "pi_decay": (FL, 3, {"schedule": "pi_decay"}),
    "async_s2": (FL, 2, {"scenario": "lognormal", "staleness": 2}),
}


def build(pkg: str, name: str):
    """(FLConfig, simulator kwargs) of case ``name`` in package ``pkg``
    (``"repro"`` or ``"repro_torch"``)."""
    cfg = importlib.import_module(pkg + ".config")
    scn = importlib.import_module(pkg + ".core.scenario")
    fl_kw, _, opt = CASES[name]
    kw = {"lr": LR, "batch_size": BATCH, "seed": 0}
    sc = opt.get("scenario")
    if isinstance(sc, dict):
        kw["scenario"] = cfg.ScenarioConfig(**sc)
    elif sc is not None:
        kw["scenario"] = scn.get_scenario(sc)
    if "faults" in opt:
        kw["scenario"] = dataclasses.replace(
            kw["scenario"], faults=scn.get_faults(opt["faults"]))
    if "schedule" in opt:
        kw["schedule"] = opt["schedule"]
    if "compression" in opt:
        cmp = importlib.import_module(pkg + ".core.compress")
        kw["compression"] = cmp.CompressionConfig(**opt["compression"])
    return cfg.FLConfig(**fl_kw), kw


def fl_data(n: int):
    """The reference's test data (tests/test_sharded_bank.py ``_data``)."""
    from repro_torch.data.federated import (build_fl_data,
                                            dirichlet_partition,
                                            make_synthetic_classification)
    x, y = make_synthetic_classification(800, 16, 4, seed=3)
    tx, ty = make_synthetic_classification(200, 16, 4, seed=4)
    parts = dirichlet_partition(y, n, alpha=0.5, seed=5)
    return build_fl_data(x, y, parts, tx, ty, samples_per_device=64)


def run_case(sim, name: str, rt=None, after_round=None):
    """Drive case ``name``'s rounds; returns the per-round plans' masks
    and labels (None without a scenario)."""
    _, rounds, opt = CASES[name]
    plans = []
    for r in range(rounds):
        if "staleness" in opt:
            plan = sim.step_round_async(opt["staleness"], rt)
        else:
            plan = sim.step_round()
        plans.append(None if plan is None else
                     (np.asarray(plan.mask), np.asarray(plan.labels)))
        if after_round is not None:
            after_round(r)
    return plans


def chip_smoke():
    """``chip_smoke.py`` loaded as a module (its card oracles run on the
    CPU too)."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _host(t):
    return None if t is None else t.detach().cpu().numpy().copy()


# ---------------------------------------------------------------------------
# the sharded bank world
# ---------------------------------------------------------------------------

def _sharded(init, name: str, meshes: dict, **extra):
    """Case ``name``'s sharded sim on the world's mesh of its pod count
    (``meshes``: pods -> mesh, made on first use and reused, so each
    partition's subgroups are made once)."""
    from repro_torch.convert import tree_from_numpy
    from repro_torch.core.sharded import ShardedBankCEFedAvg
    from repro_torch.launch.mesh import make_replica_mesh
    from repro_torch.models.cnn import apply_mlp_classifier
    fl, kw = build("repro_torch", name)
    kw.update(extra)
    pods = CASES[name][2].get("pods", 1)
    if pods not in meshes:
        meshes[pods] = make_replica_mesh(NDEV, pods=pods, device="cpu")
    return ShardedBankCEFedAvg(lambda g: tree_from_numpy(init),
                               apply_mlp_classifier, fl, fl_data(fl.n),
                               meshes[pods], **kw)


def _bank_rows(sim) -> dict:
    b = sim.bank
    return {"params": _host(b.params), "mom": _host(b.mom),
            "residual": _host(b.residual),
            "shapes": [tuple(t.shape) for t in (b.params, b.mom, b.residual)
                       if t is not None],
            "key": np.asarray(sim.key).copy()}


def sharded_bank_world(init, tmpdir: str, ref_ckpt: str, port_ckpt: str):
    """Every case of ``CASES`` on this rank, the structural checks, kill
    and resume, the checkpoint crossings and the launcher's rank
    function; returns ``{case: result}`` for this rank."""
    from repro_torch.core.modelbank import ModelBank
    from repro_torch.core.runtime import compute_bound_runtime_model
    rt = compute_bound_runtime_model()
    meshes: dict = {}
    out = {}
    for name in CASES:
        # init never builds the full bank on one device
        orig = ModelBank.from_model
        ModelBank.from_model = _forbidden
        try:
            sim = _sharded(init, name, meshes)
        finally:
            ModelBank.from_model = orig
        mesh = sim.mesh
        traffic = []

        def snap(_r, mesh=mesh):
            traffic.append({k: dict(v) for k, v in mesh.traffic.items()})
            mesh.reset_traffic()
        mesh.reset_traffic()
        plans = run_case(sim, name, rt, snap)
        res = _bank_rows(sim)
        res.update(plans=plans, traffic=traffic,
                   lowered=len(sim._lowered),
                   tau_dev=(None if sim.last_program is None
                            or not sim.last_program.adaptive
                            else np.asarray(sim.last_program.tau_dev)),
                   eval=sim.evaluate(128), global_row=_host(
                       sim.layout.flatten_one(sim.global_model())),
                   T=sim.layout.total, rows=(sim.bank.rows.start,
                                             sim.bank.rows.stop))
        if name in ("static", "depth3"):
            res["gossip_bound"] = _boundary_bound(sim)
        out[name] = res
    out["guards"] = _guards(init, meshes[1])
    out["resume"] = _kill_and_resume(init, tmpdir, rt, meshes)
    out["ckpt"] = _checkpoint_crossings(init, tmpdir, ref_ckpt, port_ckpt,
                                        meshes)
    out["launcher"] = _launcher(tmpdir)
    return out


def _forbidden(*a, **kw):
    raise AssertionError("sharded init must not build the full bank on "
                         "one device")


def _boundary_bound(sim) -> int:
    """Models a rank may receive at the static round's fused boundary:
    ``models_received_per_replica`` of each gossip schedule its lowering
    runs (once a round: the canonical program's last block)."""
    from repro_torch.core import program as prg
    plans = prg.lowering_plan(sim._canonical, fuse=True)
    total = 0
    for g in plans[-1].groups:
        for op in g.ops:
            if op.level >= 1 and sim.registry.hier.num_siblings(op.level) > 1:
                total += sim.registry.gossip_schedule(
                    op.level, op.pi).models_received_per_replica()
    return total


def _guards(init, mesh) -> dict:
    """The engine's preconditions, as the messages they raise."""
    from repro_torch.config import FLConfig
    from repro_torch.convert import tree_from_numpy
    from repro_torch.core.sharded import ShardedBankCEFedAvg
    from repro_torch.launch.mesh import make_replica_mesh
    from repro_torch.models.cnn import apply_mlp_classifier
    out = {}
    calls = {
        "n_mismatch": dict(fl=FLConfig(num_clusters=2,
                                       devices_per_cluster=2)),
        "streaming": dict(fl=FLConfig(**FL), streaming=True),
        "device": dict(fl=FLConfig(**FL), device="meta"),
    }
    for what, kw in calls.items():
        fl = kw.pop("fl")
        try:
            ShardedBankCEFedAvg(lambda g: tree_from_numpy(init),
                                apply_mlp_classifier, fl, fl_data(fl.n),
                                mesh, **kw)
            out[what] = "no error"
        except (ValueError, NotImplementedError) as e:
            out[what] = f"{type(e).__name__}: {e}"
    try:
        make_replica_mesh(4, device="cpu")
        out["world"] = "no error"
    except RuntimeError as e:
        out["world"] = str(e)
    return out


def _kill_and_resume(init, tmpdir: str, rt, meshes) -> dict:
    """3 rounds through ``run_wall_clock`` against 2 + checkpoint + a
    fresh sim restored + 1, bit for bit: under ``mobile_sampled`` with
    ``chaos`` faults and int8+EF uploads, and async at s = 2."""
    from repro_torch.core.clock import run_wall_clock
    from repro_torch.core.compress import CompressionConfig
    out = {}
    for what, kw, s in (
            ("int8_ef_chaos", dict(compression=CompressionConfig("int8")),
             None),
            ("async_s2", {}, 2)):
        def make():
            return _sharded(init, "mobile_chaos", meshes, **kw)
        d = os.path.join(tmpdir, f"resume-{what}")
        full = make()
        h_full = run_wall_clock(full, rt, 3, eval_batch=128,
                                async_staleness=s)
        killed = make()
        run_wall_clock(killed, rt, 2, eval_batch=128, async_staleness=s,
                       ckpt_dir=d, ckpt_every=2)
        resumed = make()
        h_res = run_wall_clock(resumed, rt, 3, eval_batch=128,
                               async_staleness=s, ckpt_dir=d, ckpt_every=4,
                               resume=True)
        a, b = _bank_rows(full), _bank_rows(resumed)
        keep = [c for c in h_full if c not in ("page_s", "compute_s",
                                               "eval_s")]
        out[what] = {
            "bitwise": all(np.array_equal(a[k], b[k])
                           for k in ("params", "mom", "residual", "key")
                           if a[k] is not None),
            "hist": all(h_full[c] == h_res[c] for c in keep),
            "rounds": len(h_res["round"])}
    return out


def _checkpoint_crossings(init, tmpdir: str, ref_ckpt: str,
                          port_ckpt: str, meshes) -> dict:
    """A sharded run's checkpoint (rows gathered to rank 0, which writes),
    and the other direction: the reference's and the single-process
    port's checkpoints restored into sharded sims, each continued one
    round."""
    from repro_torch.checkpoint import RunCheckpoint
    from repro_torch.core.compress import CompressionConfig
    comp = dict(compression=CompressionConfig("int8"))
    out = {}
    sim = _sharded(init, "mobile_chaos", meshes, **comp)
    for _ in range(2):
        sim.step_round()
    d = os.path.join(tmpdir, "sharded-ckpt")
    if sim.mesh.rank == 0:
        os.makedirs(d, exist_ok=True)
    RunCheckpoint(d).save(sim, round_idx=2)
    out["saved"] = _bank_rows(sim)
    out["saved_dir"] = d
    sim.step_round()
    out["saved_next"] = _bank_rows(sim)
    for what, path in (("from_ref", ref_ckpt), ("from_port", port_ckpt)):
        sim = _sharded(init, "mobile_chaos", meshes, **comp)
        meta = RunCheckpoint(path).restore(sim)
        restored = _bank_rows(sim)
        sim.step_round()
        out[what] = {"restored": restored, "next": _bank_rows(sim),
                     "round": meta["round"]}
    return out


def _launcher(tmpdir: str) -> dict:
    """The launcher's rank function on this world: every bank flag in
    one run, 3 rounds against 2 + checkpoint + resume + 1."""
    from repro_torch.launch import train
    flags = ["--engine", "bank", "--data-parallel", "8", "--dist-backend",
             "gloo", "--device", "cpu", "--hierarchy", "2,2,2",
             "--scenario", "mobile_sampled", "--faults", "chaos",
             "--schedule", "pi_decay"]
    out = {}
    for what, extra in (("static_hier", []),
                        ("async", ["--async-staleness", "2"])):
        d = os.path.join(tmpdir, f"launcher-{what}")
        full = train.run_bank_engine(
            train._parser().parse_args(flags + extra + ["--rounds", "3"]))
        train.run_bank_engine(train._parser().parse_args(
            flags + extra + ["--rounds", "2", "--ckpt-dir", d]))
        res = train.run_bank_engine(train._parser().parse_args(
            flags + extra + ["--rounds", "3", "--ckpt-dir", d,
                             "--resume"]))
        out[what] = {"full": full, "resumed": res}
    return out


# ---------------------------------------------------------------------------
# the collectives world
# ---------------------------------------------------------------------------

def rows_of(seed: int, T: int = 37) -> np.ndarray:
    """(NDEV, T) f32 rows, one a rank, from a seed."""
    return np.random.default_rng(seed).standard_normal(
        (NDEV, T)).astype(np.float32)


def stochastic(seed: int, n: int = NDEV) -> np.ndarray:
    """A random row-stochastic (n, n) f32 operator."""
    W = np.random.default_rng(seed).random((n, n)).astype(np.float32)
    return W / W.sum(1, keepdims=True)


#: partial permutations and partitions the collectives world applies
PERMS = {
    "rot1": tuple(((d + 1) % NDEV, d) for d in range(NDEV)),
    "rot3": tuple(((d + 3) % NDEV, d) for d in range(NDEV)),
    "partial": ((0, 1), (2, 3), (6, 4)),
    "self": ((5, 5), (1, 2)),
}
PARTITIONS = {
    "halves": ((0, 1, 2, 3), (4, 5, 6, 7)),
    "pairs": ((0, 1), (2, 3), (4, 5), (6, 7)),
    "strided": ((0, 2, 4, 6), (1, 3, 5, 7)),
    "world": (tuple(range(NDEV)),),
}


def collectives_world():
    """Every collective of ``core/collectives.py`` and every lowering of
    ``core/gossip.py`` on this rank's row; returns this rank's outputs
    and traffic counts by case."""
    from repro_torch.config import FLConfig
    from repro_torch.core import collectives as col
    from repro_torch.core import gossip as gsp
    from repro_torch.core.cefedavg import make_w_schedule
    from repro_torch.launch.mesh import make_replica_mesh
    mesh = make_replica_mesh(NDEV, device="cpu")
    pods = make_replica_mesh(NDEV, pods=2, device="cpu")
    me = mesh.rank
    x = torch.from_numpy(rows_of(0)[me:me + 1])
    out = {"mesh": dict(rank=mesh.rank, replica=mesh.replica,
                        transport=mesh.transport, shape=mesh.shape,
                        axis_names=mesh.axis_names,
                        flat=(col.flat_axis_size(mesh),
                              col.flat_axis_index(mesh))),
           "pods": dict(pod=pods.pod_index, data=pods.data_index,
                        replica=pods.replica, shape=pods.shape,
                        axis_names=pods.axis_names,
                        rotate=col.rotate_perm(pods, 2))}
    for name, perm in PERMS.items():
        mesh.reset_traffic()
        out["ppermute_" + name] = (_host(col.ppermute(x, mesh, perm)),
                                   dict(mesh.traffic["ppermute"]))
    try:
        col.ppermute(x, mesh, ((0, 1), (2, 1)))
        out["bad_perm"] = "no error"
    except ValueError as e:
        out["bad_perm"] = str(e)
    for name, groups in PARTITIONS.items():
        mesh.reset_traffic()
        out["psum_" + name] = (_host(col.psum_groups(x, mesh, groups)),
                               dict(mesh.traffic["all_reduce"]))
    ngroups = len(mesh.groups)
    col.psum_groups(x, mesh, PARTITIONS["pairs"])
    out["groups_cached"] = (ngroups, len(mesh.groups))
    out["all_reduce"] = _host(col.all_reduce(x * 2, mesh))
    mesh.reset_traffic()
    out["gather"] = (col.gather_rows(x, mesh), dict(mesh.traffic["gather"]))
    col.barrier(mesh)
    # the gossip lowerings against their dense operators
    fl = FLConfig(**FL)
    H = make_w_schedule(fl).H
    for mode in ("rounds", "exact"):
        sched = gsp.GossipSchedule.build(H, fl.pi, fl.devices_per_cluster,
                                         mode=mode)
        mesh.reset_traffic()
        y = x
        if mode == "rounds":
            for _ in range(fl.pi):
                y = gsp.gossip_in_body(
                    dataclasses.replace(sched, pi=1), mesh, y)
            pi_rounds = _host(gsp.gossip_in_body(sched, mesh, x))
        else:
            y = gsp.gossip_in_body(sched, mesh, x)
            pi_rounds = None
        out["gossip_" + mode] = (_host(y), pi_rounds,
                                 dict(mesh.traffic["ppermute"]),
                                 sched.models_received_per_replica())
    W = stochastic(1)
    mesh.reset_traffic()
    out["dense_mix"] = (_host(gsp.dense_mix_rows(W, x, mesh)),
                        _host(gsp.dense_mix_rows(torch.from_numpy(W), x,
                                                 mesh)),
                        dict(mesh.traffic["ppermute"]))
    out["group_mean"] = _host(gsp.group_mean_in_body(
        mesh, x, PARTITIONS["strided"]))
    out["cluster_mean"] = _host(gsp.cluster_mean_in_body(mesh, x, 4, 2))
    tree = {"w": x.reshape(-1)[:30].reshape(5, 6).to(torch.bfloat16),
            "b": [x.reshape(-1)[30:]]}
    sched = gsp.GossipSchedule.build(H, fl.pi, fl.devices_per_cluster)
    g = gsp.apply_gossip(sched, tree, mesh)
    c = gsp.apply_cluster_mean(tree, mesh, 4, 2)
    out["tree"] = {k: (str(t["w"].dtype), _host(t["w"].float()),
                       _host(t["b"][0]))
                   for k, t in (("gossip", g), ("cluster", c),
                                ("input", tree))}
    return out


# ---------------------------------------------------------------------------
# the group registry world
# ---------------------------------------------------------------------------

def groups_world():
    """The registry at the depth-3 (2, 2, 2) preset on this rank: its
    tiers, schedules, means and gossips; returns host values by case."""
    from repro_torch.config import FLConfig
    from repro_torch.core import collectives as col
    from repro_torch.core import gossip as gsp
    from repro_torch.core.groups import GroupRegistry, get_registry
    from repro_torch.launch.mesh import make_tier_mesh
    fl = FLConfig(**FL3)
    mesh = make_tier_mesh(fl.hierarchy, device="cpu")
    t0 = time.perf_counter()
    reg = get_registry(fl, mesh)
    made = len(mesh.groups)
    out = {"build_s": time.perf_counter() - t0,
           "cached": get_registry(fl, mesh) is reg
           and len(mesh.groups) == made,
           "subgroups": made,
           "flat": col.flat_axis_size(mesh),
           "depth": reg.depth,
           "members": {t: reg.tier(t).members
                       for t in ("device", "edge", "region")},
           "tier2_is_region": reg.tier(2) is reg.tier("region"),
           "describe": reg.describe()}
    out["schedules"] = {
        lvl: (reg.gossip_schedule(lvl, fl.pi).dense_equivalent(),
              reg.mixing(lvl), reg.gossip_schedule(lvl, fl.pi).perms,
              reg.hier.node_size(lvl))
        for lvl in (1, 2)}
    out["sched_cached"] = (reg.gossip_schedule(1, fl.pi)
                           is reg.gossip_schedule(1, fl.pi))
    labels = np.repeat(np.arange(fl.num_clusters), fl.devices_per_cluster)
    phases = np.array([0, 1, 0, 2])
    adv = np.array([True, False, True, False])
    down = np.array([False, True, False, False])
    out["gated"] = {
        lvl: (reg.operator(lvl, fl.pi),
              reg.stale_operator(lvl, fl.pi, phases, 1, adv),
              gsp.staleness_mask(reg.operator(lvl, fl.pi), labels, phases,
                                 1, adv),
              reg.faulted_operator(lvl, fl.pi, down),
              gsp.fault_gate(reg.operator(lvl, fl.pi), labels, down))
        for lvl in (0, 1, 2)}
    me = mesh.rank
    x = torch.from_numpy(rows_of(0, 16)[me:me + 1])
    out["mean"] = {lvl: _host(reg.mean(x, lvl)) for lvl in range(3)}
    mesh.reset_traffic()
    out["gossip"] = {}
    for lvl in (1, 2):
        for mode in ("rounds", "exact"):
            out["gossip"][(lvl, mode)] = _host(
                reg.gossip(reg.mean(x, lvl), lvl, fl.pi, mode))
    out["in_body"] = _host(reg.gossip_in_body(reg.mean_in_body(x, 2), 2,
                                              fl.pi))
    tree = {"a": x.reshape(4, 4).to(torch.bfloat16)}
    m2 = reg.mean(tree, 2)
    out["tree_mean"] = (str(m2["a"].dtype), _host(m2["a"].float()))
    try:
        GroupRegistry(FLConfig(algorithm="ce_fedavg", num_clusters=2,
                               devices_per_cluster=2), mesh)
        out["mismatch"] = "no error"
    except ValueError as e:
        out["mismatch"] = str(e)
    return out


# ---------------------------------------------------------------------------
# the sharded LM trainer world
# ---------------------------------------------------------------------------

#: the reduced qwen2-0.5b widths of the reference's sharded tests
#: (tests/test_sharded.py): the eq. 10 oracle's model and the backends'
LM_SIM = dict(d_model=64, num_layers=2, d_ff=128, vocab_size=128)
LM_IMPL = dict(d_model=128, num_layers=2, d_ff=256, vocab_size=256)
#: name -> (model widths, FLConfig kwargs, TrainConfig kwargs, pods);
#: the reference's build(): m=4 x dpc=2, tau=2, q=2, pi=2 on a ring
LM_FL = dict(algorithm="ce_fedavg", num_clusters=4, devices_per_cluster=2,
             tau=2, q=2, pi=2, topology="ring")
LM_CASES = {
    "simulator": (LM_SIM, LM_FL, dict(learning_rate=0.02, momentum=0.0), 1),
    **{f"{algo}": (LM_SIM, dict(LM_FL, algorithm=algo, num_clusters=m,
                                devices_per_cluster=dpc),
                   dict(learning_rate=0.02, momentum=0.0), 1)
       for algo, m, dpc in [("fedavg", 1, 8), ("hier_favg", 4, 2),
                            ("local_edge", 4, 2), ("dec_local_sgd", 8, 1)]},
    **{f"{impl}_{where}": (LM_IMPL, dict(LM_FL, gossip_impl=impl,
                                         topology=topo),
                           dict(learning_rate=0.01), pods)
       for impl in ("dense", "sparse", "ringweight")
       for where, topo, pods in (("singlepod", "ring", 1),
                                 ("multipod", "ring", 2),
                                 ("star_multipod", "star", 2))
       if not (impl == "ringweight" and where != "star_multipod")},
}


def lm_batch(name: str) -> dict:
    """Case ``name``'s (q, tau, R, B, S) token batch (the reference's
    ``synthetic_lm_batch``)."""
    from repro_torch.data.lm import synthetic_lm_batch
    widths, fl, _, _ = LM_CASES[name]
    S = 16 if widths is LM_SIM else 32
    return synthetic_lm_batch((fl["q"], fl["tau"], NDEV, 2, S),
                              widths["vocab_size"])


def lm_experiment(pkg: str, name: str):
    """Case ``name``'s ExperimentConfig in package ``pkg``."""
    cfg = importlib.import_module(pkg + ".config")
    configs = importlib.import_module(pkg + ".configs")
    widths, fl, train, _ = LM_CASES[name]
    model = configs.get_model_config("qwen2-0.5b").reduced(**widths)
    return cfg.ExperimentConfig(model=model, fl=cfg.FLConfig(**fl),
                                train=cfg.TrainConfig(**train))


def _lm_round(name: str, meshes: dict, stacked=None):
    """One global round of case ``name`` on this rank: from the
    reference's replicas (``stacked``, a host tree with a leading replica
    axis) where given, else from the trainer's own ``init_fn``. Returns
    the rank's params (host), the round's loss and traffic."""
    from repro_torch.convert import tree_from_numpy
    from repro_torch.core.sharded import ShardedCEFedAvg
    from repro_torch.launch.mesh import make_replica_mesh
    from repro_torch.tree import tree_map
    _, _, _, pods = LM_CASES[name]
    if pods not in meshes:
        meshes[pods] = make_replica_mesh(NDEV, pods=pods, device="cpu")
    mesh = meshes[pods]
    tr = ShardedCEFedAvg(lm_experiment("repro_torch", name), mesh)
    if stacked is None:
        params, opt = tr.init_fn()(0)
    else:
        params = tree_from_numpy(tree_map(lambda a: a[tr.replica], stacked))
        opt = tr.opt_init(params)
    mesh.reset_traffic()
    params, opt, metrics, step = tr.make_global_round()(
        params, opt, lm_batch(name), 0)
    return {"params": tree_map(_host, params), "loss": metrics["loss"],
            "step": step,
            "traffic": {k: dict(v) for k, v in mesh.traffic.items()}}


def _lm_components(meshes: dict, stacked) -> dict:
    """The component steps (local step, intra, inter) composed by hand
    against the global round, bit for bit, on the simulator case."""
    from repro_torch.convert import tree_from_numpy
    from repro_torch.core.sharded import ShardedCEFedAvg
    from repro_torch.tree import tree_leaves, tree_map
    name = "simulator"
    tr = ShardedCEFedAvg(lm_experiment("repro_torch", name), meshes[1])
    batch = lm_batch(name)
    out = []
    for composed in (False, True):
        params = tree_from_numpy(tree_map(lambda a: a[tr.replica],
                                          stacked))
        opt = tr.opt_init(params)
        if not composed:
            params, *_ = tr.make_global_round()(params, opt, batch, 0)
        else:
            local, intra, inter = (tr.make_local_step(), tr.make_intra_fn(),
                                   tr.make_inter_fn())
            step = 0
            for qi in range(2):
                for ti in range(2):
                    mb = {k: torch.from_numpy(v[qi, ti, tr.replica])
                          for k, v in batch.items()}
                    params, opt, _, step = local(params, opt, mb, step)
                params = intra(params)
            params = inter(params)
        out.append([_host(t) for t in tree_leaves(params)])
    return {"bitwise": all(np.array_equal(a, b)
                           for a, b in zip(*out))}


def _lm_launcher(tmpdir: str) -> dict:
    """The launcher's rank function on this world: reduced qwen2-0.5b, 2
    rounds, the replica average checkpointed on rank 0."""
    from repro_torch.launch import train
    path = os.path.join(tmpdir, "lm-global.npz")
    res = train.run_pytree_engine(train._parser().parse_args(
        ["--arch", "qwen2-0.5b", "--reduced", "--rounds", "2",
         "--data-parallel", "8", "--dist-backend", "gloo", "--device", "cpu",
         "--ckpt", path]))
    return dict(res, ckpt=path)


def sharded_lm_world(stacked, tmpdir: str) -> dict:
    """Every case of ``LM_CASES`` on this rank, the component steps and
    the launcher. ``stacked``: the reference's R replicas at the
    ``LM_SIM`` widths (a host tree with a leading replica axis), which
    the cases at those widths start from; the others start from the
    port's ``init_fn``."""
    meshes: dict = {}
    out = {name: _lm_round(name, meshes, stacked
                           if LM_CASES[name][0] is LM_SIM else None)
           for name in LM_CASES}
    out["components"] = _lm_components(meshes, stacked)
    out["launcher"] = _lm_launcher(tmpdir)
    return out


# ---------------------------------------------------------------------------
# the sharded streamed bank world
# ---------------------------------------------------------------------------

SSB_RANKS = 4
#: tests/test_clientstore.py's configuration: the MLP 16-32-4 over m = 4
#: clusters of 4 data shards on a ring, tau 2, q 2, pi 2, batch 16, lr
#: 0.1, seed 1, under its mobile population of 400 (cohort 3 a cluster)
SSB_FL = dict(algorithm="ce_fedavg", num_clusters=4, devices_per_cluster=4,
              tau=2, q=2, pi=2, topology="ring")
SSB_MOBILE = dict(name="mobile", sample_fraction=0.5, dropout_prob=0.1,
                  move_prob=0.25, seed=7)
SSB_ROUNDS = 3


def ssb_data():
    from repro_torch.data.federated import (build_fl_data,
                                            dirichlet_partition,
                                            make_synthetic_classification)
    x, y = make_synthetic_classification(800, 16, 4, seed=3)
    tx, ty = make_synthetic_classification(400, 16, 4, seed=4)
    parts = dirichlet_partition(y, 16, alpha=0.5, seed=5)
    return build_fl_data(x, y, parts, tx, ty, samples_per_device=64)


def ssb_kwargs(pkg: str, codec: str = "f32") -> dict:
    """The simulator kwargs of the population runs in package ``pkg``."""
    cfg = importlib.import_module(pkg + ".config")
    sc = dataclasses.replace(
        cfg.ScenarioConfig(**SSB_MOBILE),
        population=cfg.PopulationConfig(clients_per_cluster=100,
                                        cohort_per_cluster=3, codec=codec))
    return {"lr": LR, "batch_size": BATCH, "seed": 1, "scenario": sc}


def _streamed(init, mesh, codec="f32", pipeline=False):
    from repro_torch.config import FLConfig
    from repro_torch.convert import tree_from_numpy
    from repro_torch.core.sharded import ShardedStreamedBank
    from repro_torch.models.cnn import apply_mlp_classifier
    return ShardedStreamedBank(lambda g: tree_from_numpy(init),
                               apply_mlp_classifier, FLConfig(**SSB_FL),
                               ssb_data(), mesh, pipeline=pipeline,
                               **ssb_kwargs("repro_torch", codec))


def streamed_state(sim) -> dict:
    """Global model row, edge models and round-complete store snapshot
    of a streamed sim (the sharded one's snapshot is the merged one on
    rank 0)."""
    return {"global": _host(sim.layout.flatten_one(sim.global_model())),
            "edge": _host(sim.layout.flatten_stack(sim.edge_models())),
            "store": sim._store_snapshot()}


def _streamed_run(init, mesh, codec, pipeline) -> dict:
    """SSB_ROUNDS rounds; per round the global row, the slab's buckets
    and this rank's traffic by op."""
    sim = _streamed(init, mesh, codec, pipeline)
    rounds = []
    for _ in range(SSB_ROUNDS):
        mesh.reset_traffic()
        sim.step_round()
        rounds.append({
            "global": _host(sim.layout.flatten_one(sim.global_model())),
            "S": sim.last_bucket, "k": sim.last_paging["rows_in"],
            "traffic": {k: dict(v) for k, v in mesh.traffic.items()}})
    out = streamed_state(sim)
    out.update(rounds=rounds, buckets=sim._buckets,
               peak_slab=sim.peak_slab_bytes,
               peak_rank_slab=sim.peak_rank_slab_bytes,
               T=sim.layout.total, shards=sim.store.num_shards,
               own=sim.store.snapshot()["ids"])
    return out


def sharded_streamed_world(init, tmpdir: str, ref_ckpt: str,
                           port_ckpt: str) -> dict:
    """The sharded streamed bank on this rank: serial and pipelined runs
    at f32 and int8, the two new collectives, kill and resume, the
    checkpoint crossings and the launcher's rank function."""
    from repro_torch.checkpoint import RunCheckpoint
    from repro_torch.core import collectives as col
    from repro_torch.launch.mesh import make_replica_mesh
    mesh = make_replica_mesh(SSB_RANKS, device="cpu")
    out = {"runs": {(codec, pipe): _streamed_run(init, mesh, codec, pipe)
                    for codec in ("f32", "int8") for pipe in (False, True)}}
    # the collectives on seeded rows
    me = mesh.rank
    x = torch.from_numpy(np.random.default_rng(me).standard_normal(
        (2 * SSB_RANKS, 5)).astype(np.float32))
    mesh.reset_traffic()
    rs = _host(col.reduce_scatter(x, mesh))
    counts = np.random.default_rng(11).integers(0, 3, (SSB_RANKS,
                                                       SSB_RANKS))
    send = torch.arange(int(counts[me].sum()) * 3, dtype=torch.int64
                        ).reshape(-1, 3) + 1000 * me
    got = _host(col.exchange_rows(send, counts[me], counts[:, me], mesh))
    out["collectives"] = {"reduce_scatter": rs, "exchange": got,
                          "counts": counts,
                          "traffic": {k: dict(v)
                                      for k, v in mesh.traffic.items()}}
    # kill and resume, pipelined at int8: 3 rounds against 2 + save + a
    # fresh sim restored + 1
    d = os.path.join(tmpdir, "ssb-resume")
    full = _streamed(init, mesh, "int8", True)
    killed = _streamed(init, mesh, "int8", True)
    for _ in range(SSB_ROUNDS):
        full.step_round()
    for _ in range(SSB_ROUNDS - 1):
        killed.step_round()
    RunCheckpoint(d).save(killed, round_idx=SSB_ROUNDS - 1)
    resumed = _streamed(init, mesh, "int8", True)
    meta = RunCheckpoint(d).restore(resumed)
    resumed.step_round()
    out["resume"] = {"full": streamed_state(full),
                     "resumed": streamed_state(resumed),
                     "round": meta["round"], "engine": meta["engine"],
                     "key": (np.asarray(full.key).copy(),
                             np.asarray(resumed.key).copy())}
    # checkpoints across: this world's (serial f32 after 1 round) and the
    # single-process engines' of both packages, each continued one round
    sim = _streamed(init, mesh)
    sim.step_round()
    d = os.path.join(tmpdir, "ssb-ckpt")
    RunCheckpoint(d).save(sim, round_idx=1)
    saved = streamed_state(sim)
    sim.step_round()
    out["ckpt"] = {"dir": d, "saved": saved, "next": streamed_state(sim)}
    for what, path in (("from_ref", ref_ckpt), ("from_port", port_ckpt)):
        sim = _streamed(init, mesh)
        RunCheckpoint(path).restore(sim)
        restored = streamed_state(sim)
        sim.step_round()
        out["ckpt"][what] = {"restored": restored,
                             "next": streamed_state(sim)}
    out["launcher"] = _population_launcher(tmpdir)
    return out


def _population_launcher(tmpdir: str) -> dict:
    """The population launcher's rank function on this world: 3 rounds
    against 2 + checkpoint + resume + 1, pipelined at int8."""
    from repro_torch.launch import train
    flags = ["--population", "400", "--data-parallel", str(SSB_RANKS),
             "--dist-backend", "gloo", "--device", "cpu", "--cohort", "3",
             "--codec", "int8", "--pipeline"]
    d = os.path.join(tmpdir, "ssb-launcher")

    def run(extra):
        return train.run_population_engine(train._parser().parse_args(
            flags + extra))
    full = run(["--rounds", "3"])
    run(["--rounds", "2", "--ckpt-dir", d])
    return {"full": full,
            "resumed": run(["--rounds", "3", "--ckpt-dir", d, "--resume"])}
