"""Rank-side code of the tensor-parallel tests
(``tests/test_torch_tensor_parallel*.py``): imports the port only, so
the gloo ranks that ``launch.mesh.run_local_ranks`` spawns never import
JAX.

A *round job* trains one reduced family config for ``ROUNDS`` global
rounds (SGD with momentum 0.9 at lr 0.05, tau 2, q 2, pi 2) on a
``data x model`` rank mesh from given replicas (the reference's init, a
host tree with a leading replica axis), each rank cutting its slice; a
*grad job* takes ``lm_loss`` and its gradients of one replica at
``model`` ranks. Each returns, from each replica's model rank 0, the
gathered whole trees."""
import importlib

import numpy as np
import torch

#: reduced widths; mixtral's capacity binds (both rounds drop), as in
#: tests/test_torch_sharded_lm.py
FAMILIES = {
    "dense": ("qwen2-0.5b", {}),
    # 4 query heads padded to 8 (two inert slots a kv group of 4)
    "dense_padded": ("qwen2-0.5b", {"head_pad_to": 8}),
    "moe": ("mixtral-8x7b", {"capacity_factor": 0.5}),
    "moe_shared": ("llama4-maverick-400b-a17b", {}),
    "ssm": ("mamba2-2.7b", {}),
    "hybrid": ("zamba2-2.7b", {}),
    "encdec": ("whisper-medium", {}),
    "vlm": ("pixtral-12b", {}),
}
ROUNDS = 2
B, S = 2, 16
FL = dict(tau=2, q=2, pi=2)


def experiment(pkg: str, family: str, dp: int):
    """The family's reduced ExperimentConfig in package ``pkg`` for ``dp``
    replicas (the launcher's clusters: max(1, dp // 2))."""
    cfg = importlib.import_module(pkg + ".config")
    configs = importlib.import_module(pkg + ".configs")
    arch, kw = FAMILIES[family]
    m = max(1, dp // 2)
    return cfg.ExperimentConfig(
        model=configs.get_model_config(arch).reduced(**kw),
        fl=cfg.FLConfig(num_clusters=m, devices_per_cluster=dp // m, **FL),
        train=cfg.TrainConfig(optimizer="sgd", learning_rate=0.05,
                              momentum=0.9))


def batch(family: str, lead: tuple, seed: int) -> dict:
    """Tokens and labels ``lead + (S,)`` plus encdec frames or vlm patch
    embeddings (seeded normals x 0.02, f32), as numpy."""
    from repro_torch.configs import get_model_config
    from repro_torch.data.lm import synthetic_lm_batch
    arch, kw = FAMILIES[family]
    cfg = get_model_config(arch).reduced(**kw)
    out = synthetic_lm_batch(tuple(lead) + (S,), cfg.vocab_size, seed=seed)
    extra = {"encdec": ("frames", cfg.encoder_seq),
             "vlm": ("patch_embeds", cfg.num_patches)}.get(cfg.family)
    if extra is not None:
        out[extra[0]] = (np.random.default_rng(seed).standard_normal(
            tuple(lead) + (extra[1], cfg.d_model)) * 0.02).astype(np.float32)
    return out


def round_batches(family: str, dp: int) -> list:
    return [batch(family, (FL["q"], FL["tau"], dp, B), seed=s)
            for s in range(1, ROUNDS + 1)]


def _host(tree):
    from repro_torch import tree as tr
    return tr.tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _keep_recorder():
    """Record every MoE layer's kept-assignment mask (the global one, in
    sorted order) as the port computes it."""
    from repro_torch.models import moe
    seen, orig = [], moe._local_slots

    def spy(p, cfg, e_sorted, pos_in_e, keep, cap, tp):
        seen.append(keep.detach().cpu().numpy().copy())
        return orig(p, cfg, e_sorted, pos_in_e, keep, cap, tp)
    return seen, spy, orig


def _mesh(meshes: dict, dp: int, mp: int):
    from repro_torch.launch.mesh import make_replica_mesh
    if (dp, mp) not in meshes:
        meshes[(dp, mp)] = make_replica_mesh(dp, model=mp, device="cpu")
    return meshes[(dp, mp)]


def round_job(meshes: dict, family: str, dp: int, mp: int, init) -> dict:
    """``ROUNDS`` rounds of the family on a ``dp x mp`` mesh from the
    replicas ``init``: losses, the kept MoE assignments, the model-group
    traffic, and (model rank 0) the replica's whole params and ``mu``."""
    from repro_torch import tree as tr
    from repro_torch.convert import tree_from_numpy
    from repro_torch.core.sharded import ShardedCEFedAvg
    from repro_torch.models import moe
    mesh = _mesh(meshes, dp, mp)
    trn = ShardedCEFedAvg(experiment("repro_torch", family, dp), mesh)
    params = trn.shard(tree_from_numpy(
        tr.tree_map(lambda a: a[trn.replica], init)))
    opt = trn.opt_init(params)
    round_fn = trn.make_global_round()
    seen, spy, orig = _keep_recorder()
    mesh.reset_traffic()
    losses, step = [], 0
    moe._local_slots = spy
    try:
        for b in round_batches(family, dp):
            params, opt, metrics, step = round_fn(params, opt, b, step)
            losses.append(metrics["loss"])
    finally:
        moe._local_slots = orig
    whole, mu = trn.gather(params), trn.gather(opt["mu"])
    lead = mesh.model_index == 0
    return {"replica": trn.replica, "losses": losses, "keep": seen,
            "traffic": mesh.traffic_by_group(),
            "params": _host(whole) if lead else None,
            "mu": _host(mu) if lead else None}


def grad_job(meshes: dict, family: str, mp: int, init) -> dict:
    """``lm_loss`` and its gradients (gathered whole) of replica 0 of
    ``init`` on one batch, at ``mp`` model ranks."""
    from repro_torch import tree as tr
    from repro_torch.convert import tree_from_numpy
    from repro_torch.core.sharded import ShardedCEFedAvg
    from repro_torch.models import model as mdl
    mesh = _mesh(meshes, 1, mp)
    trn = ShardedCEFedAvg(experiment("repro_torch", family, 1), mesh)
    params = trn.shard(tree_from_numpy(tr.tree_map(lambda a: a[0], init)))
    leaves, treedef = tr.tree_flatten(params)
    live = [t.requires_grad_(True) for t in leaves]
    b = {k: torch.from_numpy(v) for k, v in
         batch(family, (B,), seed=11).items()}
    loss = mdl.lm_loss(trn.model_cfg, tr.tree_unflatten(treedef, live), b,
                       tp=trn.tp)
    grads = trn.gather(tr.tree_unflatten(
        treedef, list(torch.autograd.grad(loss, live))))
    return {"loss": float(loss.detach()),
            "grads": _host(grads) if mesh.model_index == 0 else None}


def shard_round_trip(meshes: dict, family: str, mp: int, init) -> bool:
    """``shard_tree`` then ``gather_tree`` gives back the whole tree, bit
    for bit, and each slice is the spec's part of it."""
    from repro_torch import tree as tr
    from repro_torch.convert import tree_from_numpy
    from repro_torch.core.sharded import ShardedCEFedAvg
    mesh = _mesh(meshes, 1, mp)
    trn = ShardedCEFedAvg(experiment("repro_torch", family, 1), mesh)
    whole = tree_from_numpy(tr.tree_map(lambda a: a[0], init))
    mine = trn.shard(whole)
    back = trn.gather(mine)
    smaller = sum(a.numel() < b.numel() for a, b in
                  zip(tr.tree_leaves(mine), tr.tree_leaves(whole)))
    return smaller > 0 and all(
        torch.equal(a, b) for a, b in zip(tr.tree_leaves(back),
                                          tr.tree_leaves(whole)))


def tp_world(jobs: list) -> list:
    """Run ``jobs`` in order on this rank: ``("round", family, dp, mp,
    init)``, ``("grad", family, mp, init)`` or ``("round_trip", family,
    mp, init)``."""
    meshes: dict = {}
    run = {"round": round_job, "grad": grad_job,
           "round_trip": shard_round_trip}
    return [run[kind](meshes, *args) for kind, *args in jobs]
