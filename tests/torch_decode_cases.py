"""Rank-side code of ``tests/test_torch_decode_tp.py``: imports the port
only, so the gloo ranks that ``launch.mesh.run_local_ranks`` spawns never
import JAX.

Every job builds its reduced f32 config's whole parameters and decode
cache from fixed seeds (the same on every rank and in the test process,
which computes the unsplit references), cuts the rank's part as
``core.sharded.serve_specs`` places it on a ``data x model`` mesh, and
returns the whole result from rank 0."""
import numpy as np
import torch

from torch_tp_cases import FAMILIES

#: decode steps from position 0 into a cache of CACHE positions
STEPS, CACHE = 4, 8
#: attn_seq_shard's config: 3 query heads and 1 kv head, which no model
#: group of 2 splits, over SEQ positions a row
SEQ_SHARD = {"num_heads": 3, "num_kv_heads": 1, "attn_seq_shard": True}
SEQ = 16


def config(family: str, **kw):
    from repro_torch.configs import get_model_config
    arch, fam_kw = FAMILIES[family]
    return get_model_config(arch).reduced(**fam_kw, **kw)


def whole_params(cfg):
    from repro_torch.models import model as mdl
    return mdl.init_model(torch.Generator().manual_seed(0), cfg, "cpu")


def whole_cache(cfg, batch: int):
    """A fresh cache; an encdec model's cross caches seeded normals (the
    encoder's keys and values stand-ins)."""
    from repro_torch.models import model as mdl
    cache = mdl.init_decode_cache(cfg, batch, CACHE, device="cpu")
    rng = np.random.default_rng(3)
    for k in ("xk", "xv"):
        if k in cache:
            cache[k] = torch.from_numpy(rng.standard_normal(
                tuple(cache[k].shape)).astype(np.float32))
    return cache


def tokens(cfg, batch: int) -> np.ndarray:
    return np.random.default_rng(5).integers(0, cfg.vocab_size,
                                             (STEPS, batch, 1))


def decode(cfg, params, cache, toks, tp=None, sp=None, gather=None):
    """STEPS decode steps: (STEPS, B, 1, vocab) logits."""
    from repro_torch.models import model as mdl
    out = []
    for t in range(STEPS):
        logits, cache = mdl.decode_step(cfg, params, cache,
                                        torch.from_numpy(toks[t]), t, tp=tp,
                                        sp=sp)
        out.append((gather(logits) if gather else logits).numpy())
    return np.stack(out)


def seq_batch():
    from repro_torch.data.lm import synthetic_lm_batch
    cfg = config("dense", **SEQ_SHARD)
    return {k: torch.from_numpy(v) for k, v in
            synthetic_lm_batch((2, SEQ), cfg.vocab_size, seed=9).items()}


def loss_and_grads(cfg, params, batch, tp=None):
    from repro_torch import tree as tr
    from repro_torch.models import model as mdl
    leaves, treedef = tr.tree_flatten(params)
    live = [t.requires_grad_(True) for t in leaves]
    loss = mdl.lm_loss(cfg, tr.tree_unflatten(treedef, live), batch, tp=tp)
    return loss, tr.tree_unflatten(treedef,
                                   list(torch.autograd.grad(loss, live)))


def _mesh(meshes: dict, dp: int, mp: int):
    from repro_torch.launch.mesh import make_replica_mesh
    if (dp, mp) not in meshes:
        meshes[(dp, mp)] = make_replica_mesh(dp, model=mp, device="cpu")
    return meshes[(dp, mp)]


def decode_job(meshes: dict, family: str, dp: int, mp: int, batch: int):
    """The family's decode on a ``dp x mp`` mesh: the rank's slices of
    the params, its part of the cache (kv positions over ``data`` when
    ``batch`` does not divide it), its rows of the tokens; rank 0's
    logits, whole (the model group's vocabulary columns joined), and
    the traffic by group."""
    from repro_torch import sharding as sh
    from repro_torch.core import collectives as col
    from repro_torch.core.sharded import serve_specs
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.model import padded_vocab
    mesh = _mesh(meshes, dp, mp)
    cfg = config(family)
    _, pspecs, _, cspecs = serve_specs(
        cfg, make_mesh((dp, mp), ("data", "model")), batch, CACHE)
    params = sh.shard_tree(whole_params(cfg), pspecs, mesh)
    cache = sh.shard_tree(whole_cache(cfg, batch), cspecs, mesh)
    toks = tokens(cfg, batch)
    sp = None
    if batch % dp:
        sp = col.SequenceSplit(mesh)
    else:
        rows = batch // dp
        toks = toks[:, mesh.data_index * rows:(mesh.data_index + 1) * rows]
    tp = col.ModelParallel(mesh) if mp > 1 else None

    def gather(logits):
        if logits.shape[-1] == padded_vocab(cfg):
            return logits
        return torch.cat(col.model_all_gather(logits, mesh), dim=-1)
    mesh.reset_traffic()
    out = decode(cfg, params, cache, toks, tp, sp, gather)
    return {"logits": out if mesh.rank == 0 else None,
            "traffic": mesh.traffic_by_group()}


def seq_shard_job(meshes: dict, mp: int):
    """``lm_loss`` and its gradients (gathered whole) of the
    ``SEQ_SHARD`` config at ``mp`` model ranks: rank 0's, and the
    traffic of the loss and its gradients."""
    from repro_torch import sharding as sh
    from repro_torch import tree as tr
    from repro_torch.core import collectives as col
    from repro_torch.models import model as mdl
    mesh = _mesh(meshes, 1, mp)
    cfg = config("dense", **SEQ_SHARD)
    whole = whole_params(cfg)
    specs = sh.resolve_specs(whole, mdl.logical_axes(cfg), mesh)
    mesh.reset_traffic()
    loss, grads = loss_and_grads(cfg, sh.shard_tree(whole, specs, mesh),
                                 seq_batch(), col.ModelParallel(mesh))
    traffic = mesh.traffic_by_group()
    grads = col.gather_tree(grads, specs, mesh)
    return {"loss": float(loss.detach()), "traffic": traffic,
            "grads": (tr.tree_map(lambda t: t.numpy(), grads)
                      if mesh.rank == 0 else None)}


def world(jobs: list) -> list:
    """Run ``jobs`` in order on this rank: ``("decode", family, dp, mp,
    batch)`` or ``("seq_shard", mp)``."""
    meshes: dict = {}
    run = {"decode": decode_job, "seq_shard": seq_shard_job}
    return [run[kind](meshes, *args) for kind, *args in jobs]
