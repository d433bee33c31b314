"""Training the port's language models on the CPU: ``lm_loss`` gradients
of every reduced family's arch against ``jax.grad`` of the reference's
``lm_loss`` (f32, within 1e-5: sums in another order over a few layers),
without and with ``remat`` (the reference's ``jax.checkpoint`` of each
layer body; the port's ``torch.utils.checkpoint``), and the port's
gradients with ``remat`` equal to those without, bit for bit, for every
family. The reference's parameters cross with ``repro_torch.convert``;
batches come from numpy seeds.

Each family's own part of the training path is asserted where it is
checked: the MoE archs run at a capacity that binds (``BINDING``), drop
assignments, and drop the reference's (the same experts an assignment,
the same recency rule), with the aux loss and its router gradient held
on their own; whisper's cross-attention and encoder weights get their
gradients through the encoder output; pixtral's loss is over the text
positions only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as r_config
from repro.models import model as rm
from repro.models import moe as rmoe
from repro_torch import tree as tr
from repro_torch.configs import get_model_config as t_config
from repro_torch.convert import tree_from_numpy
from repro_torch.data.lm import synthetic_lm_batch
from repro_torch.models import model as tm
from repro_torch.models import moe as tmoe

TOL = 1e-5
FAMILIES = {"qwen2-0.5b": {}, "mixtral-8x7b": {},
            "llama4-maverick-400b-a17b": {}, "mamba2-2.7b": {},
            "zamba2-2.7b": dict(num_layers=4), "whisper-medium": {},
            "pixtral-12b": {}}
#: the MoE archs' gradients are taken where capacity binds: at B = 2,
#: S = 32 both drop assignments in every MoE layer
BINDING = {"mixtral-8x7b": dict(capacity_factor=0.5),
           "llama4-maverick-400b-a17b": dict(capacity_factor=0.5)}


def _setup(arch, B=2, S=32, seed=0, **over):
    kw = {**FAMILIES[arch], **over}
    rc, tc = r_config(arch).reduced(**kw), t_config(arch).reduced(**kw)
    host = jax.device_get(rm.init_model(jax.random.PRNGKey(seed), rc)[0])
    batch = synthetic_lm_batch((B, S), tc.vocab_size, seed=seed)
    rng = np.random.default_rng(seed + 100)
    if tc.family == "encdec":
        batch["frames"] = (rng.standard_normal(
            (B, tc.encoder_seq, tc.d_model)) * 0.02).astype(np.float32)
    if tc.family == "vlm":
        batch["patch_embeds"] = (rng.standard_normal(
            (B, tc.num_patches, tc.d_model)) * 0.02).astype(np.float32)
    return rc, tc, host, batch


def _port_grads(tc, host, batch, remat):
    params = tree_from_numpy(host)
    leaves, treedef = tr.tree_flatten(params)
    live = [p.requires_grad_(True) for p in leaves]
    loss = tm.lm_loss(tc, tr.tree_unflatten(treedef, live), batch,
                      remat=remat)
    return loss.detach(), torch.autograd.grad(loss, live)


def _close(got, exp, what):
    assert tuple(got.shape) == exp.shape, what
    np.testing.assert_allclose(got.numpy(), np.asarray(exp), atol=TOL,
                               rtol=TOL, err_msg=what)


def _routes(cfg, x, router):
    """Expert ids (..., k) of the router on x, as both packages route."""
    probs = jax.nn.softmax((x @ router).astype(jnp.float32), axis=-1)
    return jax.lax.top_k(probs, cfg.experts_per_token)[1]


def _dropped(ids: np.ndarray, cap: int) -> np.ndarray:
    """Which assignments (in assignment order) capacity drops: per
    expert, all but its ``cap`` newest."""
    out = np.zeros(ids.shape, bool)
    for e in np.unique(ids):
        idx = np.nonzero(ids == e)[0]
        out[idx[:max(idx.size - cap, 0)]] = True
    return out


def _drop_sets(rc, tc, host, batch, monkeypatch):
    """Each MoE layer's dropped assignments (rows, tokens a row, k): the
    reference's, from its expert ids (read out of its layer scan) under
    the recency rule; the port's as its dispatch made them (an
    assignment (t, e) is kept when token t's row sits in expert e's
    capacity buffer); and the port's own drop counts."""
    ref_ids, port_x, port_xe = [], [], []
    r_apply, t_route, t_experts = rmoe.apply_moe, tmoe._route, tmoe._experts

    def r_spy(cfg, p, x):
        jax.debug.callback(lambda a: ref_ids.append(np.asarray(a)),
                           _routes(cfg, x, p["router"]), ordered=True)
        return r_apply(cfg, p, x)

    def t_route_spy(cfg, p, x, tp=None):
        out = t_route(cfg, p, x, tp)
        port_x.append((x, out[2]))
        return out

    def t_experts_spy(p, xe):
        port_xe.append(xe)
        return t_experts(p, xe)

    monkeypatch.setattr(rmoe, "apply_moe", r_spy)
    monkeypatch.setattr(tmoe, "_route", t_route_spy)
    monkeypatch.setattr(tmoe, "_experts", t_experts_spy)
    rm.forward(rc, jax.tree.map(jnp.asarray, host),
               {k: jnp.asarray(v) for k, v in batch.items()})
    jax.effects_barrier()
    drops = []
    with torch.no_grad():
        tm.forward(tc, tree_from_numpy(host), batch, drops=drops)
    monkeypatch.undo()
    B, S = batch["tokens"].shape
    rows, T = (B, S) if tc.moe_local_dispatch else (1, B * S)
    k, E = tc.experts_per_token, tc.num_experts
    cap = tmoe._capacity(T, tc)
    ref = [np.stack([_dropped(r, cap) for r in
                     np.asarray(i).reshape(rows, -1)]).reshape(rows, T, k)
           for i in ref_ids]
    port = []
    for (x, ids), xe in zip(port_x, port_xe):
        x, ids = x.reshape(rows, T, -1), ids.reshape(rows, T, k)
        xe = xe.reshape(rows, E, cap, -1)
        # held[r, e, t]: token t's row is in expert e's buffer of row r
        held = (xe[:, :, :, None] == x[:, None, None]).all(-1).any(2)
        kept = torch.gather(held.transpose(1, 2), 2, ids)   # (rows, T, k)
        port.append((~kept).numpy())
    return ref, port, [int(d) for d in drops]


def _moe_router(tree):
    """The router leaves of a MoE params tree (llama4: the pairs' MoE
    layer)."""
    layers = tree["layers"]
    return (layers["moe"]["moe"] if "dense" in layers
            else layers["moe"])["router"]


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_grads_match_reference(arch, remat, monkeypatch):
    rc, tc, host, batch = _setup(arch, **BINDING.get(arch, {}))
    rb = {k: jnp.asarray(v) for k, v in batch.items()}
    jp = jax.tree.map(jnp.asarray, host)
    rloss, rgrads = jax.value_and_grad(
        lambda p: rm.lm_loss(rc, p, rb, remat=remat))(jp)
    loss, grads = _port_grads(tc, host, batch, remat)
    assert abs(float(loss) - float(rloss)) < TOL
    exp = jax.tree.leaves(rgrads)
    assert len(exp) == len(grads)
    for g, e in zip(grads, exp):
        _close(g, e, arch)
    got = tr.tree_unflatten(tr.tree_flatten(tree_from_numpy(host))[1],
                            list(grads))

    if tc.family == "moe":
        # capacity binds, and both packages drop the same assignments
        ref, port, counts = _drop_sets(rc, tc, host, batch, monkeypatch)
        assert len(ref) == len(port) == len(counts) == (
            tc.num_layers // (2 if tc.moe_shared_expert else 1))
        for r, p, n in zip(ref, port, counts):
            np.testing.assert_array_equal(p, r)
            assert n == int(p.sum()) > 0
        # the aux loss and its gradient into the routers, on their own
        raux, r_router = jax.value_and_grad(
            lambda p: rm.forward(rc, p, rb, remat=remat)[1])(jp)
        params = tree_from_numpy(host)
        router = _moe_router(params).requires_grad_(True)
        aux = tm.forward(tc, params, batch, remat=remat)[1]
        (g,) = torch.autograd.grad(aux, [router])
        aux = float(aux.detach())
        assert aux > 0 and abs(aux - float(raux)) < TOL
        _close(g, _moe_router(r_router), "router gradient of the aux loss")
        for g in (g, _moe_router(got)):
            assert bool((g.flatten(1) != 0).any(1).all())
    if tc.family == "encdec":
        # the cross-attention's k/v come from the encoder output: its
        # weights and every encoder weight get their gradient through it
        for name in ("wq", "wk", "wv", "wo"):
            g = got["dec_layers"]["cross_attn"][name]
            _close(g, rgrads["dec_layers"]["cross_attn"][name], name)
            assert bool((g.flatten(1) != 0).any(1).all()), name
        for g in tr.tree_leaves(got["enc_layers"]):
            assert bool((g.flatten(1) != 0).any(1).all())
    if tc.family == "vlm":
        # the loss is over the text positions only: the patch positions
        # come first in the logits and carry no label
        with torch.no_grad():
            logits, _ = tm.forward(tc, tree_from_numpy(host), batch)
        B, S = batch["tokens"].shape
        assert logits.shape[1] == tc.num_patches + S
        text = logits[:, tc.num_patches:]
        ce = torch.nn.functional.cross_entropy(
            text.reshape(B * S, -1),
            torch.from_numpy(batch["labels"]).long().reshape(-1))
        assert abs(float(ce) - float(loss)) < TOL
        assert bool((got["vision_proj"] != 0).any())


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_remat_grads_equal_bit_for_bit(arch):
    _, tc, host, batch = _setup(arch, seed=1)
    l0, g0 = _port_grads(tc, host, batch, remat=False)
    l1, g1 = _port_grads(tc, host, batch, remat=True)
    assert torch.equal(l0, l1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_forward_remat_keeps_the_outputs():
    _, tc, host, batch = _setup("zamba2-2.7b", seed=2)
    params = tree_from_numpy(host)
    a, _ = tm.forward(tc, params, batch)
    b, _ = tm.forward(tc, params, batch, remat=True)
    assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "pixtral-12b",
                                  "whisper-medium", "mamba2-2.7b",
                                  "zamba2-2.7b"])
def test_launcher_trains_the_families(arch):
    """``--engine pytree`` (the launcher's default) for one arch of each
    of the moe, vlm, encdec, ssm and hybrid families: one reduced round
    on the CPU in a world of one, a finite loss."""
    from repro_torch.launch import train
    out = train.main(["--arch", arch, "--reduced", "--device", "cpu",
                      "--dist-backend", "gloo", "--rounds", "1"])
    assert out["hist"]["round"] == [0]
    assert np.isfinite(out["hist"]["loss"]).all(), out["hist"]
