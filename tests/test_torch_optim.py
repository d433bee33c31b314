"""The port's optimizers and learning-rate schedules
(``repro_torch.optim``) against the reference's (``repro.optim``) on the
CPU.

The reference's own optimizer cases (``tests/test_optim_ckpt.py``: a
quadratic minimised by each optimizer, momentum buffers shaped like the
params, the dispatch, the schedules' values) run on both packages. Then
the port against the reference: SGD (momentum 0 and 0.9, with weight
decay) and AdamW (with and without weight decay) over 5 steps of the
same gradients on the same f32 trees within 1e-6 (f32 rounding of
``pow`` and ``sqrt`` in another library), the state's dtypes (f32
whatever the params', AdamW's step int32), bf16 params updated in their
dtype, and every schedule equal at every step.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as r_optim
from repro.config import TrainConfig as RTrain
from repro.optim.optimizers import apply_updates as r_apply
from repro_torch import optim as t_optim
from repro_torch import tree as tr
from repro_torch.config import TrainConfig as TTrain
from repro_torch.optim import apply_updates as t_apply

PKGS = ("repro", "repro_torch")
TOL = 1e-6


def _pkg(name):
    """(optim module, TrainConfig, apply_updates, grad of sum(w**2),
    array maker, tree leaves) of one package."""
    optim = importlib.import_module(name + ".optim")
    cfg = importlib.import_module(name + ".config").TrainConfig
    if name == "repro":
        return (optim, cfg, r_apply,
                jax.grad(lambda p: jnp.sum(p["w"] ** 2)), jnp.asarray,
                jax.tree.leaves)

    def grad(p):
        return {"w": 2 * p["w"]}
    return (optim, cfg, t_apply, grad,
            lambda a: torch.as_tensor(np.asarray(a, np.float32)),
            tr.tree_leaves)


# ---------------------------------------------------------------------------
# the reference's cases, on both packages
# ---------------------------------------------------------------------------

MAKERS = [("sgd(0.9)", lambda o: o.sgd(0.9), 0.05),
          ("sgd(0.0)", lambda o: o.sgd(0.0), 0.1),
          ("adamw()", lambda o: o.adamw(), 0.1),
          ("sgd(0.9, wd)", lambda o: o.sgd(0.9, weight_decay=0.01), 0.05)]


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("name,maker,lr", MAKERS, ids=[m[0] for m in MAKERS])
def test_optimizers_minimize_quadratic(pkg, name, maker, lr):
    optim, _, apply, grad, arr, _ = _pkg(pkg)
    init, update = maker(optim)
    params = {"w": arr([3.0, -2.0])}
    state = init(params)
    losses = []
    for _ in range(200):
        upd, state = update(grad(params), state, params, lr)
        params = apply(params, upd)
        losses.append(float((params["w"] ** 2).sum()))
    assert losses[-1] < 1e-3 * losses[0]


@pytest.mark.parametrize("pkg", PKGS)
def test_momentum_buffers_match_params_structure(pkg):
    optim, _, _, _, arr, _ = _pkg(pkg)
    init, _ = optim.sgd(0.9)
    params = {"a": arr(np.ones(3)), "b": {"c": arr(np.ones((2, 2)))}}
    state = init(params)
    assert set(state["mu"]) == {"a", "b"} and set(state["mu"]["b"]) == {"c"}
    assert tuple(state["mu"]["b"]["c"].shape) == (2, 2)


@pytest.mark.parametrize("pkg", PKGS)
def test_make_optimizer_dispatch(pkg):
    optim, cfg, *_ = _pkg(pkg)
    for name in ("sgd", "adamw"):
        init, update = optim.make_optimizer(cfg(optimizer=name))
        assert callable(init) and callable(update)
    with pytest.raises(ValueError):
        optim.make_optimizer(cfg(optimizer="lion"))


@pytest.mark.parametrize("pkg", PKGS)
def test_lr_schedules(pkg):
    optim, cfg, *_ = _pkg(pkg)
    step = jnp.asarray if pkg == "repro" else int
    sched = optim.make_lr_schedule(cfg(
        lr_schedule="warmup_cosine", warmup_steps=10, total_steps=100,
        learning_rate=1.0))
    assert float(sched(step(0))) < 0.2
    assert float(sched(step(10))) == pytest.approx(1.0, abs=0.01)
    assert float(sched(step(100))) < 0.01
    const = optim.make_lr_schedule(cfg(lr_schedule="constant",
                                       learning_rate=0.3))
    assert float(const(step(7))) == pytest.approx(0.3)


# ---------------------------------------------------------------------------
# the port against the reference
# ---------------------------------------------------------------------------

def _tree(rng):
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": {"c": rng.standard_normal(5).astype(np.float32),
                  "d": [rng.standard_normal((2, 3)).astype(np.float32)]}}


CASES = {"sgd": dict(optimizer="sgd", momentum=0.0),
         "sgd_wd": dict(optimizer="sgd", momentum=0.0, weight_decay=0.01),
         "momentum": dict(optimizer="sgd", momentum=0.9),
         "momentum_wd": dict(optimizer="sgd", momentum=0.9,
                             weight_decay=0.01),
         "adamw": dict(optimizer="adamw"),
         "adamw_wd": dict(optimizer="adamw", weight_decay=0.1)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_five_steps_match_reference(case):
    rng = np.random.default_rng(sorted(CASES).index(case))
    host = _tree(rng)
    rcfg, tcfg = RTrain(**CASES[case]), TTrain(**CASES[case])
    (ri, ru), (ti, tu) = (r_optim.make_optimizer(rcfg),
                          t_optim.make_optimizer(tcfg))
    rsched, tsched = (r_optim.make_lr_schedule(rcfg),
                      t_optim.make_lr_schedule(tcfg))
    rp = jax.tree.map(jnp.asarray, host)
    tp = tr.tree_map(lambda a: torch.from_numpy(a.copy()), host)
    rs, ts = ri(rp), ti(tp)
    for step in range(5):
        g = tr.tree_map(lambda a: rng.standard_normal(a.shape).astype(
            np.float32), host)
        upd, rs = ru(jax.tree.map(jnp.asarray, g), rs, rp,
                     rsched(jnp.asarray(step)))
        rp = r_apply(rp, upd)
        upd, ts = tu(tr.tree_map(torch.from_numpy, g), ts, tp, tsched(step))
        tp = t_apply(tp, upd)
    for a, b in zip(jax.tree.leaves(rp), tr.tree_leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL,
                                   rtol=0)
    for a, b in zip(jax.tree.leaves(rs), tr.tree_leaves(ts)):
        assert str(b.dtype).removeprefix("torch.") == str(a.dtype)
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=TOL,
                                   rtol=0)


def test_state_is_f32_and_bf16_params_update_in_their_dtype():
    import ml_dtypes
    rng = np.random.default_rng(7)
    w = rng.standard_normal((4, 8)).astype(ml_dtypes.bfloat16)
    g = rng.standard_normal((4, 8)).astype(ml_dtypes.bfloat16)
    from repro_torch.convert import leaf_from_numpy
    for name in ("sgd", "adamw"):
        rcfg, tcfg = RTrain(optimizer=name), TTrain(optimizer=name)
        (ri, ru), (ti, tu) = (r_optim.make_optimizer(rcfg),
                              t_optim.make_optimizer(tcfg))
        rp, tp = {"w": jnp.asarray(w)}, {"w": leaf_from_numpy(w)}
        rs, ts = ri(rp), ti(tp)
        for leaf in tr.tree_leaves(ts):
            assert leaf.dtype in (torch.float32, torch.int32)
        if name == "adamw":
            assert ts["t"].dtype == torch.int32 and ts["t"].shape == ()
        else:
            assert ts["mu"]["w"].dtype == torch.float32
        for _ in range(3):
            upd, rs = ru({"w": jnp.asarray(g)}, rs, rp,
                         jnp.asarray(0.05, jnp.float32))
            rp = r_apply(rp, upd)
            upd, ts = tu({"w": leaf_from_numpy(g)}, ts, tp,
                         torch.tensor(0.05))
            tp = t_apply(tp, upd)
        assert tp["w"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tp["w"].float().numpy(), np.asarray(rp["w"], np.float32))


def test_apply_updates_in_place():
    p = {"w": torch.ones(3)}
    out = t_apply(p, {"w": torch.full((3,), 0.25, dtype=torch.float64)})
    assert out["w"] is p["w"] and out["w"].dtype == torch.float32
    assert torch.equal(p["w"], torch.full((3,), 0.75))


@pytest.mark.parametrize("sched", ["constant", "cosine", "warmup_cosine"])
def test_lr_schedules_equal_reference(sched):
    kw = dict(lr_schedule=sched, warmup_steps=10, total_steps=100,
              learning_rate=0.7)
    rf = r_optim.make_lr_schedule(RTrain(**kw))
    tf = t_optim.make_lr_schedule(TTrain(**kw))
    for step in range(0, 121):
        got = tf(step)
        assert got.dtype == torch.float32 and got.shape == ()
        assert float(got) == pytest.approx(float(rf(jnp.asarray(step))),
                                           abs=1e-7)
        assert float(tf(torch.tensor(step))) == float(got)
