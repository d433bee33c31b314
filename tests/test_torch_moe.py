"""The port's MoE layer (``repro_torch.models.moe``) against the
reference (``repro.models.moe``) on the CPU, at f32, on the reference's
own parameters carried across with ``repro_torch.convert``.

Global and batch-local dispatch, with and without the shared expert:
outputs within 1e-5 and the aux loss within 1e-6 (the same sums in
another order). With a binding capacity (capacity_factor 0.1, top-1,
as in ``tests/test_optimizations.py``) the set of dropped tokens equals
the reference's exactly, each expert keeps its newest tokens, and the
reported drop count is that set's size.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as r_config
from repro.models import moe as rmoe
from repro_torch import tree as tr
from repro_torch.configs import get_model_config as t_config
from repro_torch.convert import tree_from_numpy
from repro_torch.models import moe as tmoe


def _cfgs(**kw):
    rc = r_config("mixtral-8x7b").reduced()
    tc = t_config("mixtral-8x7b").reduced()
    return dataclasses.replace(rc, **kw), dataclasses.replace(tc, **kw)


def _params(rc, seed=0):
    host = jax.device_get(rmoe.init_moe(jax.random.PRNGKey(seed), rc,
                                        rc.d_model, rc.d_ff)[0])
    return jax.tree.map(jnp.asarray, host), tree_from_numpy(host)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("local", [False, True])
def test_apply_moe_matches_reference(local, shared):
    rc, tc = _cfgs(moe_shared_expert=shared, moe_local_dispatch=local)
    jp, tp = _params(rc)
    x = _x((3, 32, rc.d_model))
    y, aux = tmoe.apply_moe(tc, tp, torch.from_numpy(x))
    ey, eaux = rmoe.apply_moe(rc, jp, jnp.asarray(x))
    assert tuple(y.shape) == ey.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), np.asarray(ey), atol=1e-5,
                               rtol=1e-5)
    assert abs(float(aux) - float(eaux)) <= 1e-6


@pytest.mark.parametrize("local", [False, True])
def test_binding_capacity_drops_the_reference_tokens(local):
    """Top-1 at capacity_factor 0.1: the zeroed tokens are the
    reference's, and within each expert every kept token is newer than
    every dropped one."""
    rc, tc = _cfgs(experts_per_token=1, capacity_factor=0.1,
                   moe_local_dispatch=local)
    jp, tp = _params(rc)
    x = _x((2, 64, rc.d_model))
    drops = []
    y, _ = tmoe.apply_moe(tc, tp, torch.from_numpy(x), drops)
    ey, _ = rmoe.apply_moe(rc, jp, jnp.asarray(x))
    dropped = np.linalg.norm(y.numpy(), axis=-1) == 0.0
    exp_dropped = np.linalg.norm(np.asarray(ey), axis=-1) == 0.0
    assert dropped.any() and not dropped.all()
    np.testing.assert_array_equal(dropped, exp_dropped)
    np.testing.assert_allclose(y.numpy(), np.asarray(ey), atol=1e-5,
                               rtol=1e-5)
    assert len(drops) == 1 and int(drops[0]) == int(dropped.sum())
    # recency: per expert (per batch row when local), the kept tokens
    # are the newest
    expert = (x @ tp["router"].numpy()).argmax(-1)
    rows = expert.reshape(2, 64) if local else expert.reshape(1, 128)
    gone = dropped.reshape(rows.shape)
    for r in range(rows.shape[0]):
        for e in range(tc.num_experts):
            idx = np.nonzero(rows[r] == e)[0]
            kept, lost = idx[~gone[r, idx]], idx[gone[r, idx]]
            assert kept.size == min(idx.size, tmoe._capacity(
                rows.shape[1], tc))
            if lost.size:
                assert lost.max() < kept.min()


@pytest.mark.parametrize("tokens", [1, 8, 64, 1000, 8192])
def test_capacity_matches_reference(tokens):
    rc, tc = _cfgs()
    assert tmoe._capacity(tokens, tc) == rmoe._capacity(tokens, rc)


@pytest.mark.parametrize("shared", [False, True])
def test_init_moe_tree_matches_reference(shared):
    rc, tc = _cfgs(moe_shared_expert=shared, dtype="bfloat16",
                   param_dtype="bfloat16")
    shapes = jax.eval_shape(
        lambda k: rmoe.init_moe(k, rc, rc.d_model, rc.d_ff)[0],
        jax.random.PRNGKey(0))
    p = tmoe.init_moe(torch.Generator().manual_seed(0), tc, tc.d_model,
                      tc.d_ff, "cpu")
    t_leaves, t_def = tr.tree_flatten(p)
    j_leaves, j_def = tr.tree_flatten(shapes)
    assert t_def == j_def
    for t, j in zip(t_leaves, j_leaves):
        assert tuple(t.shape) == j.shape
        assert str(t.dtype).removeprefix("torch.") == str(j.dtype)
    assert p["router"].dtype == torch.float32
