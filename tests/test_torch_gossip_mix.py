"""The port's gossip-mix wrappers against the reference kernel.

On the CPU each wrapper runs its plain version; the reference side runs
the Pallas kernel in interpret mode (as ``tests/test_kernels.py`` does)
or its jnp paths. The CUDA kernel itself is held against the same plain
version on the card by ``chip_smoke.py``. Also: ``FlatLayout`` offsets
and order, and weight conversion, equal the reference's byte for byte.
"""
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core.cefedavg import mix as r_mix
from repro.kernels import gossip_mix as rgm
from repro.kernels import ops
from repro.models import cnn as rcnn
from repro_torch import tree as tr
from repro_torch.convert import row_from_numpy, tree_from_numpy
from repro_torch.core.cefedavg import mix as t_mix
from repro_torch.kernels import gossip_mix as tgm
from repro_torch.kernels import ref as tref
from repro_torch.models import cnn as tcnn

TOL = {"float32": 1e-5, "bfloat16": 5e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _bank(rng, n, T, dtype):
    """The same (n, T) bank for both sides, rounded to ``dtype`` once."""
    y = rng.standard_normal((n, T)).astype(np.float32)
    if dtype == "bfloat16":
        y = y.astype(ml_dtypes.bfloat16).astype(np.float32)
    return (jnp.asarray(y).astype(dtype),
            torch.from_numpy(y).to(TORCH_DTYPE[dtype]))


def _close(t, j, tol):
    np.testing.assert_allclose(t.to(torch.float32).numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("n,T", [(8, 5000), (16, 4096), (64, 1000),
                                 (4, 123)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_matches_reference_kernel(n, T, dtype):
    rng = np.random.default_rng(n * 7 + T)
    W = rng.uniform(size=(n, n)).astype(np.float32)
    W /= W.sum(0)
    Yj, Yt = _bank(rng, n, T, dtype)
    exp = ops.gossip_mix_flat(jnp.asarray(W), Yj, interpret=True)
    got = tgm.gossip_mix_flat(W, Yt)
    assert got.dtype == Yt.dtype and got.shape == (n, T)
    _close(got, exp, TOL[dtype])
    _close(tref.gossip_mix_ref(torch.from_numpy(W), Yt), exp, TOL[dtype])


@pytest.mark.parametrize("n,T", [(8, 333), (16, 4096), (64, 1000)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rows_asymmetric_row_stochastic(n, T, dtype):
    """Row application of an asymmetric, masked row-stochastic W (the
    scenario operators): the reference's Pallas path and ``mix``."""
    rng = np.random.default_rng(n + T)
    W = rng.uniform(size=(n, n)) * (rng.uniform(size=(n, n)) < 0.5)
    W += np.eye(n)
    W = (W / W.sum(1, keepdims=True)).astype(np.float32)
    assert not np.allclose(W, W.T)
    Yj, Yt = _bank(rng, n, T, dtype)
    exp = rgm.gossip_mix_rows(jnp.asarray(W), Yj, interpret=True)
    got = tgm.gossip_mix_rows(W, Yt)
    _close(got, exp, TOL[dtype])
    _close(got, r_mix(W, Yj), TOL[dtype])


@pytest.mark.parametrize("m,n,T", [(8, 64, 1000), (4, 16, 777),
                                   (1, 16, 50)])
def test_rectangular_projection(m, n, T):
    """The edge-model projection P (m, n): never in place, a new (m, T)
    result equal to the reference's."""
    rng = np.random.default_rng(m * n)
    labels = np.repeat(np.arange(m), n // m)
    P = np.zeros((m, n), np.float32)
    P[labels, np.arange(n)] = 1.0 / (n // m)
    Yj, Yt = _bank(rng, n, T, "float32")
    before = Yt.clone()
    got = tgm.gossip_mix_rows(P, Yt)
    assert got.shape == (m, T)
    _close(got, rgm.gossip_mix_rows(jnp.asarray(P), Yj, interpret=True),
           1e-5)
    torch.testing.assert_close(Yt, before, rtol=0, atol=0)


@pytest.mark.parametrize("n,T,block_cols", [(16, 3000, 1024),
                                            (8, 1000, 999), (4, 123, 64)])
def test_square_boundary_matches_in_place_pass(n, T, block_cols):
    """Square W is the in-place boundary: repeated ``Y = rows(W, Y)``
    equals the reference's in-place blocked pass applied as often."""
    rng = np.random.default_rng(T)
    W = rng.uniform(size=(n, n)).astype(np.float32)
    W /= W.sum(1, keepdims=True)
    Yj, Yt = _bank(rng, n, T, "float32")
    for _ in range(3):
        Yj = rgm._mix_rows_blocked(jnp.asarray(W), Yj, block_cols)
        Yt = tgm.gossip_mix_rows(W, Yt)
    _close(Yt, Yj, 1e-5)


def test_no_fallback_off_the_cpu():
    """A tensor that is not on the CPU never reaches the plain version:
    the wrapper launches the kernel or raises."""
    W = np.eye(4, dtype=np.float32)
    Y = torch.zeros((4, 10), device="meta")
    for fn in (tgm.gossip_mix_rows, tgm.gossip_mix_flat):
        with pytest.raises(ValueError, match="no kernel"):
            fn(W, Y)
    assert tgm.launches == 0


def test_shape_checks():
    Y = torch.zeros((4, 10))
    with pytest.raises(ValueError):
        tgm.gossip_mix_rows(np.eye(3, dtype=np.float32), Y)
    with pytest.raises(ValueError):
        tgm.gossip_mix_flat(np.ones((3, 4), np.float32), Y)
    with pytest.raises(ValueError):
        tgm.gossip_mix_rows(np.eye(4, dtype=np.float32), Y[0])


def test_mix_tree_matches_reference():
    from repro.core.topology import (inter_cluster_operator, mixing_matrix,
                                     ring)
    n = 8
    W = inter_cluster_operator([2] * 4, mixing_matrix(ring(4)), pi=3)
    rng = np.random.default_rng(5)
    params = {"a": rng.standard_normal((n, 17, 3)).astype(np.float32),
              "b": rng.standard_normal((n, 41)).astype(np.float32)}
    exp = ops.gossip_mix_tree(W, jax.tree.map(jnp.asarray, params),
                              interpret=True)
    got = tgm.gossip_mix_tree(W, tree_from_numpy(params))
    got_mix = t_mix(W, tree_from_numpy(params))
    for g, gm_, e in zip(tr.tree_leaves(got), tr.tree_leaves(got_mix),
                         jax.tree.leaves(exp)):
        assert tuple(g.shape) == e.shape
        _close(g, e, 1e-5)
        _close(gm_, e, 1e-5)


def _ref_init(name):
    key = jax.random.PRNGKey(0)
    if name == "mlp":
        return rcnn.init_mlp_classifier(key, 16, 32, 8)
    if name == "femnist_cnn":
        return rcnn.init_femnist_cnn(key)
    return rcnn.init_vgg11(key)


def _port_init(name):
    g = torch.Generator().manual_seed(0)
    if name == "mlp":
        return tcnn.init_mlp_classifier(g, 16, 32, 8)
    if name == "femnist_cnn":
        return tcnn.init_femnist_cnn(g)
    return tcnn.init_vgg11(g)


@pytest.mark.parametrize("name,total", [("mlp", 16 * 32 + 32 + 32 * 8 + 8),
                                        ("femnist_cnn", 6_603_710),
                                        ("vgg11", 9_750_922)])
def test_flat_layout_matches_reference(name, total):
    init = jax.device_get(_ref_init(name))
    r = rgm.FlatLayout.for_tree(init)
    for t in (tgm.FlatLayout.for_tree(_port_init(name)),
              tgm.FlatLayout.for_tree(tree_from_numpy(init))):
        assert t.total == r.total == total
        assert t.offsets == r.offsets
        assert t.sizes == r.sizes
        assert t.shapes == r.shapes
        assert t.segments == r.segments
        assert t.row_nbytes == r.row_nbytes
    # the stacked form excludes the device axis the same way
    stacked = jax.tree.map(lambda a: np.stack([a, a]), init)
    ts = tgm.FlatLayout.for_stacked(tree_from_numpy(stacked))
    rs = rgm.FlatLayout.for_stacked(stacked)
    assert (ts.offsets, ts.sizes, ts.shapes) == (rs.offsets, rs.sizes,
                                                 rs.shapes)


@pytest.mark.parametrize("name", ["mlp", "femnist_cnn", "vgg11"])
def test_row_from_numpy_is_flatten_one(name):
    init = jax.device_get(_ref_init(name))
    exp = np.asarray(rgm.FlatLayout.for_tree(init).flatten_one(init))
    row = row_from_numpy(init)
    assert row.dtype == torch.float32
    assert row.numpy().tobytes() == exp.tobytes()
    layout = tgm.FlatLayout.for_tree(tree_from_numpy(init))
    assert layout.flatten_one(tree_from_numpy(init)).numpy().tobytes() \
        == exp.tobytes()
    # unflatten returns the reference's leaves in the reference's order
    for a, b in zip(tr.tree_leaves(layout.unflatten_one(row)),
                    jax.tree.leaves(init)):
        assert a.numpy().tobytes() == np.asarray(b).tobytes()


def test_tree_walks_leave_no_cycle():
    """Flattening and rebuilding a tree makes no reference cycle: a leaf
    dies with its last reference, without the cyclic collector."""
    import gc
    import weakref
    gc.collect()
    gc.disable()
    try:
        leaf = torch.zeros(3)
        dead = weakref.ref(leaf)
        out = tr.tree_map(lambda a: a + 1, {"b": [leaf], "a": {"w": leaf}})
        assert len(tr.tree_leaves(out)) == 2
        del leaf, out
        assert dead() is None
    finally:
        gc.enable()


def test_stack_round_trip():
    init = tree_from_numpy(jax.device_get(_ref_init("mlp")))
    stacked = tr.tree_map(lambda a: torch.stack([a, 2 * a, 3 * a]), init)
    layout = tgm.FlatLayout.for_stacked(stacked)
    Y = layout.flatten_stack(stacked)
    assert Y.shape == (3, layout.total)
    for a, b in zip(tr.tree_leaves(layout.unflatten_stack(Y)),
                    tr.tree_leaves(stacked)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
