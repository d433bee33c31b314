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


# ---------------------------------------------------------------------------
# the card kernel's arithmetic, emulated in plain torch
# ---------------------------------------------------------------------------

def _tf32_rna(x):
    """``cvt.rna.tf32.f32``: f32 rounded to 10 mantissa bits, ties away
    from zero (add half an ulp of TF32 to the magnitude, then mask)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x):
    """What the tensor core reads of an f32 operand in TF32: the top 10
    mantissa bits (the low 13 ignored)."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _kernel_rows(W, Y):
    """out = W @ Y as ``csrc/gossip_mix.cu`` computes it: W and f32 Y
    split x = x_hi + x_lo with x_hi = x rounded to TF32, products
    W_hi·Y_hi + W_hi·Y_lo + W_lo·Y_hi on TF32 operands (bf16 Y is exact
    in TF32: W_hi·Y + W_lo·Y), every product exact and summed in f64 here
    (f32 on the card), rounded to Y's dtype."""
    W = torch.as_tensor(W, dtype=torch.float32)
    wh = _tf32_rna(W)
    wl = _tf32_trunc(W - wh)
    y = Y.to(torch.float32)
    yh = _tf32_rna(y)
    yl = _tf32_trunc(y - yh)
    if Y.dtype == torch.bfloat16:
        assert torch.equal(yh, y)  # exact: bf16 has 7 mantissa bits
        parts = ((wh, y), (wl, y))
    else:
        parts = ((wh, yh), (wh, yl), (wl, yh))
    out = sum(a.double() @ b.double() for a, b in parts)
    return out.to(Y.dtype)


def test_tf32_helpers():
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -12,
                      -1.0 - 2.0 ** -11, 1.0 + 2.0 ** -12],
                     dtype=torch.float32)
    np.testing.assert_array_equal(
        _tf32_rna(x).numpy(), np.float32([1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10,
                                          -1.0 - 2.0 ** -10, 1.0]))
    np.testing.assert_array_equal(_tf32_trunc(x).numpy(),
                                  np.float32([1.0, 1.0, -1.0, 1.0]))
    # a single rounding loses up to 2^-11; the split keeps about 2^-21
    rng = np.random.default_rng(0)
    v = torch.from_numpy(rng.standard_normal(10000).astype(np.float32))
    hi = _tf32_rna(v)
    assert float(((v - hi) / v).abs().max()) > 2.0 ** -13
    assert float(((hi + _tf32_trunc(v - hi) - v) / v).abs().max()) \
        <= 2.0 ** -21


@pytest.mark.parametrize("n,T", [(8, 5000), (16, 4096), (64, 1000),
                                 (4, 123)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_arithmetic_matches_reference_oracle(n, T, dtype):
    """The split TF32 products of the card kernel against the reference's
    ``kernels/ref.py`` oracle, run through JAX on the CPU, at the kernel
    sweep's tolerances (1e-5 f32, 5e-2 bf16): square and in place, and
    the flat (column) convention."""
    from repro.kernels import ref as rref
    rng = np.random.default_rng(n * 11 + T)
    W = rng.uniform(size=(n, n)).astype(np.float32)
    W /= W.sum(1, keepdims=True)
    Yj, Yt = _bank(rng, n, T, dtype)
    _close(_kernel_rows(W, Yt), rref.gossip_mix_rows_ref(jnp.asarray(W), Yj),
           TOL[dtype])
    _close(_kernel_rows(W.T, Yt), rref.gossip_mix_ref(jnp.asarray(W), Yj),
           TOL[dtype])


def test_kernel_arithmetic_at_the_main_shape_width():
    """The 64x64 boundary and the (8, 64) projection over a slice of a
    bank scaled as the FEMNIST CNN's weights may grow (|y| up to 50):
    the three-pass split stays within 1e-5 + 1e-5·|out|, where one TF32
    pass would not."""
    from repro.kernels import ref as rref
    rng = np.random.default_rng(3)
    n = 64
    W = rng.uniform(size=(n, n)).astype(np.float32)
    W /= W.sum(1, keepdims=True)
    P = np.kron(np.eye(8), np.full((1, 8), 1 / 8)).astype(np.float32)
    y = (rng.standard_normal((n, 4096)) * 10).astype(np.float32)
    for op in (W, P):
        exp = np.asarray(rref.gossip_mix_rows_ref(jnp.asarray(op),
                                                  jnp.asarray(y)))
        got = _kernel_rows(op, torch.from_numpy(y)).numpy()
        np.testing.assert_allclose(got, exp, atol=1e-5, rtol=1e-5)
        one_pass = (_tf32_rna(torch.from_numpy(op)).double()
                    @ _tf32_rna(torch.from_numpy(y)).double()).numpy()
        assert np.abs(one_pass - exp).max() > 1e-3


@pytest.mark.parametrize("T,itemsize,ptr,want", [
    (6_603_710, 4, 0, 8),    # FEMNIST CNN, f32: T = 2 mod 4
    (9_750_922, 4, 0, 8),    # VGG-11, f32: T = 2 mod 4
    (6_603_710, 2, 0, 4),    # FEMNIST CNN, bf16
    (4096, 4, 0, 16), (4096, 2, 0, 16), (5000, 4, 0, 16), (5000, 2, 0, 16),
    (1000, 4, 0, 16), (1000, 2, 0, 16), (1001, 4, 0, 4), (123, 4, 0, 4),
    (123, 2, 0, 2), (4099, 4, 0, 4), (4098, 2, 0, 4), (4097, 2, 0, 2),
    (4096, 4, 8, 8), (4096, 4, 4, 4), (4096, 2, 2, 2), (4096, 2, 12, 4),
])
def test_copy_width_follows_row_and_pointer_alignment(T, itemsize, ptr,
                                                      want):
    assert tgm.copy_bytes(T, itemsize, 256 + ptr) == want


def test_copy_width_at_every_residue():
    """T at 0, 1, 2 and 3 mod 4 (and bf16 to 7 mod 8): a copy never
    straddles a row's end (the width divides the row), holds whole
    elements, and is the widest that does."""
    for itemsize in (4, 2):
        for T in range(4000, 4016):
            w = tgm.copy_bytes(T, itemsize, 0)
            assert (T * itemsize) % w == 0 and w >= itemsize
            assert w == max(b for b in (16, 8, 4, 2)
                            if b >= itemsize and (T * itemsize) % b == 0)
    with pytest.raises(ValueError):
        tgm.copy_bytes(8, 4, 2)
