"""The port's SSD intra-chunk wrappers (``repro_torch.kernels.ssd_scan``)
against the reference on the CPU.

On the CPU each wrapper runs its plain version; the reference side runs
its jnp oracle (``repro.kernels.ref.ssd_intra_chunk_ref``) over the
sweep of ``tests/test_kernels.py``, the Pallas kernel in interpret mode
at one shape, and ``models.ssm.ssd_chunked`` with the Pallas intra_fn
(interpret mode) against the port's ``ssd_chunked`` with its adapter.
The CUDA kernel itself is held against the same plain version on the
card by ``chip_smoke.py``. Tolerances: the reference's own, 1e-4 at f32
and 0.15 at bf16 (both outputs), 1e-3 through ssd_chunked.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref as rref
from repro.models.ssm import ssd_chunked as r_ssd_chunked
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tss
from repro_torch.models.ssm import ssd_chunked as t_ssd_chunked

TOL = {"float32": 1e-4, "bfloat16": 0.15}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True, scope="module")
def _first_exp_of_the_process():
    """On a multi-core CPU host the first multi-threaded ``torch.exp`` of
    a process sometimes returns one worker thread's chunk at about
    1.5e-4 relative error (every later call is right to an ulp; one
    thread never shows it). In this file that first call used to be the
    plain SSD version's exp of the (BK, H, C, C) segment sums, which then
    missed the 1e-4 oracle bound. One call over all threads here takes
    that first call before anything is measured (ROADMAP C2)."""
    torch.exp(torch.zeros(1 << 20))
SWEEP = [(4, 3, 128, 64, 32), (2, 5, 256, 64, 128), (1, 2, 128, 128, 64)]


def _pair(a, dtype):
    """One array for both sides, rounded to ``dtype`` once."""
    a = a.astype(np.float32)
    if dtype == "bfloat16":
        a = a.astype(ml_dtypes.bfloat16).astype(np.float32)
    return (jnp.asarray(a).astype(dtype),
            torch.from_numpy(a).to(TORCH_DTYPE[dtype]))


def _inputs(seed, BK, H, C, P, N, dtype):
    rng = np.random.default_rng(seed)
    return [_pair(a, dtype) for a in (
        rng.standard_normal((BK, H, C, P)),
        -np.abs(rng.standard_normal((BK, H, C))) * 0.1,
        rng.standard_normal((BK, C, N)),
        rng.standard_normal((BK, C, N)),
        np.abs(rng.standard_normal((BK, H, C))) * 0.1)]


def _close(t, j, tol):
    np.testing.assert_allclose(t.to(torch.float32).numpy(),
                               np.asarray(j, np.float32), atol=tol,
                               rtol=tol)


@pytest.mark.parametrize("BK,H,C,P,N", SWEEP)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_oracle(BK, H, C, P, N, dtype):
    pairs = _inputs(BK * 100 + C + N, BK, H, C, P, N, dtype)
    before = tss.launches
    y, st = tss.ssd_intra_chunk(*(t for _, t in pairs))
    assert tss.launches == before  # the CPU runs the plain version
    assert y.dtype == st.dtype == torch.float32
    assert tuple(y.shape) == (BK, H, C, P) and tuple(st.shape) == (BK, H, N, P)
    y_ref, st_ref = rref.ssd_intra_chunk_ref(*(j for j, _ in pairs))
    _close(y, y_ref, TOL[dtype])
    _close(st, st_ref, TOL[dtype])


def test_plain_matches_pallas_interpret():
    pairs = _inputs(5, 4, 3, 128, 64, 32, "float32")
    y_k, st_k = ops.ssd_intra_chunk(*(j for j, _ in pairs), interpret=True)
    y, st = tref.ssd_intra_chunk_ref(*(t for _, t in pairs))
    _close(y, y_k, TOL["float32"])
    _close(st, st_k, TOL["float32"])


def test_adapter_inside_ssd_chunked():
    """ssd_chunked with the port's intra adapter == the reference's with
    the Pallas intra_fn (interpret mode), padding included."""
    rng = np.random.default_rng(3)
    B, S, H, P, N, chunk = 2, 160, 4, 32, 16, 64
    arrs = (rng.standard_normal((B, S, H, P)),
            np.abs(rng.standard_normal((B, S, H))) * 0.1,
            -np.abs(rng.standard_normal((H,))),
            rng.standard_normal((B, S, N)),
            rng.standard_normal((B, S, N)))
    pairs = [_pair(a, "float32") for a in arrs]
    y_j, st_j = r_ssd_chunked(*(j for j, _ in pairs), chunk,
                              intra_fn=ops.ssd_intra_fn(interpret=True))
    y_t, st_t = t_ssd_chunked(*(t for _, t in pairs), chunk,
                              intra_fn=tss.make_intra_fn())
    _close(y_t, y_j, 1e-3)
    _close(st_t, st_j, 1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S,init_state", [(256, False), (160, True)],
                         ids=["whole-chunks", "padded-initial-state"])
@pytest.mark.parametrize("reference", ["einsum", "pallas"])
def test_states_from_the_kernel_inside_ssd_chunked(dtype, S, init_state,
                                                   reference):
    """The branch a CUDA tensor takes: y_intra and the chunk states from
    the intra-chunk block's one launch (its plain version on the CPU)
    feed the recurrence. y and the final state == the reference's
    ssd_chunked, with its einsum path or the Pallas intra_fn (interpret
    mode), with S padded to the chunk and a non-zero initial state.
    Tolerances: 1e-4 at f32; at bf16 the file's 1e-3 through
    ssd_chunked, and y, which both sides round to bf16 from f32 sums in
    another order, may also differ by one bf16 step (2^-7 of it)."""
    rng = np.random.default_rng(S)
    B, H, P, N, chunk = 2, 4, 32, 16, 64
    x, Bm, Cm = (_pair(rng.standard_normal(shape), dtype)
                 for shape in ((B, S, H, P), (B, S, N), (B, S, N)))
    f32 = [_pair(a, "float32") for a in (
        np.abs(rng.standard_normal((B, S, H))) * 0.1,
        -np.abs(rng.standard_normal((H,))),
        rng.standard_normal((B, H, P, N)))]
    dtv, A, s0 = f32
    kw = {"initial_state": s0[0]} if init_state else {}
    if reference == "pallas":
        kw["intra_fn"] = ops.ssd_intra_fn(interpret=True)
    y_j, st_j = r_ssd_chunked(x[0], dtv[0], A[0], Bm[0], Cm[0], chunk, **kw)
    y_t, st_t = t_ssd_chunked(
        x[1], dtv[1], A[1], Bm[1], Cm[1], chunk,
        initial_state=s0[1] if init_state else None,
        intra_states_fn=tss.make_intra_states_fn())
    assert y_t.dtype == TORCH_DTYPE[dtype] and st_t.dtype == torch.float32
    assert tuple(y_t.shape) == y_j.shape and tuple(st_t.shape) == st_j.shape
    if dtype == "float32":
        _close(y_t, y_j, 1e-4)
        _close(st_t, st_j, 1e-4)
        return
    np.testing.assert_allclose(y_t.to(torch.float32).numpy(),
                               np.asarray(y_j, np.float32), atol=1e-3,
                               rtol=2.0 ** -7)
    _close(st_t, st_j, 1e-3)


def test_intra_states_adapter_matches_the_y_adapter():
    """make_intra_states_fn's y is make_intra_fn's, and its states are the
    plain version's, laid out (B, K, H, N, P) for the recurrence."""
    rng = np.random.default_rng(9)
    B, K, C, H, P, N = 2, 3, 64, 4, 32, 16
    xc, a_t, Bc, Cc, dtc = (torch.from_numpy(a.astype(np.float32)) for a in (
        rng.standard_normal((B, K, C, H, P)),
        -np.abs(rng.standard_normal((B, K, H, C))) * 0.1,
        rng.standard_normal((B, K, C, N)), rng.standard_normal((B, K, C, N)),
        np.abs(rng.standard_normal((B, K, C, H))) * 0.1))
    y, st = tss.make_intra_states_fn()(xc, a_t, Bc, Cc, dtc)
    assert tuple(st.shape) == (B, K, H, N, P)
    torch.testing.assert_close(y, tss.make_intra_fn()(xc, a_t, Bc, Cc, dtc),
                               rtol=0, atol=0)
    _, st_plain = tref.ssd_intra_chunk_ref(
        xc.permute(0, 1, 3, 2, 4).reshape(B * K, H, C, P),
        a_t.reshape(B * K, H, C), Bc.reshape(B * K, C, N),
        Cc.reshape(B * K, C, N), dtc.permute(0, 1, 3, 2).reshape(B * K, H, C))
    torch.testing.assert_close(st.reshape(B * K, H, N, P), st_plain, rtol=0,
                               atol=0)


def test_ssd_chunked_takes_one_hook():
    x = torch.zeros((1, 64, 2, 32))
    with pytest.raises(ValueError, match="not both"):
        t_ssd_chunked(x, torch.zeros((1, 64, 2)), -torch.ones(2),
                      torch.zeros((1, 64, 16)), torch.zeros((1, 64, 16)), 64,
                      intra_fn=tss.make_intra_fn(),
                      intra_states_fn=tss.make_intra_states_fn())
