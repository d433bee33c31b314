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
