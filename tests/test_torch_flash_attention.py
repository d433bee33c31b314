"""The port's flash-attention wrappers (``repro_torch.kernels.
flash_attention``) against the reference on the CPU.

On the CPU each wrapper runs its plain version; the reference side runs
its jnp oracle (``repro.kernels.ref``), the Pallas kernel in interpret
mode at one shape (``tests/test_kernels.py`` already pins Pallas to the
oracle over the sweep), and ``models.layers.attention_core`` for the
(B, S, H, D) adapter. The CUDA kernel itself is held against the same
plain version on the card by ``chip_smoke.py``. Tolerances: the
reference's own, 2e-5 at f32 and 2e-2 at bf16 (inputs rounded to bf16
once, for both sides); 1e-4 for the adapter against attention_core.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref as rref
from repro.models.layers import attention_core
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref

TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DTYPE = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SWEEP = [(4, 256, 256, 64), (2, 200, 200, 64), (2, 128, 384, 128),
         (1, 512, 512, 64), (3, 130, 257, 128)]


def _inputs(rng, dtype, *shapes):
    """The same arrays for both sides, rounded to ``dtype`` once."""
    out = []
    for shape in shapes:
        a = rng.standard_normal(shape).astype(np.float32)
        if dtype == "bfloat16":
            a = a.astype(ml_dtypes.bfloat16).astype(np.float32)
        out.append((jnp.asarray(a).astype(dtype),
                    torch.from_numpy(a).to(TORCH_DTYPE[dtype])))
    return out


def _close(t, j, tol):
    np.testing.assert_allclose(t.to(torch.float32).numpy(),
                               np.asarray(j, np.float32), atol=tol)


@pytest.mark.parametrize("BH,Sq,Sk,D", SWEEP)
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 100)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_oracle(BH, Sq, Sk, D, causal, window,
                                        dtype):
    rng = np.random.default_rng(BH * 1000 + Sq + Sk + D)
    (qj, qt), (kj, kt), (vj, vt) = _inputs(rng, dtype, (BH, Sq, D),
                                           (BH, Sk, D), (BH, Sk, D))
    before = tfa.launches
    got = tfa.flash_attention(qt, kt, vt, causal=causal, window=window)
    assert tfa.launches == before  # the CPU runs the plain version
    assert got.dtype == qt.dtype and tuple(got.shape) == (BH, Sq, D)
    exp = rref.flash_attention_ref(qj, kj, vj, causal=causal, window=window)
    _close(got, exp, TOL[dtype])


def test_plain_matches_pallas_interpret():
    rng = np.random.default_rng(9)
    (qj, qt), (kj, kt), (vj, vt) = _inputs(rng, "float32", (2, 200, 64),
                                           (2, 200, 64), (2, 200, 64))
    exp = ops.flash_attention(qj, kj, vj, causal=True, window=100,
                              interpret=True)
    got = tref.flash_attention_ref(qt, kt, vt, causal=True, window=100)
    _close(got, exp, TOL["float32"])


@pytest.mark.parametrize("causal,window,q_offset", [(True, 0, 0),
                                                    (True, 40, 0),
                                                    (True, 0, 64),
                                                    (False, 0, 0)])
def test_bshd_adapter_matches_attention_core(causal, window, q_offset):
    """GQA (8 query heads over 2 kv heads) in the model's layout."""
    rng = np.random.default_rng(1)
    B, Sq, Sk, H, Hkv, D = 2, 192, 256, 8, 2, 64
    (qj, qt), (kj, kt), (vj, vt) = _inputs(
        rng, "float32", (B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D))
    got = tfa.flash_attention_bshd(qt, kt, vt, causal=causal, window=window,
                                   q_offset=q_offset)
    exp = attention_core(qj, kj, vj, causal=causal, window=window,
                         q_offset=q_offset)
    assert tuple(got.shape) == exp.shape
    _close(got, exp, 1e-4)
