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


# ---------------------------------------------------------------------------
# the bf16 card kernel's arithmetic, emulated in plain torch
# ---------------------------------------------------------------------------

BQ, BK = 192, 64           # query rows a block, keys a tile
LOG2E = 1.4426950408889634


def _bf16_split(p):
    """p as bf16 hi + bf16 lo, each widened back to f32."""
    hi = p.to(torch.bfloat16).to(torch.float32)
    return hi, (p - hi).to(torch.bfloat16).to(torch.float32)


def _kernel_bf16(q, k, v, *, causal, window=0, q_offset=0):
    """``flash_attention_tma_kernel`` in plain torch: 192-row blocks over
    64-key tiles in the block's range (tiles wholly masked for the block
    skipped), scores in the log2 domain (scale·log2(e) folded in, the
    -1e30 sentinel, exp2), P·V with P as a bf16 pair hi + lo against the
    bf16 v (exact products, f32 sums), o / max(l, 1e-30) rounded to bf16.
    q: (BH, Sq, D), k/v: (BH, Sk, D), all bf16."""
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    scale = np.float32(1.0 / np.sqrt(D))
    scale_log2 = torch.tensor(scale * np.float32(LOG2E), dtype=torch.float32)
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    out = torch.empty((BH, Sq, D), dtype=torch.bfloat16)
    for q0 in range(0, Sq, BQ):
        rows = min(BQ, Sq - q0)
        qlo, qhi = q_offset + q0, q_offset + q0 + rows - 1
        kt_end = -(-Sk // BK)
        if causal:
            kt_end = min(kt_end, qhi // BK + 1)
        kt_begin = 0
        if window > 0 and qlo - window + 1 > 0:
            kt_begin = min(kt_end, (qlo - window + 1) // BK)
        qpos = q_offset + q0 + torch.arange(rows)
        m = torch.full((BH, rows), -1e30)
        l = torch.zeros((BH, rows))
        o = torch.zeros((BH, rows, D))
        for kt in range(kt_begin, kt_end):
            k0 = kt * BK
            kpos = k0 + torch.arange(BK)
            kb = torch.zeros((BH, BK, D))          # TMA zero-fill past Sk
            vb = torch.zeros((BH, BK, D))
            n = min(BK, Sk - k0)
            kb[:, :n], vb[:, :n] = kf[:, k0:k0 + n], vf[:, k0:k0 + n]
            s = (qf[:, q0:q0 + rows] @ kb.transpose(1, 2)) * scale_log2
            ok = (kpos[None] < Sk).expand(rows, BK)
            if causal:
                ok = ok & (qpos[:, None] >= kpos[None])
            if window > 0:
                ok = ok & (qpos[:, None] - kpos[None] < window)
            s = torch.where(ok[None], s, torch.tensor(-1e30))
            m_new = torch.maximum(m, s.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s - m_new[..., None])
            l = l * corr + p.sum(-1)
            hi, lo = _bf16_split(p)
            o = o * corr[..., None] + (lo @ vb + hi @ vb)
            m = m_new
        out[:, q0:q0 + rows] = (o / l.clamp_min(1e-30)[..., None]).to(
            torch.bfloat16)
    return out


@pytest.mark.parametrize("BH,Sq,Sk,D", SWEEP)
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 100)])
def test_kernel_bf16_arithmetic_matches_reference_oracle(BH, Sq, Sk, D,
                                                         causal, window):
    """The bf16 kernel's tiling, log2-domain softmax and hi + lo P·V
    against the reference's oracle run through JAX, at the sweep's bf16
    tolerance (2e-2)."""
    rng = np.random.default_rng(BH * 1000 + Sq + Sk + D + 1)
    (qj, qt), (kj, kt), (vj, vt) = _inputs(rng, "bfloat16", (BH, Sq, D),
                                           (BH, Sk, D), (BH, Sk, D))
    got = _kernel_bf16(qt, kt, vt, causal=causal, window=window)
    exp = rref.flash_attention_ref(qj, kj, vj, causal=causal, window=window)
    _close(got, exp, TOL["bfloat16"])


def test_kernel_bf16_arithmetic_at_large_outputs():
    """Where |o| >= 4 one bf16 step is 2^-5 > 2e-2: with P as hi + lo the
    emulated kernel stays within one f32-rounding flip of the oracle's
    bf16 output (1e-3 + 2^-7·|o|, the prefill-shape bound) and within 2e-2
    on most rows, with D = 80 (the Zamba2 head), a ragged Sq, a window
    and a q_offset."""
    rng = np.random.default_rng(4)
    Sq, Sk, D = 200, 328, 80
    (qj, qt), (kj, kt), (vj, vt) = _inputs(rng, "bfloat16", (2, Sq, D),
                                           (2, Sk, D), (2, Sk, D))
    vt = (vt.float() * 6).to(torch.bfloat16)
    vj = jnp.asarray(vt.float().numpy()).astype("bfloat16")
    for causal, window, off in ((True, 0, 128), (True, 96, 64),
                                (False, 0, 0)):
        got = _kernel_bf16(qt, kt, vt, causal=causal, window=window,
                           q_offset=off).float().numpy()
        exp = np.asarray(rref.flash_attention_ref(
            qj, kj, vj, causal=causal, window=window, q_offset=off),
            np.float32)
        np.testing.assert_allclose(got, exp, atol=1e-3, rtol=2.0 ** -7)
        assert (np.abs(got - exp) <= TOL["bfloat16"]).mean() > 0.999


def _bshd(shape, dtype=torch.bfloat16, offset=0):
    """A (B, S, H, D) tensor at ``offset`` elements into its storage."""
    n = int(np.prod(shape))
    return torch.zeros(n + offset, dtype=dtype)[offset:].view(shape)


def test_bf16_layouts_the_kernel_takes():
    """Which bf16 layouts the wgmma + TMA kernel takes; every other bf16
    layout raises (no other bf16 kernel exists)."""
    q = _bshd((2, 64, 8, 80))
    kv = _bshd((2, 64, 2, 80))
    assert tfa.bf16_refusal(q, kv, kv, q) is None
    # the model's views: q, k, v as slices of one fused projection
    fused = _bshd((2, 64, 12, 80))
    qv, kv_, vv = fused[:, :, :8], fused[:, :, 8:10], fused[:, :, 10:]
    assert tfa.bf16_refusal(qv, kv_, vv, q) is None
    # (BH, S, D) through flash_attention: a head axis of size 1
    q3 = _bshd((4, 64, 64))[:, :, None]
    assert tfa.bf16_refusal(q3, q3, q3, q3) is None
    # an axis of size 1 may carry any stride
    one = torch.zeros((1, 64, 1, 64), dtype=torch.bfloat16).as_strided(
        (1, 64, 1, 64), (3, 64, 5, 1))
    assert tfa.bf16_refusal(one, one, one, one) is None
    refused = {
        "head size": (_bshd((1, 64, 2, 72)),) * 4,
        "16-byte aligned": (_bshd((1, 64, 1, 64), offset=1),) * 4,
        "stride 0 on axis 0": (q, _bshd((1, 64, 2, 80)).expand(
            2, 64, 2, 80), kv, q),
        "stride 84 on axis 1": (_bshd((1, 64, 1, 84))[..., :80], kv[:1],
                                kv[:1], _bshd((1, 64, 1, 80))),
    }
    for what, (a, b, c, d) in refused.items():
        why = tfa.bf16_refusal(a, b, c, d)
        assert why is not None and what in why, (what, why)


def test_bf16_refusal_raises_before_any_launch():
    """A CUDA-less check of the routing: the wrapper's launcher raises on
    a refused bf16 layout before it touches the library (meta tensors:
    the layout is all it reads)."""
    q = torch.empty((1, 64, 2, 72), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        tfa.flash_attention_bshd(q, q, q)
    before = tfa.launches
    with pytest.raises(ValueError, match="head size of 72"):
        tfa._launch(q, q, q, q, True, 0, 0)
    assert tfa.launches == before
