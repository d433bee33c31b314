"""The flash-attention backward of the port on the CPU: its plain version
(``repro_torch.kernels.ref.flash_attention_bwd_ref``, FlashAttention-2's
formula written out) against torch autograd of the plain forward and
against ``jax.vjp`` of the reference's plain attention
(``repro.models.layers.attention_core``, which the reference trains
through), and the ``torch.autograd.Function`` that puts the CUDA kernels
on the training path.

Shapes cover causal, non-causal, a sliding window, a ``q_offset``, GQA 7/1
(qwen2-0.5b's 14 over 2) and 2/1, and lengths that are not multiples of
the kernels' 64-row tiles. Tolerance 1e-5 (f32 sums in another order).
The CUDA kernels themselves run only on the card, where ``chip_smoke.py``
holds them against this plain version; here the Function's plumbing runs
with the two launches replaced by their plain versions (the forward's
per-row logsumexp asked for only when an input requires grad, gradients
of the (BH, S, D) wrapper through its views), and the bf16 kernel's
roundings (P and dS to bf16 before their second product, f32 sums) are
emulated and held to the card check's 2e-2 of the largest gradient.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers import attention_core
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ref as tref

TOL = 1e-5
#: (B, Sq, Sk, H, Hkv, D, causal, window, q_offset)
SHAPES = [(2, 128, 128, 4, 2, 64, True, 0, 0),
          (1, 100, 100, 14, 2, 64, True, 0, 0),
          (2, 70, 70, 7, 1, 16, True, 0, 0),
          (1, 96, 160, 4, 4, 32, True, 0, 64),
          (2, 130, 130, 2, 1, 32, True, 48, 0),
          (1, 65, 200, 6, 3, 16, True, 40, 135),
          (2, 77, 91, 4, 2, 32, False, 0, 0)]
IDS = [f"B{s[0]}-Sq{s[1]}-Sk{s[2]}-H{s[3]}/{s[4]}-D{s[5]}"
       f"{'-causal' if s[6] else ''}{f'-w{s[7]}' if s[7] else ''}"
       f"{f'-off{s[8]}' if s[8] else ''}" for s in SHAPES]


def _inputs(shape, seed):
    B, Sq, Sk, H, Hkv, D = shape[:6]
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D),
                      (B, Sq, H, D))]


def _mask(shape):
    return dict(causal=shape[6], window=shape[7], q_offset=shape[8])


def _torch_autograd(q, k, v, g, mask):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = tref.flash_attention_bshd_ref(qt, kt, vt, **mask)
    grads = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(g))
    return o.detach(), grads


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_backward_matches_torch_autograd(shape):
    q, k, v, g = _inputs(shape, 1)
    mask = _mask(shape)
    o, exp = _torch_autograd(q, k, v, g, mask)
    got = tref.flash_attention_bwd_ref(
        *(torch.from_numpy(a) for a in (q, k, v)), o, torch.from_numpy(g),
        **mask)
    for a, b in zip(got, exp):
        assert a.shape == b.shape and a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=0)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_backward_matches_reference_vjp(shape):
    q, k, v, g = _inputs(shape, 2)
    mask = _mask(shape)
    o, vjp = jax.vjp(lambda a, b, c: attention_core(a, b, c, **mask),
                     *(jnp.asarray(a) for a in (q, k, v)))
    exp = vjp(jnp.asarray(g))
    got = tref.flash_attention_bwd_ref(
        *(torch.from_numpy(a) for a in (q, k, v)),
        torch.from_numpy(np.array(o)), torch.from_numpy(g), **mask)
    for a, b in zip(got, exp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=0)


def test_plain_backward_takes_the_forward_logsumexp():
    shape = SHAPES[1]
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(shape, 3))
    mask = _mask(shape)
    o = tref.flash_attention_bshd_ref(q, k, v, **mask)
    lse = _lse(q, k, **mask)
    a = tref.flash_attention_bwd_ref(q, k, v, o, g, lse=lse, **mask)
    b = tref.flash_attention_bwd_ref(q, k, v, o, g, **mask)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=TOL, rtol=0)


def test_cpu_wrappers_train_through_the_plain_version():
    """On the CPU both wrappers are their plain versions under autograd:
    no launch, gradients of the reference's attention."""
    shape = SHAPES[2]
    q, k, v, g = _inputs(shape, 4)
    mask = _mask(shape)
    before = (tfa.launches, tfa.bwd_launches)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = tfa.flash_attention_bshd(qt, kt, vt, **mask)
    got = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(g))
    assert (tfa.launches, tfa.bwd_launches) == before
    _, exp = _torch_autograd(q, k, v, g, mask)
    for a, b in zip(got, exp):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# the autograd Function, its launches replaced by their plain versions
# ---------------------------------------------------------------------------

def _lse(q, k, *, causal, window, q_offset):
    """(B, H, Sq) logsumexp of the masked, scaled f32 scores."""
    B, Sq, H, D = q.shape
    kx = torch.repeat_interleave(k.float(), H // k.shape[2], dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx) / math.sqrt(D)
    qp = q_offset + torch.arange(Sq)
    kp = torch.arange(k.shape[1])
    ok = torch.ones((Sq, k.shape[1]), dtype=torch.bool)
    if causal:
        ok &= qp[:, None] >= kp[None]
    if window:
        ok &= qp[:, None] - kp[None] < window
    return torch.logsumexp(torch.where(ok, s, torch.tensor(-1e30)), -1)


@pytest.fixture
def plain_launches(monkeypatch):
    """The Function's two launches as their plain versions; records the
    calls."""
    calls = []

    def launch(q, k, v, out, causal, window, q_offset, lse=None):
        calls.append(("fwd", lse is not None))
        out.copy_(tref.flash_attention_bshd_ref(
            q, k, v, causal=causal, window=window, q_offset=q_offset))
        if lse is not None:
            lse.copy_(_lse(q, k, causal=causal, window=window,
                           q_offset=q_offset))

    def launch_bwd(q, k, v, out, dout, lse, causal, window, q_offset):
        calls.append(("bwd", tuple(dout.shape), dout.is_contiguous()))
        return tref.flash_attention_bwd_ref(
            q, k, v, out, dout, causal=causal, window=window,
            q_offset=q_offset, lse=lse)

    monkeypatch.setattr(tfa, "_launch", launch)
    monkeypatch.setattr(tfa, "_launch_bwd", launch_bwd)
    return calls


@pytest.mark.parametrize("shape", [SHAPES[2], SHAPES[5]], ids=[IDS[2],
                                                               IDS[5]])
def test_function_gradients(plain_launches, shape):
    q, k, v, g = _inputs(shape, 5)
    mask = _mask(shape)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = tfa._FlashAttention.apply(qt, kt, vt, mask["causal"], mask["window"],
                                  mask["q_offset"])
    # a strided gradient, as the output projection may hand back
    gt = torch.from_numpy(np.ascontiguousarray(g.transpose(0, 2, 1, 3))
                          ).transpose(1, 2)
    got = torch.autograd.grad(o, (qt, kt, vt), gt)
    assert plain_launches == [("fwd", True), ("bwd", o.shape, True)]
    o_ref, exp = _torch_autograd(q, k, v, g, mask)
    np.testing.assert_allclose(o.detach().numpy(), o_ref.numpy(), atol=TOL)
    for a, b in zip(got, exp):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=0)


def test_inference_asks_for_no_logsumexp(plain_launches, monkeypatch):
    """Through the wrapper's card path (the device check bypassed): one
    plain forward launch, without the logsumexp, unless autograd records
    an input that requires grad."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(SHAPES[2], 6))
    with torch.no_grad():
        tfa._attend(q.requires_grad_(True), k, v, True, 0, 0)
    tfa._attend(q.detach(), k, v, True, 0, 0)
    o = tfa._attend(q.requires_grad_(True), k, v, True, 0, 0)
    assert o.requires_grad
    assert plain_launches == [("fwd", False), ("fwd", False), ("fwd", True)]


def test_function_through_the_bh_views(plain_launches):
    """The (BH, S, D) wrapper's views: gradients come back in (BH, S, D)."""
    rng = np.random.default_rng(8)
    q, k, v, g = (rng.standard_normal((6, 70, 16)).astype(np.float32)
                  for _ in range(4))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = tfa._FlashAttention.apply(qt[:, :, None], kt[:, :, None],
                                  vt[:, :, None], True, 0, 0)[:, :, 0]
    got = torch.autograd.grad(o, (qt, kt, vt), torch.from_numpy(g))
    qr, kr, vr = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    exp = torch.autograd.grad(tref.flash_attention_ref(qr, kr, vr),
                              (qr, kr, vr), torch.from_numpy(g))
    for a, b in zip(got, exp):
        assert a.shape == (6, 70, 16)
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=0)


# ---------------------------------------------------------------------------
# the bf16 kernel's roundings, emulated
# ---------------------------------------------------------------------------

def _bwd_bf16_emulated(q, k, v, o, g, lse, *, causal, window, q_offset):
    """The bf16 kernels' arithmetic in plain torch: bf16 operands, f32
    sums, P rounded to bf16 before dV = Pᵀ dO and dS rounded to bf16
    before dQ = dS K and dK = dSᵀ Q, D_i from the bf16 o and dO."""
    f32, bf = torch.float32, torch.bfloat16
    B, Sq, H, D = q.shape
    G = H // k.shape[2]
    scale = float(np.float32(1.0 / math.sqrt(D)))
    qf, gf, of = (t.to(f32) for t in (q, g, o))
    kf = torch.repeat_interleave(k.to(f32), G, 2)
    vf = torch.repeat_interleave(v.to(f32), G, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
    qp = q_offset + torch.arange(Sq)
    kp = torch.arange(k.shape[1])
    ok = torch.ones((Sq, k.shape[1]), dtype=torch.bool)
    if causal:
        ok &= qp[:, None] >= kp[None]
    if window:
        ok &= qp[:, None] - kp[None] < window
    p = torch.where(ok, torch.exp(s * scale - lse[..., None]),
                    torch.zeros(()))
    delta = (gf * of).sum(-1).transpose(1, 2)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", gf, vf) - delta[..., None])
    pb, dsb = p.to(bf).to(f32), ds.to(bf).to(f32)
    dq = torch.einsum("bhqk,bkhd->bqhd", dsb, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", dsb, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", pb, gf)
    Hkv = k.shape[2]
    dk = dk.reshape(B, -1, Hkv, G, D).sum(3)
    dv = dv.reshape(B, -1, Hkv, G, D).sum(3)
    return dq.to(bf), dk.to(bf), dv.to(bf)


def test_bf16_roundings_within_the_card_check():
    """At qwen2-0.5b's heads (14 over 2 of 64), causal, the bf16 kernel's
    roundings keep each gradient within 2e-2 of its largest entry."""
    shape = (1, 256, 256, 14, 2, 64, True, 0, 0)
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in _inputs(shape, 9))
    mask = _mask(shape)
    o = tref.flash_attention_bshd_ref(q, k, v, **mask)
    lse = _lse(q, k, **mask)
    got = _bwd_bf16_emulated(q, k, v, o, g, lse, **mask)
    exp = tref.flash_attention_bwd_ref(q.float(), k.float(), v.float(),
                                       o.float(), g.float(), lse=lse, **mask)
    for a, b in zip(got, exp):
        err = float((a.float() - b).abs().max())
        assert err <= 2e-2 * float(b.abs().max()), err


@pytest.mark.parametrize("shape", [SHAPES[0], SHAPES[5]], ids=[IDS[0],
                                                               IDS[5]])
def test_public_wrappers_on_cpu(shape):
    """``flash_attention_lse`` (whose logsumexp the card check holds
    against its plain version) and the gradients of
    ``flash_attention_bshd`` (which the card check takes through
    autograd) are their plain versions on the CPU: no launch."""
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(shape, 10))
    mask = _mask(shape)
    before = (tfa.launches, tfa.bwd_launches)
    o, lse = tfa.flash_attention_lse(q, k, v, **mask)
    assert lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    np.testing.assert_allclose(lse.numpy(), _lse(q, k, **mask).numpy(),
                               atol=TOL, rtol=0)
    np.testing.assert_allclose(
        o.numpy(), tref.flash_attention_bshd_ref(q, k, v, **mask).numpy(),
        atol=TOL, rtol=0)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    got = torch.autograd.grad(tfa.flash_attention_bshd(*leaves, **mask),
                              leaves, g)
    exp = tref.flash_attention_bwd_ref(q, k, v, o, g, **mask)
    assert (tfa.launches, tfa.bwd_launches) == before
    for a, b in zip(got, exp):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=TOL, rtol=0)
