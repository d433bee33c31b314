"""B5's backward (the SSD intra-chunk block's gradients) on the CPU.

``repro_torch.kernels.ref.ssd_intra_chunk_bwd_ref``, the plain version
the card's kernel (``csrc/ssd_scan_bwd.cu``) is held to by
``chip_smoke.py``, against ``jax.vjp`` of the reference's oracle
(``repro.kernels.ref.ssd_intra_chunk_ref``) and against torch autograd
of the port's plain forward, in f32 within 1e-5 (rtol, and atol 1e-5 of
each gradient's largest entry: both sides sum in f32 in other orders,
and against an f64 evaluation each is off by up to 6e-7 of that entry,
so that da, a reverse cumulative sum of differences, and ddt, whose
entries reach several hundred at these inputs, miss a bare 1e-5), over
shapes with C 64/128/256, N 16/64/128, P 32/64 and
several heads (dB and dC sum over them), with and without a states
gradient. Then the autograd plumbing of ``kernels.ssd_scan``
(``_SSDIntraChunk``) with its two launches replaced by the plain
versions: gradients through the (B, K, C, H, P) strided adapter, a states
gradient of None, inference taking no backward, and ``ssd_chunked``'s
gradients through the Function equal to its plain path's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as rref
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as tss
from repro_torch.models.ssm import ssd_chunked as t_ssd_chunked

TOL = 1e-5
#: (BK, H, C, P, N)
SHAPES = [(2, 3, 64, 32, 16), (1, 2, 256, 64, 64), (2, 2, 128, 32, 128),
          (1, 3, 64, 64, 128)]
IDS = ["C64-N16-P32", "C256-N64-P64", "C128-N128-P32", "C64-N128-P64"]


@pytest.fixture(autouse=True, scope="module")
def _first_exp_of_the_process():
    """The first multi-threaded ``torch.exp`` of a process may return one
    thread's chunk off by about 1.5e-4 (ROADMAP C2; see
    tests/test_torch_ssd_scan.py): take that call before any is
    measured."""
    torch.exp(torch.zeros(1 << 20))


def _inputs(seed, BK, H, C, P, N):
    """x, a, B, C, dt as the reference's kernel tests draw them, then the
    cotangents dy and dst (f32 numpy)."""
    rng = np.random.default_rng(seed)
    return [a.astype(np.float32) for a in (
        rng.standard_normal((BK, H, C, P)),
        -np.abs(rng.standard_normal((BK, H, C))) * 0.1,
        rng.standard_normal((BK, C, N)),
        rng.standard_normal((BK, C, N)),
        np.abs(rng.standard_normal((BK, H, C))) * 0.1,
        rng.standard_normal((BK, H, C, P)),
        rng.standard_normal((BK, H, N, P)))]


def _close(got, exp, what):
    """Within TOL elementwise, atol TOL of the largest |exp|."""
    assert tuple(got.shape) == tuple(np.shape(exp)), what
    exp = np.asarray(exp)
    np.testing.assert_allclose(got.detach().numpy(), exp,
                               atol=TOL * float(np.abs(exp).max()),
                               rtol=TOL, err_msg=what)


NAMES = ("dx", "da", "dB", "dC", "ddt")


@pytest.mark.parametrize("states", [True, False], ids=["dst", "no-dst"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_backward_matches_jax_vjp(shape, states):
    x, a, Bm, Cm, d, dy, dst = _inputs(1, *shape)
    _, vjp = jax.vjp(rref.ssd_intra_chunk_ref, *(jnp.asarray(t) for t in
                                                 (x, a, Bm, Cm, d)))
    exp = vjp((jnp.asarray(dy), jnp.asarray(dst if states else
                                            np.zeros_like(dst))))
    got = tref.ssd_intra_chunk_bwd_ref(
        *(torch.from_numpy(t) for t in (x, a, Bm, Cm, d, dy)),
        torch.from_numpy(dst) if states else None)
    for name, g, e in zip(NAMES, got, exp):
        assert g.dtype == torch.float32
        _close(g, e, name)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_plain_backward_matches_torch_autograd(shape):
    x, a, Bm, Cm, d, dy, dst = (torch.from_numpy(t) for t in
                                _inputs(2, *shape))
    leaves = [t.clone().requires_grad_(True) for t in (x, a, Bm, Cm, d)]
    exp = torch.autograd.grad(tref.ssd_intra_chunk_ref(*leaves), leaves,
                              (dy, dst))
    got = tref.ssd_intra_chunk_bwd_ref(x, a, Bm, Cm, d, dy, dst)
    for name, g, e in zip(NAMES, got, exp):
        _close(g, e, name)


def test_plain_backward_keeps_the_input_dtypes():
    x, a, Bm, Cm, d, dy, dst = (torch.from_numpy(t) for t in
                                _inputs(3, 1, 2, 64, 32, 16))
    bf = torch.bfloat16
    got = tref.ssd_intra_chunk_bwd_ref(x.to(bf), a, Bm.to(bf), Cm.to(bf), d,
                                       dy, dst)
    assert [g.dtype for g in got] == [bf, torch.float32, bf, bf,
                                      torch.float32]
    assert all(bool(torch.isfinite(g.float()).all()) for g in got)


# ---------------------------------------------------------------------------
# the autograd Function, its launches replaced by the plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def plain_launches(monkeypatch):
    """``_launch`` and ``_launch_bwd`` of kernels.ssd_scan as their plain
    versions on the CPU; returns the list of calls made."""
    calls = []

    def launch(x, a, Bc, Cc, dt, y, st):
        calls.append(("fwd", y.stride()))
        y0, s0 = tref.ssd_intra_chunk_ref(x, a, Bc, Cc, dt)
        y.copy_(y0)
        st.copy_(s0)

    def launch_bwd(x, a, Bc, Cc, dt, dy, dst):
        calls.append(("bwd", dst is None, dy.stride(-1)))
        return tref.ssd_intra_chunk_bwd_ref(x, a, Bc, Cc, dt, dy, dst)

    monkeypatch.setattr(tss, "_launch", launch)
    monkeypatch.setattr(tss, "_launch_bwd", launch_bwd)
    return calls


def test_function_gradients(plain_launches):
    x, a, Bm, Cm, d, dy, dst = (torch.from_numpy(t) for t in
                                _inputs(4, 2, 3, 128, 32, 16))
    leaves = [t.clone().requires_grad_(True) for t in (x, a, Bm, Cm, d)]
    y, st = tss._SSDIntraChunk.apply(*leaves)
    got = torch.autograd.grad((y, st), leaves, (dy, dst))
    assert plain_launches == [("fwd", y.stride()), ("bwd", False, 1)]
    ref_leaves = [t.clone().requires_grad_(True) for t in (x, a, Bm, Cm, d)]
    exp = torch.autograd.grad(tref.ssd_intra_chunk_ref(*ref_leaves),
                              ref_leaves, (dy, dst))
    for name, g, e in zip(NAMES, got, exp):
        _close(g, e, name)


def _model_layout(seed, B=2, K=2, C=64, H=3, P=32, N=16):
    """xc, Bc, Cc as (B, K, C, ...) views of one conv output (the model's
    layout), dtc and a_t as the model makes them, all leaves' parents
    requiring grad; returns (leaves, adapter args)."""
    rng = np.random.default_rng(seed)
    xBC = torch.from_numpy(rng.standard_normal(
        (B, K * C, H * P + 2 * N)).astype(np.float32)).requires_grad_(True)
    dtv = torch.from_numpy(np.abs(rng.standard_normal(
        (B, K * C, H))).astype(np.float32) * 0.1).requires_grad_(True)
    A = torch.from_numpy(-np.abs(rng.standard_normal(H)).astype(
        np.float32)).requires_grad_(True)
    xv, Bv, Cv = torch.split(xBC, [H * P, N, N], dim=-1)
    dtc = dtv.reshape(B, K, C, H)
    a_t = (dtc * A).permute(0, 1, 3, 2)
    args = (xv.reshape(B, K, C, H, P), a_t, Bv.reshape(B, K, C, N),
            Cv.reshape(B, K, C, N), dtc)
    return (xBC, dtv, A), args


@pytest.mark.parametrize("keep_states", [True, False],
                         ids=["y-and-states", "y-only"])
def test_strided_adapter_gradients(plain_launches, keep_states):
    """``_intra_kernel`` (what ``make_intra_states_fn`` and
    ``make_intra_fn`` launch on the card) in the model's strided layout:
    y comes back (B, K, C, H, P) from a (BK, C, H, P) buffer, and the
    gradients of the conv output, dt and A equal autograd of the plain
    adapter's. With y alone (``make_intra_fn`` drops the states) the
    backward gets a states gradient of None."""
    leaves, args = _model_layout(5)
    y, st = tss._intra_kernel(*args)
    assert y.shape == args[0].shape and y.is_contiguous()
    rng = np.random.default_rng(6)
    gy = torch.from_numpy(rng.standard_normal(y.shape).astype(np.float32))
    gs = torch.from_numpy(rng.standard_normal(st.shape).astype(np.float32))
    loss = (y * gy).sum() + ((st * gs).sum() if keep_states else 0.0)
    got = torch.autograd.grad(loss, leaves)
    assert [c[0] for c in plain_launches] == ["fwd", "bwd"]
    assert plain_launches[1][1] == (not keep_states)
    # the forward wrote y through the (BK, H, C, P) view of (BK, C, H, P)
    B, K, C, H, P = args[0].shape
    assert plain_launches[0][1] == (C * H * P, P, H * P, 1)
    ref_leaves, ref_args = _model_layout(5)
    y0, s0 = tref.ssd_intra_states_fn_ref(*ref_args)
    ref_loss = (y0 * gy).sum() + ((s0 * gs).sum() if keep_states else 0.0)
    exp = torch.autograd.grad(ref_loss, ref_leaves)
    for name, g, e in zip(("xBC", "dt", "A"), got, exp):
        _close(g, e, name)


def test_inference_takes_no_backward(plain_launches):
    """No grad recorded: one plain forward launch, no Function; an input
    that requires grad under autograd goes through the Function."""
    _, args = _model_layout(7)
    with torch.no_grad():
        y, _ = tss._intra_kernel(*args)
    assert not y.requires_grad
    y, _ = tss._intra_kernel(*(t.detach() for t in args))
    assert not y.requires_grad
    y, _ = tss._intra_kernel(*args)
    assert y.requires_grad and y.grad_fn is not None
    assert [c[0] for c in plain_launches] == ["fwd"] * 3


@pytest.mark.parametrize("S,init_state", [(128, False), (96, True)],
                         ids=["whole-chunks", "padded-initial-state"])
def test_ssd_chunked_gradients_through_the_function(plain_launches, S,
                                                    init_state):
    """``ssd_chunked`` with the hook a CUDA tensor takes (its launches the
    plain versions here) against its plain einsum path: the gradients of
    x, dt, A, B, C and the initial state, f32 within 1e-5."""
    rng = np.random.default_rng(S)
    B, H, P, N, chunk = 2, 3, 32, 16, 64
    arrays = [rng.standard_normal((B, S, H, P)),
              np.abs(rng.standard_normal((B, S, H))) * 0.1,
              -np.abs(rng.standard_normal((H,))),
              rng.standard_normal((B, S, N)), rng.standard_normal((B, S, N)),
              rng.standard_normal((B, H, P, N))]
    gy = torch.from_numpy(rng.standard_normal((B, S, H, P)).astype(
        np.float32))
    gs = torch.from_numpy(rng.standard_normal((B, H, P, N)).astype(
        np.float32))

    def grads(hook):
        ins = [torch.from_numpy(a.astype(np.float32)).requires_grad_(True)
               for a in arrays]
        kw = {"initial_state": ins[5]} if init_state else {}
        y, fin = t_ssd_chunked(*ins[:5], chunk, intra_states_fn=hook, **kw)
        loss = (y * gy).sum() + (fin * gs).sum()
        used = ins if init_state else ins[:5]
        return loss.detach(), torch.autograd.grad(loss, used)

    l0, exp = grads(None)
    l1, got = grads(tss._intra_kernel)
    assert [c[0] for c in plain_launches] == ["fwd", "bwd"]
    np.testing.assert_allclose(float(l1), float(l0), rtol=TOL)
    for name, g, e in zip(("x", "dt", "A", "B", "C", "s0"), got, exp):
        _close(g, e, name)
