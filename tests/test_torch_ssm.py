"""The port's Mamba-2 block (``repro_torch.models.ssm``) against the
reference (``repro.models.ssm``) on the CPU, at f32 (reduced
mamba2-2.7b: d 256, N 16, 8 heads of 64, chunk 64).

Same numpy inputs on both sides; block parameters are the reference's
init with A_log, dt_bias and D drawn at random (the init's zeros and
ones would hide them). Tolerance 1e-5 for the conv, 1e-4 for the SSD and
the blocks (a cumsum and exp over a chunk and a recurrence over chunks,
summed in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_model_config as r_config
from repro.models import ssm as RS
from repro_torch.configs import get_model_config as t_config
from repro_torch.convert import tree_from_numpy
from repro_torch.models import ssm as TS

RC = r_config("mamba2-2.7b").reduced()
TC = t_config("mamba2-2.7b").reduced()


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _close(t, j, tol):
    np.testing.assert_allclose(t.detach().to(torch.float32).numpy(),
                               np.asarray(j, np.float32), atol=tol, rtol=tol)


def _mamba_params(seed):
    host = jax.device_get(RS.init_mamba(jax.random.PRNGKey(seed), RC)[0])
    rng = np.random.default_rng(seed)
    H = RC.ssm_heads
    host["A_log"] = _rand(rng, H, scale=0.5)
    host["dt_bias"] = _rand(rng, H, scale=0.5)
    host["D"] = _rand(rng, H)
    host["conv_b"] = _rand(rng, *host["conv_b"].shape, scale=0.1)
    return jax.tree.map(jnp.asarray, host), tree_from_numpy(host)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state):
    rng = np.random.default_rng(0)
    x, w, b = _rand(rng, 2, 9, 12), _rand(rng, 4, 12), _rand(rng, 12)
    st = _rand(rng, 2, 3, 12) if with_state else None
    yt, st_t = TS._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b),
                               None if st is None else torch.from_numpy(st))
    yj, st_j = RS._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               None if st is None else jnp.asarray(st))
    _close(yt, yj, 1e-5)
    _close(st_t, st_j, 0)


@pytest.mark.parametrize("S,init_state", [(128, False), (100, True),
                                          (37, True)])
def test_ssd_chunked(S, init_state):
    rng = np.random.default_rng(S)
    B, H, P, N, chunk = 2, 4, 32, 16, 64
    x = _rand(rng, B, S, H, P)
    dtv = np.abs(_rand(rng, B, S, H, scale=0.1))
    A = -np.abs(_rand(rng, H))
    Bm, Cm = _rand(rng, B, S, N), _rand(rng, B, S, N)
    s0 = _rand(rng, B, H, P, N) if init_state else None
    args = (x, dtv, A, Bm, Cm)
    yt, ft = TS.ssd_chunked(*map(torch.from_numpy, args), chunk,
                            initial_state=None if s0 is None
                            else torch.from_numpy(s0))
    yj, fj = RS.ssd_chunked(*map(jnp.asarray, args), chunk,
                            initial_state=None if s0 is None
                            else jnp.asarray(s0))
    assert tuple(yt.shape) == yj.shape and tuple(ft.shape) == fj.shape
    _close(yt, yj, 1e-4)
    _close(ft, fj, 1e-4)


def test_apply_mamba():
    jp, tp = _mamba_params(1)
    u = _rand(np.random.default_rng(1), 2, 100, RC.d_model)
    _close(TS.apply_mamba(TC, tp, torch.from_numpy(u)),
           RS.apply_mamba(RC, jp, jnp.asarray(u)), 1e-4)


def test_decode_mamba_steps():
    """Three recurrent steps from a random state; the states and outputs
    follow the reference's step for step."""
    jp, tp = _mamba_params(2)
    rng = np.random.default_rng(2)
    H, P, N = RC.ssm_heads, RC.ssm_head_dim, RC.ssm_state
    conv_ch = RC.ssm_inner + 2 * N
    st, cs = _rand(rng, 2, H, P, N), _rand(rng, 2, 3, conv_ch)
    sj, cj = jnp.asarray(st), jnp.asarray(cs)
    s_t, c_t = torch.from_numpy(st), torch.from_numpy(cs)
    for _ in range(3):
        u = _rand(rng, 2, 1, RC.d_model)
        yj, sj, cj = RS.decode_mamba(RC, jp, jnp.asarray(u), sj, cj)
        yt, s_t, c_t = TS.decode_mamba(TC, tp, torch.from_numpy(u), s_t, c_t)
        _close(yt, yj, 1e-4)
        _close(s_t, sj, 1e-4)
        _close(c_t, cj, 1e-5)
