"""The schedule of B5's backward kernels (``csrc/ssd_scan_bwd.cu``),
walked on the CPU in plain f32 torch and held to
``repro_torch.kernels.ref.ssd_intra_chunk_bwd_ref``.

The card's kernels cannot run here, so this walks their decomposition
with the same algebra, to catch an error in it before a card build does:
a block a (chunk, head group, 64-wide column tile jt of j), its rows the
row tiles it >= jt and the virtual rows (the states' gradient as N more
rows, zero past N in their last tile), each tile in the transposed
layout (rows j, columns i) with L formed as the kernel forms it (below
the diagonal tile as exp(cum_i - cum_i0) exp(cum_i0 - cum_j), i0 the
row tile's first row; on it the exponent taken only where i >= j); per
head dx_j, ddt_j and the row sums
of (G M)^T complete in the block, the column sums of (G M)^T and the
virtual rows' total written as the column tile's dcum partial; D^T of
each tile summed over the group's heads and written once a group into
the (groups, BK, C, C + 64 nv) workspace; then the finishing kernels: D
summed over the groups in group order, dB = D^T C + D's virtual rows, dC
= D B, dcum the column tiles' partials in order and da its reverse
cumulative sum. Within 1e-5 of each gradient's largest entry (rtol and
atol, as ``tests/test_torch_ssd_scan_bwd.py``), over C 64/192/256, N
16/64/128, P 32/64/128, with and without a states gradient, in one head
group and in several.
"""
import math
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as tref

TOL = 1e-5
T = 64                 # rows and columns of a tile
TARGET_BLOCKS = 528    # kTargetBlocks of the kernel source
NAMES = ("dx", "da", "dB", "dC", "ddt")


def head_groups(BK, C, H):
    """The kernel's head groups: the fewest that leave TARGET_BLOCKS
    blocks in its tiles kernel."""
    base = BK * (C // T)
    return max(1, min(H, -(-TARGET_BLOCKS // base)))


def workspace_floats(BK, H, C, N, has_dst):
    """``ssd_scan_bwd_workspace``: D's group partials and the part rows."""
    nv = -(-N // T) if has_dst else 0
    return head_groups(BK, C, H) * BK * C * (C + T * nv) + BK * H * (C // T) * C


def tiles_schedule(x, a, Bm, Cm, dt, dy, dst, groups):
    """(dx, da, dB, dC, ddt) as the kernels compute them, f32."""
    BK, H, C, P = x.shape
    N = Bm.shape[-1]
    ntj = C // T
    nv = -(-N // T) if dst is not None else 0
    ld = C + T * nv
    dws = torch.zeros((groups, BK, C, ld))
    part = torch.zeros((BK, H, ntj, C))
    dx = torch.zeros((BK, H, C, P))
    ddt = torch.zeros((BK, H, C))
    ii = torch.arange(T)
    # grid order: column tiles slowest (the longest first), then chunks,
    # then groups
    for blk in range(BK * groups * ntj):
        jt, rest = blk // (BK * groups), blk % (BK * groups)
        grp, bk = rest % groups, rest // groups
        h0 = grp * H // groups
        heads = range(h0, (grp + 1) * H // groups)
        nr = ntj - jt
        npos = nr + nv
        js = slice(T * jt, T * jt + T)
        Bj = Bm[bk, js]                                   # (64 j, N)
        # S^T of the real positions, once a block
        sreal = [Bj @ Cm[bk, T * (jt + p):T * (jt + p) + T].T
                 for p in range(nr)]
        D = torch.zeros((npos, T, T))
        for h in heads:
            cum = torch.cumsum(a[bk, h], 0)
            ev = torch.exp(cum[-1] - cum)
            dtj = dt[bk, h, js][:, None]
            xj = x[bk, h, js]                             # (64 j, P)
            dxj = torch.zeros((T, P))
            rowg = torch.zeros(T)
            rowm = torch.zeros(T)
            rs = torch.zeros((npos, T))
            for p in range(npos):
                rows = torch.zeros((T, P))
                if p < nr:
                    it = jt + p
                    rows[:] = dy[bk, h, T * it:T * it + T]
                    S = sreal[p]
                    ci = cum[T * it:T * it + T]
                    if it > jt:  # exp(cum_i - cum_i0) exp(cum_i0 - cum_j)
                        L = torch.exp(ci - ci[0])[None, :] * torch.exp(
                            ci[0] - cum[js])[:, None]
                    else:        # the exponent only where i >= j
                        valid = ii[None, :] >= ii[:, None]
                        diff = ci[None, :] - cum[js][:, None]
                        L = torch.where(valid, torch.exp(torch.where(
                            valid, diff, torch.zeros(()))), torch.zeros(()))
                else:
                    v = p - nr
                    n = min(T, N - T * v)
                    rows[:n] = dst[bk, h, T * v:T * v + n]
                    S = torch.zeros((T, T))
                    S[:, :n] = Bj[:, T * v:T * v + n]
                    L = ev[js][:, None].expand(T, T)
                G = xj @ rows.T                               # G^T (j, i)
                sl = S * L
                M = sl * dtj
                dS = G * L * dtj
                gsl = G * sl
                gm = gsl * dtj
                rowg += gsl.sum(1)
                rowm += gm.sum(1)
                rs[p] = gm.sum(0)
                dxj += M @ rows
                D[p] += dS
            dx[bk, h, js] = dxj
            ddt[bk, h, js] = rowg
            vtot = rs[nr:].sum()
            pr = rs[:nr].reshape(-1).clone()
            pr[:T] -= rowm
            pr[-1] += vtot
            part[bk, h, jt, T * jt:] = pr
        for p in range(npos):
            i0 = T * (jt + p) if p < nr else C + T * (p - nr)
            dws[grp, bk, js, i0:i0 + T] = D[p]
    # the finishing kernels
    Dsum = dws[0].clone()
    for grp in range(1, groups):
        Dsum += dws[grp]
    Dt = Dsum[:, :, :C]                                   # D^T (j, i)
    dB = Dt @ Cm
    if nv:
        dB += Dsum[:, :, C:C + N]
    dC = Dt.transpose(1, 2) @ Bm
    dcum = torch.zeros((BK, H, C))
    for c in range(C):
        dcum[..., c] = part[..., :c // T + 1, c].sum(-1)
    da = torch.flip(torch.cumsum(torch.flip(dcum, (-1,)), -1), (-1,))
    return dx, da, dB, dC, ddt


def _inputs(seed, BK, H, C, P, N):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(t.astype(np.float32)) for t in (
        rng.standard_normal((BK, H, C, P)),
        -np.abs(rng.standard_normal((BK, H, C))) * 0.1,
        rng.standard_normal((BK, C, N)),
        rng.standard_normal((BK, C, N)),
        np.abs(rng.standard_normal((BK, H, C))) * 0.1,
        rng.standard_normal((BK, H, C, P)),
        rng.standard_normal((BK, H, N, P)))]


def _close(got, exp, what):
    assert tuple(got.shape) == tuple(exp.shape), what
    np.testing.assert_allclose(got.numpy(), exp.numpy(),
                               atol=TOL * float(exp.abs().max()), rtol=TOL,
                               err_msg=what)


#: (BK, H, C, P, N)
SHAPES = [(2, 3, 64, 32, 16), (1, 4, 192, 64, 64), (1, 3, 256, 128, 128),
          (2, 3, 256, 32, 64)]
IDS = ["C64-N16-P32", "C192-N64-P64", "C256-N128-P128", "C256-N64-P32"]


@pytest.fixture(autouse=True, scope="module")
def _first_exp_of_the_process():
    """The first multi-threaded ``torch.exp`` of a process may be off
    (ROADMAP C2; see tests/test_torch_ssd_scan.py): take it first."""
    torch.exp(torch.zeros(1 << 20))


@pytest.mark.parametrize("grouping", ["one-group", "a-group-a-head",
                                      "uneven-groups"])
@pytest.mark.parametrize("states", [True, False], ids=["dst", "no-dst"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_schedule_matches_plain_backward(shape, states, grouping):
    BK, H, C, P, N = shape
    x, a, Bm, Cm, dt, dy, dst = _inputs(sum(shape), *shape)
    groups = {"one-group": 1, "a-group-a-head": H,
              "uneven-groups": 2}[grouping]
    if not states:
        dst = None
    got = tiles_schedule(x, a, Bm, Cm, dt, dy, dst, groups)
    exp = tref.ssd_intra_chunk_bwd_ref(x, a, Bm, Cm, dt, dy, dst)
    for name, g, e in zip(NAMES, got, exp):
        _close(g, e, f"{name} {shape} groups={groups}")


def test_groups_and_workspace_at_the_training_shapes():
    """The kernel's rule for head groups, read from its source, gives 5
    groups of 16 heads at both training shapes (32 chunks of 256, 80
    heads), and the workspace stays under 0.1 GB there."""
    text = (_build.CSRC / "ssd_scan_bwd.cu").read_text()
    assert re.search(r"kTargetBlocks = (\d+);", text).group(1) == str(
        TARGET_BLOCKS)
    assert head_groups(32, 256, 80) == 5
    assert head_groups(2, 64, 3) == 3 and head_groups(132, 256, 2) == 1
    for N in (128, 64):
        nbytes = 4 * workspace_floats(32, 80, 256, N, True)
        assert nbytes <= 0.1e9, (N, nbytes)
    assert math.isclose(4 * workspace_floats(32, 80, 256, 128, True) / 1e6,
                        73.4, rel_tol=1e-2)
