"""The port's cold-row codec and blocked int8 quantizer against the JAX
package.

On the CPU the wrappers take their plain versions; they are held against
the reference's host codec (``repro.core.compress``), its device codec
(``repro.kernels.cold_codec``, both through its pure-jnp oracle and in
Pallas interpret mode) and its quantizer (``repro.kernels.quantize``,
interpret mode), on the reference's own codec inputs
(``tests/test_kernels.py``: 13 irregular rows, an all-zero row, a
near-zero segment). q must be byte-identical and the scales exactly
equal; decodes agree to 1e-6 (the reference's own tolerance). The
Hopper kernel itself is held against these plain versions on the card by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compress as rcomp
from repro.kernels import cold_codec as rcc
from repro.kernels import quantize as rq
from repro_torch.core import compress as tcomp
from repro_torch.kernels import cold_codec as tcc
from repro_torch.kernels import quantize as tq

SEGMENTS = ((0, 100), (100, 37), (137, 263))   # irregular FlatLayout-style
CODECS = ("f32", "f16", "int8")
#: the FEMNIST CNN's FlatLayout segments (c1.b ... f2.w), T = 6,603,710
FEMNIST_SEGMENTS = ((0, 32), (32, 800), (832, 64), (896, 51200),
                    (52096, 2048), (54144, 6422528), (6476672, 62),
                    (6476734, 126976))


def _cold_rows(S=13, T=400, seed=7):
    rng = np.random.default_rng(seed)
    rows = (rng.standard_normal((S, T)) * 3).astype(np.float32)
    rows[2] = 0.0                      # all-zero row: the 1e-12 scale floor
    rows[5, :100] = 1e-9               # near-zero segment
    return rows


def _port_encode(rows, codec, segments=SEGMENTS):
    q, s = tcc.encode_rows(torch.from_numpy(rows), codec, segments)
    return q.numpy(), s.numpy()


@pytest.mark.parametrize("codec", CODECS)
def test_encode_matches_host_codec(codec):
    rows = _cold_rows()
    host = rcomp.encode_cold_rows(rows, codec, SEGMENTS)
    q, s = _port_encode(rows, codec)
    assert q.dtype == host["q"].dtype
    np.testing.assert_array_equal(q, host["q"])
    np.testing.assert_array_equal(s, host["scale"])
    # the port's own numpy copy of the host codec is the same bytes
    mine = tcomp.encode_cold_rows(rows, codec, SEGMENTS)
    np.testing.assert_array_equal(mine["q"], host["q"])
    np.testing.assert_array_equal(mine["scale"], host["scale"])


@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("mode", ["jnp", "interpret"])
def test_encode_decode_match_reference_device_codec(codec, mode):
    rows = _cold_rows()
    kw = (dict(use_pallas=False) if mode == "jnp"
          else dict(use_pallas=True, interpret=True))
    rq_, rs_ = rcc.encode_rows(jnp.asarray(rows), codec, SEGMENTS, **kw)
    q, s = _port_encode(rows, codec)
    np.testing.assert_array_equal(q, np.asarray(rq_))
    np.testing.assert_array_equal(s, np.asarray(rs_))
    rdec = np.asarray(rcc.decode_rows(rq_, rs_, codec, SEGMENTS, **kw))
    dec = tcc.decode_rows(torch.from_numpy(q), torch.from_numpy(s), codec,
                          SEGMENTS).numpy()
    assert dec.dtype == np.float32
    np.testing.assert_allclose(dec, rdec, atol=1e-6, rtol=0)
    host = rcomp.decode_cold_rows({"q": q, "scale": s}, codec, SEGMENTS)
    np.testing.assert_allclose(dec, host, atol=1e-6, rtol=0)


@pytest.mark.parametrize("codec,tol", [("f32", 0.0), ("f16", 1e-3),
                                       ("int8", 4e-2)])
def test_roundtrip_bounds_and_fixed_point(codec, tol):
    """decode(encode(x)) stays within the codec's bound (exact for f32;
    f16 ~2^-11 relative; int8 scale/2 per segment), and a decoded row
    re-encodes to itself (the re-quantization fixed point)."""
    rows = _cold_rows(S=9)
    q, s = tcc.encode_rows(torch.from_numpy(rows), codec, SEGMENTS)
    dec = tcc.decode_rows(q, s, codec, SEGMENTS)
    if codec == "f32":
        np.testing.assert_array_equal(dec.numpy(), rows)
        return
    err = np.abs(dec.numpy() - rows)
    assert err.max() <= tol * max(1.0, np.abs(rows).max()), err.max()
    if codec == "int8":
        for j, (o, n) in enumerate(SEGMENTS):
            bound = s.numpy()[:, j] / 2 + 1e-7
            assert (err[:, o:o + n].max(1) <= bound).all()
    q2, _ = tcc.encode_rows(dec, codec, SEGMENTS)
    np.testing.assert_array_equal(q2.numpy(), q.numpy())


def test_int8_ties_round_half_to_even():
    """Values at exact half steps round to even codes, as ``np.rint``
    does (a kernel with ``roundf`` would round them away from zero)."""
    row = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.0]],
                   np.float32)
    q, s = _port_encode(row, "int8", ((0, 8),))
    assert s[0, 0] == np.float32(1.0)
    np.testing.assert_array_equal(q[0], [127, 0, 2, 2, 0, -2, -2, 3])
    np.testing.assert_array_equal(
        q, rcomp.encode_cold_rows(row, "int8", ((0, 8),))["q"])


def test_zero_rows_decode_to_exact_zeros():
    """A never-stored client's staged row (zero q, zero scales) decodes to
    exact zeros under every codec."""
    for codec in CODECS:
        dt = {"f32": torch.float32, "f16": torch.float16,
              "int8": torch.int8}[codec]
        width = len(SEGMENTS) if codec == "int8" else 0
        dec = tcc.decode_rows(torch.zeros((3, 400), dtype=dt),
                              torch.zeros((3, width)), codec, SEGMENTS)
        assert dec.dtype == torch.float32
        assert not dec.any()


def test_cpu_calls_launch_nothing():
    tcc.encode_launches = tcc.decode_launches = tq.launches = 0
    rows = torch.from_numpy(_cold_rows())
    for codec in CODECS:
        q, s = tcc.encode_rows(rows, codec, SEGMENTS)
        tcc.decode_rows(q, s, codec, SEGMENTS)
    for block in (1024, 777, 2 * tq.WARP_BLOCK):
        tq.quantize_int8_blocked(rows.reshape(-1), block=block)
    assert tcc.encode_launches == tcc.decode_launches == tq.launches == 0


@pytest.mark.parametrize("codec", ["f16", "int8"])
def test_other_devices_raise_instead_of_falling_back(codec):
    """A tensor that is neither on the CPU nor on a CUDA card gets no
    plain-version fallback: the wrapper raises."""
    rows = torch.zeros((2, 400), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tcc.encode_rows(rows, codec, SEGMENTS)
    dt = torch.float16 if codec == "f16" else torch.int8
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tcc.decode_rows(torch.zeros((2, 400), dtype=dt, device="meta"),
                        torch.zeros((2, 3), device="meta"), codec, SEGMENTS)
    # nor does the blocked quantizer, at either of its kernel's routes
    for block in (1024, 2 * tq.WARP_BLOCK):
        with pytest.raises(ValueError, match="no kernel for device meta"):
            tq.quantize_int8_blocked(rows.reshape(-1), block=block)


@pytest.mark.parametrize("segments", [SEGMENTS, FEMNIST_SEGMENTS,
                                      ((0, 1),), ((0, 4096), (4096, 4097))],
                         ids=["irregular", "femnist", "one", "edges"])
def test_tile_table_covers_every_column_once(segments):
    """The decode kernel's tile table: every column in exactly one tile,
    no tile crossing a segment, at most TILE columns, and each segment's
    first tile at its first column."""
    table = tcc.tile_table(segments)
    start, packed = table[:, 0], table[:, 1]
    length = packed & 0xFFFFFFFF
    seg = packed >> 32
    T = sum(n for _, n in segments)
    cover = np.zeros(T, np.int64)
    for s0, n, j in zip(start, length, seg):
        off, size = segments[j]
        assert off <= s0 and s0 + n <= off + size
        assert 0 < n <= tcc.TILE
        cover[s0:s0 + n] += 1
    assert (cover == 1).all()
    assert [int(start[seg == j].min()) for j in range(len(segments))] \
        == [off for off, _ in segments]
    if segments is FEMNIST_SEGMENTS:
        assert T == 6_603_710
        assert len(table) == sum(-(-n // tcc.TILE) for _, n in segments)


# -- the int8 encode's task plan ----------------------------------------------

#: the one-block threshold: a segment of SLICE columns is held by one
#: block, one of SLICE + 1 is sliced
THRESHOLD = ((0, 7), (7, tcc.SLICE), (7 + tcc.SLICE, 3))
PAST_THRESHOLD = ((0, 7), (7, tcc.SLICE + 1), (8 + tcc.SLICE, 3))
PLAN_CASES = {"irregular": (SEGMENTS, 13, 132),
              "femnist": (FEMNIST_SEGMENTS, 3, 132),
              "threshold": (THRESHOLD, 3, 132),
              "past-threshold": (PAST_THRESHOLD, 3, 132),
              "blocked-quantizer": (((0, 1024),), 200, 132),
              "femnist-grid-of-50": (FEMNIST_SEGMENTS, 2, 50)}


def _tasks(plan):
    tasks, units = plan[0], plan[1]
    cols = dict(e0=tasks[:, 0], n=tasks[:, 1] & 0xFFFFFFFF,
                nunits=tasks[:, 1] >> 32, u0=tasks[:, 2] & 0xFFFFFFFF,
                kind=tasks[:, 2] >> 32, gslot=tasks[:, 3] & 0xFFFFFFFF,
                gsize=tasks[:, 3] >> 32)
    return cols, dict(e=units[:, 0], size=units[:, 1] & 0xFFFFFFFF,
                      slot=units[:, 1] >> 32)


@pytest.mark.parametrize("case", PLAN_CASES)
def test_encode_plan_covers_every_column_once(case):
    """Every element is read for its segment's max once and coded once;
    a task holds at most SLICE columns; whole segments (at most SLICE
    columns) are packed, adjacent, into tasks of whole segments; a larger
    one is cut into ceil(size / SLICE) slices of one group, held on chip
    together (consecutive tickets, at most the grid's blocks) or, past
    the grid, in two rounds (max, then codes)."""
    segments, rows, grid = PLAN_CASES[case]
    plan = tcc.encode_plan(segments, rows, grid)
    t, u = _tasks(plan)
    T = sum(n for _, n in segments)
    assert u["e"].tolist() == (np.arange(rows)[:, None] * T + np.array(
        [o for o, _ in segments])).reshape(-1).tolist()
    assert u["slot"].tolist() == list(range(rows * len(segments)))
    maxed = np.zeros(rows * T, np.int64)
    coded = np.zeros(rows * T, np.int64)
    for i in range(len(t["e0"])):
        e0, n, kind = t["e0"][i], t["n"][i], t["kind"][i]
        assert 0 < n <= tcc.SLICE
        if kind != tcc.CODES_ONLY:
            maxed[e0:e0 + n] += 1
        if kind != tcc.MAX_ONLY:
            coded[e0:e0 + n] += 1
        first, k = t["u0"][i], t["nunits"][i]
        sizes = u["size"][first:first + k]
        if t["gsize"][i] == 1:   # whole segments, adjacent, filling it
            assert kind == tcc.RESIDENT and (sizes <= tcc.SLICE).all()
            assert 0 < k <= tcc.MAX_UNITS and u["e"][first] == e0
            assert sizes.sum() == n
        else:                    # a slice of one larger segment
            assert k == 1 and sizes[0] > tcc.SLICE
            assert t["gsize"][i] == -(-sizes[0] // tcc.SLICE)
            assert u["e"][first] <= e0 and e0 + n <= u["e"][first] + sizes[0]
    assert (maxed == 1).all() and (coded == 1).all()
    # each segment goes by its size: whole, or sliced into one group
    for first in range(len(u["e"])):
        mine = (t["u0"] == first) & (t["gsize"] > 1)
        if u["size"][first] <= tcc.SLICE:
            assert not mine.any()
            continue
        m = -(-u["size"][first] // tcc.SLICE)
        idx = np.nonzero(mine)[0]
        assert len(set(t["gslot"][idx].tolist())) == 1
        if m <= grid:
            assert len(idx) == m and (t["kind"][idx] == tcc.RESIDENT).all()
            assert (np.diff(idx) == 1).all()   # consecutive tickets
        else:
            assert t["kind"][idx].tolist() == [tcc.MAX_ONLY] * m + \
                [tcc.CODES_ONLY] * m
    assert plan[3] <= grid
    if case == "femnist":
        per_row = np.bincount(t["gsize"][t["gsize"] > 1])
        assert per_row[112] == 112 * rows and per_row[3] == 3 * rows
        assert plan[2] == 2 * rows and plan[3] == 112
        whole = t["nunits"][t["gsize"] == 1]
        assert sorted(whole.tolist()) == [1] * rows + [5] * rows
    if case == "threshold":
        assert (t["gsize"] == 1).all()
    if case == "past-threshold":
        assert plan[3] == 2 and (t["gsize"] > 1).sum() == 2 * rows
    if case == "blocked-quantizer":
        assert t["nunits"].tolist() == [56, 56, 56, 32]
    if case == "femnist-grid-of-50":
        assert plan[3] == 3 and (t["kind"] == tcc.CODES_ONLY).sum() == 224


def _emulate_encode(rows, segments, plan):
    """The kernel's walk over the plan in numpy: each task's scales (a
    slice's from its whole group), its codes, and the scale written by a
    segment's first slice or its whole-segment task."""
    t, u = _tasks(plan)
    flat = rows.reshape(-1)
    q = np.full(flat.shape, 99, np.int8)
    scale = np.full((rows.shape[0], len(segments)), np.nan, np.float32)
    for i in range(len(t["e0"])):
        e0, n, kind = t["e0"][i], t["n"][i], t["kind"][i]
        if kind == tcc.MAX_ONLY:
            continue
        for k in range(t["u0"][i], t["u0"][i] + t["nunits"][i]):
            ue, us = u["e"][k], u["size"][k]
            amax = np.abs(flat[ue:ue + us]).max()
            s = np.float32(max(amax, np.float32(1e-12))) / np.float32(127)
            lo, hi = max(e0, ue), min(e0 + n, ue + us)
            q[lo:hi] = np.clip(np.rint(flat[lo:hi] / s), -127, 127)
            if lo == ue:
                scale.reshape(-1)[u["slot"][k]] = s
    return q.reshape(rows.shape), scale


@pytest.mark.parametrize("case", ["irregular", "threshold", "past-threshold",
                                  "blocked-quantizer"])
def test_encode_plan_walk_equals_host_codec(case):
    """Walking the plan as the kernel does gives the host codec's bytes:
    each segment's scale from its whole extent, written once."""
    segments, nrows, grid = PLAN_CASES[case]
    T = sum(n for _, n in segments)
    rows = (np.random.default_rng(3).standard_normal((nrows, T)) * 3
            ).astype(np.float32)
    rows[1] = 0.0
    plan = tcc.encode_plan(segments, nrows, grid)
    q, scale = _emulate_encode(rows, segments, plan)
    host = rcomp.encode_cold_rows(rows, "int8", segments)
    np.testing.assert_array_equal(q, host["q"])
    np.testing.assert_array_equal(scale, host["scale"])


def test_cold_codec_helpers_match_reference():
    assert tcomp.COLD_CODECS == rcomp.COLD_CODECS == tcc.CODECS
    for codec in CODECS:
        assert tcomp.cold_bits_per_param(codec) \
            == rcomp.cold_bits_per_param(codec)
        assert tcomp.cold_dtype(codec) == rcomp.cold_dtype(codec)
    with pytest.raises(ValueError, match="do not cover"):
        tcc.encode_rows(torch.zeros((1, 10), device="meta"), "int8",
                        ((0, 4),))


# -- B3: the blocked quantizer ------------------------------------------------

#: (T, block) cases with inputs of their own: an all-zero block, and a
#: block whose absmax is 127 (scale exactly 1) holding exact half steps
QUANT_SPECIAL = {(3072, 1024): "zero block", (1024, 256): "tie"}
#: cases where the reference's kernel in interpret mode gives a scale one
#: ulp off the IEEE quotient max(absmax, 1e-12) / 127 (ROADMAP C7: it
#: multiplies by the rounded 1/127), by the number of such blocks; the
#: port computes the quotient, as the host codec and the reference's own
#: oracle ``quantize_int8_ref`` do
QUANT_RECIPROCAL = {(2332, 777): 1}


@pytest.mark.parametrize("T,block", [
    (4096, 1024), (5000, 1024), (777, 256), (1, 1024),
    (3073, 1024), (2047, 1024), (500, 1024), (3072, 1024),   # 1, -1 mod
    (1024, 256), (2561, 256), (1553, 777), (2332, 777), (100, 777)])
def test_quantize_int8_blocked_matches_reference(T, block):
    """The port's blocked quantizer against the reference's Pallas kernel
    (interpret mode) and its oracle, bit for bit (the kernel's scales
    but for QUANT_RECIPROCAL's): T at 0, 1 and block - 1 mod block and
    below one block; blocks 256, 777 and 1024; an all-zero block (the
    1e-12 scale floor) and a block of exact ties (round half to even)."""
    rng = np.random.default_rng(T)
    x = (rng.standard_normal(T) * 2).astype(np.float32)
    if T > 600:
        x[512:600] = 0.0
    special = QUANT_SPECIAL.get((T, block))
    if special == "zero block":
        x[block:2 * block] = 0.0
    if special == "tie":
        x[:block] = np.arange(block, dtype=np.float32) % 9 - 4.5
        x[7] = 127.0
    codes, scales = tq.quantize_int8_blocked(torch.from_numpy(x),
                                             block=block)
    rc, rs = rq.quantize_int8_blocked(jnp.asarray(x), block=block,
                                      interpret=True)
    assert codes.dtype == torch.int8 and codes.shape == (T,)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(rc))
    oc, os_ = rq.quantize_int8_ref(jnp.asarray(x), block=block)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(oc))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(os_))
    nb = len(scales)
    amax = np.abs(np.pad(x, (0, nb * block - T)).reshape(nb, block)).max(1)
    recip = np.maximum(amax, np.float32(1e-12)) * (np.float32(1) /
                                                   np.float32(127))
    np.testing.assert_array_equal(np.asarray(rs), recip)
    off = scales.numpy() != np.asarray(rs)
    assert off.sum() == QUANT_RECIPROCAL.get((T, block), 0)
    np.testing.assert_array_max_ulp(scales.numpy(), np.asarray(rs), 1)
    pc, ps = tq.quantize_int8_ref(torch.from_numpy(x), block=block)
    np.testing.assert_array_equal(pc.numpy(), codes.numpy())
    np.testing.assert_array_equal(ps.numpy(), scales.numpy())
    if special == "zero block":
        assert scales[1] == np.float32(1e-12) / np.float32(127)
        assert not codes[block:2 * block].any()
    if special == "tie":
        assert scales[0] == 1.0
        np.testing.assert_array_equal(codes[:9].numpy(),
                                      [-4, -4, -2, -2, 0, 0, 2, 127, 4])
    deq = tq.dequantize_int8_blocked(codes, scales, block=block)
    rdeq = rq.dequantize_int8_blocked(rc, rs, block=block)
    np.testing.assert_allclose(deq.numpy(), np.asarray(rdeq), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(deq.numpy(), x,
                               atol=float(scales.max()) / 2 + 1e-7, rtol=0)


def test_quantize_equals_cold_encode_of_blocked_rows():
    """The identity the plain version is built on: per-block quantization
    of a flat vector is the int8 cold encode of its (T/block, block)
    rows."""
    T, block = 4096, 1024
    x = (np.random.default_rng(11).standard_normal(T) * 2).astype(
        np.float32)
    codes, scales = tq.quantize_int8_blocked(torch.from_numpy(x),
                                             block=block)
    host = rcomp.encode_cold_rows(x.reshape(-1, block), "int8",
                                  ((0, block),))
    np.testing.assert_array_equal(codes.numpy().reshape(-1, block),
                                  host["q"])
    np.testing.assert_array_equal(scales.numpy(), host["scale"][:, 0])


@pytest.mark.parametrize("form", ["float64", "float16", "strided"])
def test_quantize_converts_other_dtypes_and_strided_views(form):
    """A vector that is not contiguous f32 is quantized as its f32 values
    (the reference's ``_kernel`` casts to f32 too), on the CPU as on the
    card, where the wrapper converts before the launch."""
    T, block = 2561, 256
    x = (np.random.default_rng(3).standard_normal(2 * T) * 2).astype(
        np.float32)
    if form == "strided":
        xt = torch.from_numpy(x)[::2]
        assert not xt.is_contiguous()
    else:
        xt = torch.from_numpy(x[:T]).to(getattr(torch, form))
    x32 = xt.to(torch.float32).contiguous()
    codes, scales = tq.quantize_int8_blocked(xt, block=block)
    want_c, want_s = tq.quantize_int8_blocked(x32, block=block)
    np.testing.assert_array_equal(codes.numpy(), want_c.numpy())
    np.testing.assert_array_equal(scales.numpy(), want_s.numpy())
    rc, _ = rq.quantize_int8_blocked(jnp.asarray(x32.numpy()), block=block,
                                     interpret=True)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(rc))


def _quantize_walk(x_addr, q_addr, T, block):
    """``csrc/quantize.cu`` over (T,) in plain Python, on the path
    :func:`quantize_plan` picks: how often each element is read and its
    code written, asserting every vector access aligned."""
    vector, per_warp = tq.quantize_plan(x_addr, q_addr, block)
    seen = np.zeros(T, np.int64)
    nb = -(-T // block)
    threads = 32 if per_warp else 1024
    for b in range(nb):
        e0 = b * block
        n = min(block, T - e0)
        if vector:
            nw = n // 4
            # a warp: lane + 32 k for k < 8; a CTA: tid + 1024 k
            words = [w for t in range(threads) for w in range(t, nw, threads)]
            if per_warp:
                assert nw < 32 * 8 or (nw == 32 * 8 and n == 4 * nw)
            for w in words:
                assert (x_addr + 4 * (e0 + 4 * w)) % 16 == 0
                assert (q_addr + e0 + 4 * w) % 4 == 0
                seen[e0 + 4 * w:e0 + 4 * w + 4] += 1
            seen[e0 + 4 * nw:e0 + n] += 1        # the cut word, by element
        else:
            if per_warp:
                assert n <= 32 * 32
            seen[e0:e0 + n] += 1
    return vector, seen


@pytest.mark.parametrize("T,block", [(6_603_710 // 1000, 1024),
                                     (2561, 256), (1553, 777), (5000, 3000),
                                     (100, 777), (4096, 1024)])
def test_quantize_plan_walk_covers_every_element_once(T, block):
    """At every byte residue 0-15 of x's base (f32: multiples of 4) and
    of the codes' base, the kernel's walk reads and codes every element
    exactly once with every vector access aligned; the vector path is
    taken exactly where x is 16-byte and q 4-byte aligned and block is a
    multiple of 4."""
    for xr in range(0, 16, 4):
        for qr in range(16):
            vector, seen = _quantize_walk(4096 + xr, 8192 + qr, T, block)
            assert (seen == 1).all(), (xr, qr)
            assert vector == (xr == 0 and qr % 4 == 0 and block % 4 == 0)


# -- B2's f16 casts -----------------------------------------------------------

def _f16_edges() -> np.ndarray:
    """f32 values at the f16 cast's edges: exact midpoints between
    neighbouring f16 values (ties to even, both ways), points just off
    them, subnormals and their ties (2^-25 rounds to 0), the largest
    finite f16 (65504) and what overflows to +-inf (65520 is a tie)."""
    rng = np.random.default_rng(5)
    h = rng.integers(0, 0x7BFF, 1800).astype(np.uint16)
    lo = h.view(np.float16).astype(np.float32)
    hi = (h + 1).view(np.float16).astype(np.float32)
    mid = ((lo.astype(np.float64) + hi) / 2).astype(np.float32)
    sub = np.arange(0, 1024, 7, dtype=np.uint16).view(np.float16).astype(
        np.float32)
    vals = np.concatenate([
        mid, np.nextafter(mid, np.float32(np.inf)),
        np.nextafter(mid, np.float32(-np.inf)), sub, sub * 1.5,
        np.float32([2.0 ** -25, 3 * 2.0 ** -25, 2.0 ** -26, 2.0 ** -24,
                    6.1e-5, 65504.0, 65519.99, 65520.0, 70000.0, 3e38,
                    np.inf, 0.0, -0.0])])
    vals = np.concatenate([vals, -vals])
    out = np.zeros((3, 4096), np.float32)
    out.reshape(-1)[:vals.size] = vals
    return out


def test_f16_casts_match_host_codec_at_the_edges():
    """The f16 encode's plain version against the host codec bit for bit
    at ties, subnormals and overflow; its decode against the host codec
    over every non-NaN f16 bit pattern (NaNs stay NaN)."""
    rows = _f16_edges()
    segs = ((0, 4096),)
    q, _ = tcc.encode_rows(torch.from_numpy(rows), "f16", segs)
    host = rcomp.encode_cold_rows(rows, "f16", segs)
    np.testing.assert_array_equal(q.numpy().view(np.uint16),
                                  host["q"].view(np.uint16))
    assert np.isinf(host["q"]).sum() > 0 and (host["q"] == 0).sum() > 0
    allh = np.arange(65536, dtype=np.uint32).astype(np.uint16).view(
        np.float16).reshape(16, 4096)
    dec = tcc.decode_rows(torch.from_numpy(allh), None, "f16", segs).numpy()
    ref = rcomp.decode_cold_rows({"q": allh, "scale": None}, "f16", segs)
    nan = np.isnan(ref)
    assert (np.isnan(dec) == nan).all()
    np.testing.assert_array_equal(dec[~nan].view(np.uint32),
                                  ref[~nan].view(np.uint32))


def _cast_walk(f32_addr, f16_addr, n):
    """The f16 cast kernel over n elements in plain Python, on
    :func:`cold_codec.cast_plan`'s plan: the scalar head, whole groups
    (the f32 side a float4 an access, the f16 side ``halves`` halves),
    the scalar tail; asserts every vector access aligned and returns how
    often each element is cast."""
    halves, head = tcc.cast_plan(f32_addr, f16_addr, n)
    seen = np.zeros(n, np.int64)
    seen[:head] += 1
    ng = (n - head) // 4
    for g in range(ng):
        e = head + 4 * g
        assert (f32_addr + 4 * e) % 16 == 0
        for k in range(0, 4, halves):
            assert (f16_addr + 2 * (e + k)) % (2 * halves) == 0
        seen[e:e + 4] += 1
    seen[head + 4 * ng:] += 1
    return halves, head, seen


def test_cast_plan_walk_covers_every_element_once():
    """At every byte residue 0-15 of both bases and at lengths around the
    group sizes, the cast's walk casts every element exactly once with
    every vector access aligned, the head stays under 4 elements, and
    the wide f16 access is taken wherever the two residues allow it;
    misaligned bases are refused."""
    for r32 in range(16):
        for r16 in range(16):
            base32, base16 = 1 << 20 | r32, 1 << 21 | r16
            if r32 % 4 or r16 % 2:
                with pytest.raises(ValueError, match="element-aligned"):
                    tcc.cast_plan(base32, base16, 8)
                continue
            e32, e16 = r32 // 4, r16 // 2
            for n in (*range(20), 63, 1001, 6_603_710 % 4096 + 4096):
                halves, head, seen = _cast_walk(base32, base16, n)
                assert (seen == 1).all(), (r32, r16, n)
                assert head < 4
                assert halves == (4 if e32 == e16 % 4 else 1)
    # the slab's row views: f32 rows of T = 2 mod 4 from a fresh f16
    # output, and f16 rows (12 bytes past 16) into a fresh f32 output
    T = 6_603_710
    assert tcc.cast_plan(4 * T, 0, T) == (1, 2)
    assert tcc.cast_plan(0, 2 * T, T) == (1, 0)
    assert tcc.cast_plan(0, 0, 64 * T) == (4, 0)
