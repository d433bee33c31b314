"""Streaming client-state store: O(cohort) resident memory at n≈10⁵
(port of ``repro.core.clientstore``, numpy, copied whole).

The flat ModelBank (``core/modelbank.py``) materializes every client as
a hot ``(n, T)`` row, so memory and init cost grow with the population
even though cohort compaction already made per-round *compute*
O(cohort). The :class:`ClientStore` breaks that last O(n) dependence:
per round only the sampled cohort's rows are materialized as the hot
``(k_pad, T)`` slab (``ModelBank.from_rows``), while cold state lives
here — host-side, compressed under a ``core/compress.py`` cold codec —
and is paged in/out at round boundaries.

Why the cold store is small — what per-client state actually exists
-------------------------------------------------------------------

Every supported round program ends in a cluster-level mixing boundary
(the qτ-boundary of eq. 11, or its Hier-FAvg/FedAvg/Local-Edge
reductions), and every masked operator row is a function of the row's
cluster label only. So at the end of a round, **every member of a
cluster holds the identical synced value** — per-client params would be
n duplicates of an (m, T) table. The store therefore keeps:

- ``cluster_params`` — the (m, T) per-cluster reference models (what a
  cold client's row *is*);
- encoded **momentum** rows of ever-sampled clients only, lazily: a
  never-sampled client's momentum is exactly zero (momentum is never
  mixed, and ``where``-frozen while a client sits out), so it needs no
  bytes at all.

Page-in builds each working-set lane from ``cluster_params[label]``
plus its decoded momentum (zeros on first touch); page-out reads each
cluster's synced row back into ``cluster_params`` and re-encodes the
cohort's momentum. With the default lossless ``f32`` codec the
page-out/page-in round trip is bit-exact, which is what makes
killed-and-resumed streamed runs bit-identical (``RunCheckpoint``
snapshots :meth:`ClientStore.snapshot` under fixed keys).

Storage layout: each shard is a growable contiguous *arena* —
``(capacity, T)`` encoded rows + ``(capacity, nseg)`` scales + a dense
``local_id -> slot`` map — so :meth:`fetch`/:meth:`commit` are single
numpy gather/scatters instead of O(k) Python dict walks, and the
pipelined driver's :meth:`fetch_encoded`/:meth:`commit_encoded` move
codec-width bytes without a host decode/encode in the loop. Per-slot
dirty bits make :meth:`snapshot` incremental: only rows committed since
the last snapshot are re-gathered (bit-identical to a full rebuild).

Sharding: the store partitions client rows ``client_id % num_shards``
into independent per-shard arenas, so the sharded engine
(``core/sharded.py``) keeps one cold shard per bank shard and no single
host map ever holds the whole population's rows. A rank of the sharded
streamed bank fills only its own shard; :func:`merge_snapshots` joins
the ranks' snapshots into the single-process file format and
:func:`split_snapshot` cuts a rank's shard back out of it.

Resident-memory formula (doctested in docs/PERFORMANCE.md):

>>> resident_slab_nbytes(16, 1000)   # 16-lane slab, T=1000 params
128000
>>> cold_row_nbytes(1000, "int8", 4)  # 4-segment layout: q + scales
1016
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.compress import (COLD_CODECS, cold_bits_per_param,
                                 cold_dtype, decode_cold_rows,
                                 encode_cold_rows)


def resident_slab_nbytes(k_pad: int, total: int) -> int:
    """Peak resident hot-slab bytes of one streamed round: params +
    momentum at ``(k_pad, T)`` float32 — a function of the *cohort
    bucket*, never of the population size.

    >>> resident_slab_nbytes(8, 100)
    6400
    """
    return 2 * 4 * int(k_pad) * int(total)


def cold_row_nbytes(total: int, codec: str, num_segments: int) -> int:
    """Host cold-store bytes of one stored client row: ``T`` params at
    the codec's width, plus one float32 affine scale per FlatLayout
    segment for ``int8``.

    >>> cold_row_nbytes(100, "f32", 4)
    400
    >>> cold_row_nbytes(100, "f16", 4)
    200
    >>> cold_row_nbytes(100, "int8", 4)
    116
    """
    per = cold_bits_per_param(codec) // 8
    scales = 4 * num_segments if codec == "int8" else 0
    return per * int(total) + scales


#: the keys of :meth:`ClientStore.snapshot` (a run checkpoint's ``store``)
SNAPSHOT_KEYS = ("cluster", "ids", "mom_q", "mom_scale")


def merge_snapshots(snaps) -> Dict[str, np.ndarray]:
    """One snapshot of the stores whose shards ``snaps`` hold (each a
    :meth:`ClientStore.snapshot` of a store that filled only its own
    shard; the cluster references are the same on every one): the rows
    of all, sorted by client id — the snapshot of one store holding
    them all."""
    snaps = list(snaps)
    ids = np.concatenate([s["ids"] for s in snaps])
    order = np.argsort(ids)
    return {"cluster": np.asarray(snaps[0]["cluster"]).copy(),
            "ids": ids[order],
            "mom_q": np.concatenate([s["mom_q"] for s in snaps])[order],
            "mom_scale": np.concatenate(
                [s["mom_scale"] for s in snaps])[order]}


def split_snapshot(snap, num_shards: int, shard: int
                   ) -> Dict[str, np.ndarray]:
    """The part of ``snap`` that shard ``shard`` of ``num_shards`` holds
    (``client_id % num_shards == shard``), with every cluster
    reference; :func:`merge_snapshots` of all the parts is ``snap``."""
    ids = np.asarray(snap["ids"], np.int64)
    keep = ids % num_shards == shard
    return {"cluster": np.asarray(snap["cluster"]), "ids": ids[keep],
            "mom_q": np.asarray(snap["mom_q"])[keep],
            "mom_scale": np.asarray(snap["mom_scale"])[keep]}


class ClientStore:
    """Compressed host store of cold client state behind the hot slab.

    ``layout`` is the model's FlatLayout; ``init_row`` the shared-init
    flat row (Algorithm 1's common y_{0,0}); ``codec`` one of
    ``compress.COLD_CODECS``. Rows are partitioned
    ``client_id % num_shards`` so a sharded engine keeps per-shard cold
    stores (``num_shards=1`` for the single-process engine)."""

    _GROW = 64  # minimum arena/slot-map growth quantum

    def __init__(self, layout, num_clusters: int, init_row: np.ndarray,
                 *, codec: str = "f32", num_shards: int = 1):
        assert codec in COLD_CODECS, codec
        assert num_shards >= 1
        self.layout = layout
        self.m = int(num_clusters)
        self.codec = codec
        self.num_shards = int(num_shards)
        row = np.asarray(init_row, np.float32).reshape(-1)
        assert row.shape[0] == layout.total, (row.shape, layout.total)
        #: (m, T) per-cluster reference params — a cold client's row IS
        #: its cluster's reference (see module docstring)
        self.cluster_params = np.tile(row[None, :], (self.m, 1))
        self._dt = cold_dtype(codec)
        self._sw = len(layout.segments) if codec == "int8" else 0
        self._reset_arenas()

    def _reset_arenas(self) -> None:
        ns, T = self.num_shards, self.layout.total
        # per-shard contiguous arenas over slots [0, _size): encoded q
        # rows, f32 scales, slot->id, per-slot dirty-since-snapshot bit
        self._q: List[np.ndarray] = [
            np.empty((0, T), self._dt) for _ in range(ns)]
        self._scale: List[np.ndarray] = [
            np.empty((0, self._sw), np.float32) for _ in range(ns)]
        self._ids: List[np.ndarray] = [
            np.empty((0,), np.int64) for _ in range(ns)]
        self._dirty: List[np.ndarray] = [
            np.empty((0,), bool) for _ in range(ns)]
        self._size: List[int] = [0] * ns
        # dense local-id (= client_id // num_shards) -> slot, -1 absent
        self._slot: List[np.ndarray] = [
            np.empty((0,), np.int64) for _ in range(ns)]
        # cached (ids, q, scale) of the last snapshot; stale once an
        # id is stored that the cache has never seen
        self._snap: Tuple[np.ndarray, np.ndarray, np.ndarray] | None = None
        self._snap_stale = True

    # -- bookkeeping ---------------------------------------------------------
    @property
    def num_stored(self) -> int:
        """Clients with a materialized (ever-sampled) momentum row."""
        return sum(self._size)

    @property
    def bits_per_row(self) -> int:
        """Paged bits per client row — what ``clock.paging_comm_time``
        charges each page-in/page-out row of device↔edge traffic."""
        return 8 * cold_row_nbytes(self.layout.total, self.codec,
                                   len(self.layout.segments))

    def shard_nbytes(self) -> List[int]:
        """Cold bytes held per shard (stored rows only)."""
        per = cold_row_nbytes(self.layout.total, self.codec,
                              len(self.layout.segments))
        return [per * sz for sz in self._size]

    @property
    def nbytes(self) -> int:
        """Total host bytes: cluster references + stored cold rows."""
        return int(self.cluster_params.nbytes) + sum(self.shard_nbytes())

    # -- arena plumbing ------------------------------------------------------
    def _lookup(self, sh: int, local: np.ndarray) -> np.ndarray:
        """Slots of local ids in shard ``sh`` (-1 where never stored)."""
        m = self._slot[sh]
        out = np.full(local.shape, -1, np.int64)
        ok = local < m.shape[0]
        out[ok] = m[local[ok]]
        return out

    def _ensure_slots(self, sh: int, ids: np.ndarray) -> np.ndarray:
        """Slots for ``ids`` (unique, this shard), appending fresh
        arena slots — and growing the arena — for unseen ids."""
        local = ids // self.num_shards
        m = self._slot[sh]
        need = int(local.max()) + 1 if local.size else 0
        if need > m.shape[0]:
            nm = np.full(max(need, 2 * m.shape[0], self._GROW), -1,
                         np.int64)
            nm[:m.shape[0]] = m
            self._slot[sh] = m = nm
        slots = m[local]
        fresh = slots < 0
        n_new = int(fresh.sum())
        if n_new:
            start = self._size[sh]
            end = start + n_new
            if end > self._q[sh].shape[0]:
                cap = max(end, 2 * self._q[sh].shape[0], self._GROW)
                for arrs, shape in ((self._q, (cap, self.layout.total)),
                                    (self._scale, (cap, self._sw))):
                    grown = np.empty(shape, arrs[sh].dtype)
                    grown[:start] = arrs[sh][:start]
                    arrs[sh] = grown
                gid = np.empty((cap,), np.int64)
                gid[:start] = self._ids[sh][:start]
                self._ids[sh] = gid
                gd = np.zeros((cap,), bool)
                gd[:start] = self._dirty[sh][:start]
                self._dirty[sh] = gd
            new_slots = np.arange(start, end, dtype=np.int64)
            m[local[fresh]] = new_slots
            self._ids[sh][new_slots] = ids[fresh]
            self._size[sh] = end
            self._snap_stale = True
            slots = m[local]
        return slots

    def _by_shard(self, ids: np.ndarray):
        """Yield ``(shard, positions)`` covering ``ids``."""
        if self.num_shards == 1:
            yield 0, slice(None)
            return
        sh = ids % self.num_shards
        for s in range(self.num_shards):
            pos = np.nonzero(sh == s)[0]
            if pos.size:
                yield s, pos

    # -- paging --------------------------------------------------------------
    def fetch(self, clients: np.ndarray) -> np.ndarray:
        """Decode the momentum rows of ``clients`` as (k, T) float32.
        Never-stored clients decode to zeros (their exact momentum).

        Warm-cohort fast path: when every requested row is stored, the
        gathered rows decode straight into the output — no (k, T)
        zero-fill memset on the all-hit path."""
        ids = np.asarray(clients, np.int64).reshape(-1)
        k, T = ids.shape[0], self.layout.total
        if k == 0:
            return np.zeros((0, T), np.float32)
        if self.num_shards == 1:
            slots = self._lookup(0, ids)
            if (slots >= 0).all():
                enc = {"q": self._q[0][slots],
                       "scale": self._scale[0][slots]}
                return decode_cold_rows(enc, self.codec,
                                        self.layout.segments)
        parts = []
        for s, pos in self._by_shard(ids):
            slots = self._lookup(s, ids[pos] // self.num_shards)
            parts.append((s, pos, slots))
        all_hit = all((slots >= 0).all() for _, _, slots in parts)
        out = (np.empty if all_hit else np.zeros)((k, T), np.float32)
        for s, pos, slots in parts:
            hit = slots >= 0
            if not hit.any():
                continue
            enc = {"q": self._q[s][slots[hit]],
                   "scale": self._scale[s][slots[hit]]}
            dec = decode_cold_rows(enc, self.codec, self.layout.segments)
            idx = np.arange(k)[pos][hit] if isinstance(pos, slice) \
                else pos[hit]
            out[idx] = dec
        return out

    def fetch_encoded(self, clients: np.ndarray) \
            -> Tuple[np.ndarray, np.ndarray]:
        """Gather the *encoded* momentum rows of ``clients`` as
        ``(q (k, T) codec-dtype, scale (k, nseg) f32)`` — the pipelined
        driver's page-in payload (decoded on device by
        ``kernels.cold_codec.decode_rows``). Never-stored clients get
        zero q and zero scales, which decode to exact zeros."""
        ids = np.asarray(clients, np.int64).reshape(-1)
        k, T = ids.shape[0], self.layout.total
        if self.num_shards == 1 and k:
            slots = self._lookup(0, ids)
            if (slots >= 0).all():
                return self._q[0][slots], self._scale[0][slots]
        q = np.zeros((k, T), self._dt)
        scale = np.zeros((k, self._sw), np.float32)
        for s, pos in self._by_shard(ids):
            slots = self._lookup(s, ids[pos] // self.num_shards)
            hit = slots >= 0
            if not hit.any():
                continue
            idx = np.arange(k)[pos][hit] if isinstance(pos, slice) \
                else pos[hit]
            q[idx] = self._q[s][slots[hit]]
            scale[idx] = self._scale[s][slots[hit]]
        return q, scale

    def commit(self, clients: np.ndarray, rows: np.ndarray) -> None:
        """Encode and store the momentum rows of ``clients`` (page-out).
        Re-committing a client overwrites its previous row."""
        ids = np.asarray(clients, np.int64).reshape(-1)
        rows = np.asarray(rows, np.float32)
        assert rows.shape == (ids.shape[0], self.layout.total)
        enc = encode_cold_rows(rows, self.codec, self.layout.segments)
        self.commit_encoded(ids, enc["q"], enc["scale"])

    def commit_encoded(self, clients: np.ndarray, q: np.ndarray,
                       scale: np.ndarray) -> None:
        """Store already-encoded rows verbatim (page-out of the
        pipelined driver, whose encode ran on device). Single scatter
        per shard; committed slots are marked dirty for the
        incremental :meth:`snapshot`."""
        ids = np.asarray(clients, np.int64).reshape(-1)
        q = np.asarray(q)
        scale = np.asarray(scale, np.float32)
        assert q.shape == (ids.shape[0], self.layout.total), q.shape
        assert q.dtype == self._dt, (q.dtype, self._dt)
        assert scale.shape == (ids.shape[0], self._sw), scale.shape
        for s, pos in self._by_shard(ids):
            slots = self._ensure_slots(s, ids[pos])
            self._q[s][slots] = q[pos]
            self._scale[s][slots] = scale[pos]
            self._dirty[s][slots] = True

    def update_clusters(self, refs: np.ndarray) -> None:
        """Replace the per-cluster reference params (page-out)."""
        refs = np.asarray(refs, np.float32)
        assert refs.shape == self.cluster_params.shape
        self.cluster_params = refs.copy()

    # -- checkpoint edge -----------------------------------------------------
    def snapshot(self) -> Dict[str, np.ndarray]:
        """Fixed-key host snapshot for ``RunCheckpoint``: stored rows
        stay *encoded*, so a save/restore round trip reproduces the
        identical cold bytes under every codec (no re-quantization).

        Incremental: the cached (ids, q, scale) arrays are patched in
        place for slots dirtied since the last snapshot; a full
        re-gather happens only when ids unseen by the cache appeared.
        Either path yields bit-identical output (asserted in tests)."""
        if self._snap is None or self._snap_stale:
            sizes = self._size
            all_ids = np.concatenate(
                [self._ids[s][:sizes[s]] for s in range(self.num_shards)])
            order = np.argsort(all_ids)
            ids = all_ids[order]
            q = np.concatenate(
                [self._q[s][:sizes[s]] for s in range(self.num_shards)]
            )[order]
            scale = np.concatenate(
                [self._scale[s][:sizes[s]]
                 for s in range(self.num_shards)])[order]
            self._snap = (ids, q, scale)
        else:
            ids, q, scale = self._snap
            for s in range(self.num_shards):
                d = self._dirty[s][:self._size[s]]
                if not d.any():
                    continue
                slots = np.nonzero(d)[0]
                pos = np.searchsorted(ids, self._ids[s][slots])
                q[pos] = self._q[s][slots]
                scale[pos] = self._scale[s][slots]
        for s in range(self.num_shards):
            self._dirty[s][:self._size[s]] = False
        self._snap_stale = False
        ids, q, scale = self._snap
        return {"cluster": self.cluster_params.copy(),
                "ids": ids.copy(), "mom_q": q.copy(),
                "mom_scale": scale.copy()}

    def load(self, state: Dict[str, np.ndarray]) -> None:
        """Restore :meth:`snapshot` output (mirror of ``_assign``)."""
        cluster = np.asarray(state["cluster"], np.float32)
        assert cluster.shape == self.cluster_params.shape, \
            (cluster.shape, self.cluster_params.shape)
        self.cluster_params = cluster.copy()
        self._reset_arenas()
        ids = np.asarray(state["ids"], np.int64)
        q = np.asarray(state["mom_q"]).astype(self._dt)
        scale = np.asarray(state["mom_scale"],
                           np.float32).reshape(ids.shape[0], self._sw)
        if ids.size:
            self.commit_encoded(ids, q, scale)
        # the loaded state IS the current snapshot — seed the cache
        order = np.argsort(ids)
        self._snap = (ids[order].copy(), q[order].copy(),
                      scale[order].copy())
        self._snap_stale = False
        for s in range(self.num_shards):
            self._dirty[s][:self._size[s]] = False
