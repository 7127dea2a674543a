"""ColdStore: the compacted history tier below the hot ring.

The ring-buffer server holds a bounded recent horizon of the time-first
permutation; a forward slide EVICTS the positions leaving ``[lo, lo+C)``.
The cold store keeps that history as chunked, delta-encoded time-first
segments (after Khurana & Deshpande's DeltaGraph):

  * a chunk is a FIXED SPAN of evicted time-first positions
    (``chunk_slots`` of them), sealed with a ``[t_lo, t_hi)`` start-time
    fence and registered in a host-side chunk directory;
  * inside a chunk ``t_start`` is ascending, so it stores as a base plus
    non-negative deltas (uint16 when they fit), durations
    (``t_end - t_start``) likewise, and an all-ones weight column as
    nothing at all;
  * compaction is host work off the advance's device path: the server
    notes the evicted position range after the advance's device work is
    enqueued, and the store seals chunks from its own host mirrors of the
    graph's tensors (one device->host copy per store, on the first note).

Queries below the hot horizon then STITCH: :meth:`ColdStore.ring_stitch`
rebuilds the exact index ring view (slot order included) for a window
whose positions are covered, decoding the sealed chunks and gathering the
unsealed pending tail and the hot suffix from the host mirrors, so a
cold-tier solve is bit-identical to a cold full-history index solve under
the same plan.  The tier decision itself (hot / cold / split) lives on the
:class:`~repro_torch.engine.plan.AccessPlan` (``plan_query``).

The store is the JAX package's ``repro/core/coldstore.py`` on host numpy;
the mirrors' copy off the device and the mapping of spilled chunks (see
:class:`ColdStore`) differ.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple, Union

import numpy as np

from repro_torch.core.temporal_graph import TemporalGraph
from repro_torch.core.tger import TGERIndex, window_positions_host
from repro_torch.device import to_numpy

_RAW_BYTES_PER_EDGE = 20  # src, dst, t_start, t_end int32 + weight f32


def _pack_unsigned(a: np.ndarray) -> np.ndarray:
    """Smallest unsigned dtype that holds the (non-negative) values."""
    if a.size and int(a.max()) >= 1 << 16:
        return a.astype(np.uint32)
    return a.astype(np.uint16)


@dataclasses.dataclass(frozen=True)
class ColdChunk:
    """One sealed span of evicted time-first positions ``[pos_lo, pos_hi)``
    with its ``[t_lo, t_hi)`` start-time fence (``t_hi`` is the start time
    of the first position AFTER the chunk, INT32_MAX at the end: fences
    tile the timeline, so the directory answers "which chunks can hold
    starts in this window" without touching payloads)."""

    pos_lo: int
    pos_hi: int
    t_lo: int
    t_hi: int
    src: np.ndarray        # i32[n]
    dst: np.ndarray        # i32[n]
    dt_start: np.ndarray   # u16/u32[n-1] deltas of the ascending t_start
    dur: np.ndarray        # u16/u32[n]  t_end - t_start
    weight: Optional[np.ndarray]  # f32[n], or None when the column is all-ones

    @property
    def n(self) -> int:
        return self.pos_hi - self.pos_lo

    @property
    def nbytes(self) -> int:
        w = 0 if self.weight is None else self.weight.nbytes
        return (self.src.nbytes + self.dst.nbytes + self.dt_start.nbytes
                + self.dur.nbytes + w)

    def decode(self) -> Tuple[np.ndarray, ...]:
        """The raw ``(src, dst, t_start, t_end, weight)`` columns, bit-exact
        against the arrays the chunk was sealed from."""
        ts = np.empty(self.n, np.int64)
        ts[0] = self.t_lo
        if self.n > 1:
            np.cumsum(self.dt_start, dtype=np.int64, out=ts[1:])
            ts[1:] += self.t_lo
        te = ts + self.dur.astype(np.int64)
        w = (np.ones(self.n, np.float32) if self.weight is None
             else self.weight)
        return (self.src, self.dst, ts.astype(np.int32),
                te.astype(np.int32), w)


@dataclasses.dataclass(frozen=True)
class _SpilledChunk:
    """The directory entry of a chunk spilled to disk: its span, its fence
    and where each payload column lies in its file.  :meth:`load` maps the
    file (one read-only ``np.memmap``) only while the chunk is read, so a
    spilled store holds no open file per chunk."""

    pos_lo: int
    pos_hi: int
    t_lo: int
    t_hi: int
    path: str
    nbytes: int
    # (name, byte offset, dtype, shape) of each mapped column; zero-size
    # columns (a 1-slot chunk's empty delta column) stay in memory, since
    # mmap cannot map an empty span
    mapped: Tuple[Tuple[str, int, np.dtype, Tuple[int, ...]], ...]
    resident: Tuple[Tuple[str, np.ndarray], ...]

    def load(self) -> ColdChunk:
        raw = np.memmap(self.path, dtype=np.uint8, mode="r")
        cols = dict(self.resident)
        for name, offset, dtype, shape in self.mapped:
            size = int(np.prod(shape)) * np.dtype(dtype).itemsize
            cols[name] = raw[offset:offset + size].view(dtype).reshape(shape)
        return ColdChunk(pos_lo=self.pos_lo, pos_hi=self.pos_hi, t_lo=self.t_lo,
                         t_hi=self.t_hi, weight=cols.pop("weight", None), **cols)


class ColdStore:
    """Host-side compacted history for one ``(graph, TGER)`` pair.

    Coverage is the position prefix ``[0, watermark)`` of the global
    time-first permutation: :meth:`note_eviction` (called by the server
    whenever the ring's low watermark advances) extends it and seals every
    completed ``chunk_slots`` span into a :class:`ColdChunk`; the first
    note backfills from position 0, so the history before serving enters
    as one compaction.  The uncompacted tail ``[sealed, watermark)`` (less
    than one chunk) serves straight from the host mirrors until its chunk
    completes.

    ``spill_dir`` moves sealed chunk payloads out of RAM: each chunk's
    columns are written to one file and read back as read-only
    ``np.memmap`` views, decoded through the same code (bit-identical
    stitches).  The chunk directory (fences and position spans) stays in
    memory, so tier classification never touches disk.  Unlike the JAX
    package's store, which keeps every column of every spilled chunk
    mapped (an open file each, so a store of a few thousand chunks runs
    out of file descriptors), a spilled chunk is mapped only while read:
    by ``chunks``, ``chunks_for`` and the bounded decode cache.
    """

    def __init__(self, g: TemporalGraph, tger: TGERIndex, *,
                 chunk_slots: int = 1024,
                 spill_dir: Optional[str] = None):
        if tger is None:
            raise ValueError("ColdStore requires a TGER index (the time-"
                             "first permutation is the compaction domain)")
        if int(chunk_slots) < 1:
            raise ValueError(f"chunk_slots must be >= 1, got {chunk_slots}")
        self.graph = g
        self.tger = tger
        self.chunk_slots = int(chunk_slots)
        self.spill_dir = None if spill_dir is None else str(spill_dir)
        if self.spill_dir is not None:
            os.makedirs(self.spill_dir, exist_ok=True)
        self.n_positions = int(g.n_edges)
        self._covered = 0
        self._sealed = 0
        self._chunks: List[Union[ColdChunk, _SpilledChunk]] = []
        self._host: Optional[Dict[str, np.ndarray]] = None
        self._decoded: Dict[int, Tuple[np.ndarray, ...]] = {}
        self.n_compactions = 0
        self.n_spilled = 0

    # -- host mirrors --------------------------------------------------------

    def _mirrors(self) -> Dict[str, np.ndarray]:
        """Host copies of the graph's edge columns and the time-first
        permutation, made once per store (compaction and stitching are
        host work after this)."""
        if self._host is None:
            g = self.graph
            self._host = dict(
                src=to_numpy(g.src), dst=to_numpy(g.dst),
                t_start=to_numpy(g.t_start), t_end=to_numpy(g.t_end),
                weight=to_numpy(g.weight),
                perm=to_numpy(self.tger.perm_by_start).astype(np.int64),
                start_sorted=to_numpy(self.tger.start_sorted),
            )
        return self._host

    # -- coverage / classification ------------------------------------------

    @property
    def watermark(self) -> int:
        """Positions ``[0, watermark)`` are cold (compacted or pending)."""
        return self._covered

    def _chunk(self, ci: int) -> ColdChunk:
        c = self._chunks[ci]
        return c.load() if isinstance(c, _SpilledChunk) else c

    @property
    def chunks(self) -> Tuple[ColdChunk, ...]:
        return tuple(self._chunk(ci) for ci in range(len(self._chunks)))

    @property
    def n_chunks(self) -> int:
        return len(self._chunks)

    @property
    def pending_slots(self) -> int:
        """Covered positions not yet sealed into a chunk (< chunk_slots)."""
        return self._covered - self._sealed

    def positions(self, window) -> Tuple[int, int]:
        """The window's ``[lo, hi)`` range over the time-first positions."""
        return window_positions_host(self.tger, window)

    def classify(self, window, hot_lo: Optional[int] = None) -> str:
        """Tier of a window against the hot horizon: ``"hot"`` (at or above
        ``hot_lo``), ``"cold"`` (entirely below) or ``"split"``
        (straddling).  ``hot_lo`` defaults to the store's watermark; the
        server passes its carried ring's own low watermark instead, so a
        forward-sliding chain stays hot even when another chain pushed the
        global watermark past it."""
        lo, hi = self.positions(window)
        hot_lo = self._covered if hot_lo is None else int(hot_lo)
        if lo >= hot_lo:
            return "hot"
        if hi <= hot_lo:
            return "cold"
        return "split"

    # -- compaction ----------------------------------------------------------

    def note_eviction(self, lo_new) -> int:
        """Extend coverage to the ring's new low watermark ``lo_new`` and
        seal every completed chunk span.  Monotone and idempotent: noting
        an already-covered watermark is free.  Returns the number of newly
        covered positions."""
        lo_new = min(max(int(lo_new), 0), self.n_positions)
        if lo_new <= self._covered:
            return 0
        added = lo_new - self._covered
        self._covered = lo_new
        while self._covered - self._sealed >= self.chunk_slots:
            self._seal(self._sealed, self._sealed + self.chunk_slots)
        self.n_compactions += 1
        return added

    def _seal(self, a: int, b: int) -> None:
        h = self._mirrors()
        eids = h["perm"][a:b]
        ts = h["t_start"][eids].astype(np.int64)
        dur = h["t_end"][eids].astype(np.int64) - ts
        w = h["weight"][eids]
        ss = h["start_sorted"]
        t_hi = (int(ss[b]) if b < ss.shape[0]
                else int(np.iinfo(np.int32).max))
        chunk = ColdChunk(
            pos_lo=a, pos_hi=b, t_lo=int(ts[0]), t_hi=t_hi,
            src=np.ascontiguousarray(h["src"][eids]),
            dst=np.ascontiguousarray(h["dst"][eids]),
            dt_start=_pack_unsigned(np.diff(ts)),
            dur=_pack_unsigned(dur),
            weight=(None if np.all(w == np.float32(1.0))
                    else np.ascontiguousarray(w)),
        )
        if self.spill_dir is not None:
            chunk = self._spill(chunk)
        self._chunks.append(chunk)
        self._sealed = b

    def _spill(self, chunk: ColdChunk) -> _SpilledChunk:
        """Write the sealed payload columns to ONE file under ``spill_dir``
        (the JAX package's file format) and keep only where they lie: the
        chunk is mapped back as read-only ``np.memmap`` views (an ndarray
        subclass: decode and every gather read through it unchanged) when
        it is read."""
        cols = dict(src=chunk.src, dst=chunk.dst,
                    dt_start=chunk.dt_start, dur=chunk.dur)
        if chunk.weight is not None:
            cols["weight"] = chunk.weight
        path = os.path.join(
            self.spill_dir,
            f"chunk_{chunk.pos_lo:012d}_{chunk.pos_hi:012d}.bin")
        mapped, resident = [], []
        with open(path, "wb") as f:
            for name, a in cols.items():
                if a.size == 0:
                    resident.append((name, a))
                else:
                    mapped.append((name, f.tell(), a.dtype, a.shape))
                f.write(np.ascontiguousarray(a).tobytes())
        self.n_spilled += 1
        return _SpilledChunk(
            pos_lo=chunk.pos_lo, pos_hi=chunk.pos_hi, t_lo=chunk.t_lo,
            t_hi=chunk.t_hi, path=path, nbytes=chunk.nbytes,
            mapped=tuple(mapped), resident=tuple(resident))

    # -- stitching -----------------------------------------------------------

    def chunks_for(self, window) -> List[ColdChunk]:
        """The sealed chunks whose start-time fence overlaps the window: the
        directory lookup (fences only, no payload bytes read)."""
        w0, w1 = int(window[0]), int(window[1])
        return [self._chunk(ci) for ci, c in enumerate(self._chunks)
                if c.t_lo <= w1 and w0 < c.t_hi]

    def _decode(self, ci: int) -> Tuple[np.ndarray, ...]:
        dec = self._decoded.get(ci)
        if dec is None:
            dec = self._chunk(ci).decode()
            if len(self._decoded) >= 8:     # bounded decode cache
                self._decoded.pop(next(iter(self._decoded)))
            self._decoded[ci] = dec
        return dec

    def gather_positions(self, pos: np.ndarray) -> Tuple[np.ndarray, ...]:
        """Edge columns for arbitrary time-first positions: sealed spans
        decode from their chunks, everything else (the pending tail and a
        split window's hot suffix) gathers from the host mirrors.
        Positions clamp to the last edge exactly as ``index_ring_view``
        does, so a stitched view's padding payload matches the device
        build bit for bit."""
        h = self._mirrors()
        pos = np.minimum(np.asarray(pos, np.int64), self.n_positions - 1)
        out = [np.empty(pos.shape, np.int32) for _ in range(4)]
        out.append(np.empty(pos.shape, np.float32))
        names = ("src", "dst", "t_start", "t_end", "weight")
        cold_sel = pos < self._sealed
        if not cold_sel.all():
            eids = h["perm"][pos[~cold_sel]]
            for o, nm in zip(out, names):
                o[~cold_sel] = h[nm][eids]
        if cold_sel.any():
            cpos = pos[cold_sel]
            cidx = cpos // self.chunk_slots
            filled = [o[cold_sel] for o in out]
            for ci in np.unique(cidx):
                dec = self._decode(int(ci))
                sel = cidx == ci
                local = cpos[sel] - self._chunks[int(ci)].pos_lo
                for f, col in zip(filled, dec):
                    f[sel] = col[local]
            for o, f in zip(out, filled):
                o[cold_sel] = f
        return tuple(out)

    def ring_stitch(self, window, capacity: int):
        """Host build of the index ring view over ``window``: bit-identical
        (slot order and masked payload included) to
        ``index_ring_view(g, tger, lo, hi, capacity=capacity)``, with the
        cold span decoded from the chunks instead of gathered on the
        device.  Returns ``(fields, mask, lo, hi)`` as numpy arrays; raises
        when the window spans more positions than ``capacity`` holds."""
        lo, hi = self.positions(window)
        if hi - lo > capacity:
            raise ValueError(
                f"window {tuple(int(w) for w in window)} spans {hi - lo} "
                f"time-first positions but the plan's ring capacity is "
                f"{capacity}; replan (the cold tier rungs its capacity "
                f"from the window span)")
        s = np.arange(capacity, dtype=np.int64)
        pos = lo + (s - lo) % capacity
        fields = self.gather_positions(pos)
        return fields, pos < hi, lo, hi

    # -- stats ---------------------------------------------------------------

    @property
    def nbytes(self) -> int:
        return sum(c.nbytes for c in self._chunks)

    def stats(self) -> Dict[str, float]:
        raw = self._sealed * _RAW_BYTES_PER_EDGE
        return dict(
            watermark=self._covered,
            sealed_slots=self._sealed,
            pending_slots=self.pending_slots,
            n_chunks=len(self._chunks),
            chunk_slots=self.chunk_slots,
            compactions=self.n_compactions,
            nbytes=self.nbytes,
            raw_nbytes=raw,
            compaction_ratio=(raw / self.nbytes) if self.nbytes else 0.0,
            spilled_chunks=self.n_spilled,
        )


__all__ = ["ColdStore", "ColdChunk"]
