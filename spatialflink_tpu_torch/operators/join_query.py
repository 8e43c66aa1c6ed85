"""Two-stream spatial joins (port of ``spatialflink_tpu.operators.
join_query``): a point, polygon or linestring stream joined with a point,
polygon or linestring query stream, windowed or realtime.

Reference: ``spatialOperators/join/*JoinQuery.java`` — the query stream
replicated to the neighbouring cells of each query object, a cell
equi-join per window, and the exact-distance filter. Here each window's
two sides go to the device as batches and one join lattice decides every
pair (``ops/join.py``): K7 then K6 for point x point
(``join_pairs_host``), K4x rows for point x geometry and geometry x point,
K5 in kNN mode for geometry x geometry. Both sides' cells are taken on
the operator's grid: a point batch assigns them from its coordinates (as
the JAX package's ``PointBatch.from_points`` on ``self.grid`` does for
both sides), a geometry keeps the cells its stream's decode gave it.

A window's records are its pairs (``streams.bulk.PairRecords``, iterated
as ``(record_a, record_b)`` tuples), in the order of the JAX package:
``np.nonzero`` of the lattice (by b tile, then a, then b for point x
point).

Windowed mode: two window assemblers, one per stream, and every window of
either side emitted once, in start order, with 0 pairs when one side is
empty (``runtime.merge_windows``, which says why that is the JAX
package's per-record sweep). Realtime mode: the two streams merged in
event-time order (``runtime.merge_by_time``, ``heapq.merge``'s order),
cut every ``realtime_batch_size`` arrivals; each cut joins its new
records against a rolling buffer of the last ``window_size_ms`` of both
sides (new_a x (buffer_b + new_b), then buffer_a x new_b), keeps pairs
within ``window_size_ms`` of each other, and so emits a pair across a cut
exactly once. Count windows are refused, as in the JAX package.

Pane mode (``conf.panes``, windowed only: a realtime join ignores it, as
in the JAX package): both sides buffer into slide-aligned panes
(``runtime.PaneBuffer``), and a window's pairs are the union of its
pane-pair blocks ``A_i x B_j``, in pane order, each block evaluated once
(``PaneCache`` keyed ``(pane_a, pane_b)``) and shared by every window
holding both panes; each pane's batch (and a point b pane's join index)
is built once per side. A window whose blocks are dispatch-bound (mean
padded block below ``ops.join.adaptive_block_min_cells``) is evaluated as
one coalesced lattice over its panes' records in pane order instead.
Block pairs stay deferred until the window's readback.
``run_bulk`` (windowed point x point only) joins the windows of two
bulk-parsed streams; its pairs are original-record index pairs.

Checkpoints (windowed, with or without panes): the component
``join-windows`` holds both sides' assemblers (or pane buffers) and the
windows taken from one side but not yet emitted (``sealed_a`` /
``sealed_b``, the JAX package's sealed-on-one-side maps), side b decoded
on the query stream's grid; with panes, also the block cache. The barrier
is :meth:`PointPointJoinQuery._pipeline`, which drains the windows in
flight before a commit. The realtime join keeps its rolling buffers out of
the checkpoint, and the driver refuses to checkpoint it, as the JAX
package's does. The device mesh is not ported.
"""

from __future__ import annotations

from collections import deque
from typing import Iterable, Iterator, List, Optional

import numpy as np
import torch

from spatialflink_tpu_torch.models import PointBatch
from spatialflink_tpu_torch.operators.base import (Deferred, PaneCache,
                                                   PanePartial, QueryType,
                                                   SpatialOperator,
                                                   WindowResult,
                                                   _record_chunks)
from spatialflink_tpu_torch.ops import join as J
from spatialflink_tpu_torch.runtime import PaneBuffer, WindowAssembler
from spatialflink_tpu_torch.runtime.windows import (encode_view,
                                                    merge_by_time,
                                                    merge_windows,
                                                    restored_view)
from spatialflink_tpu_torch.streams.bulk import PairRecords
from spatialflink_tpu_torch.utils import bucket_size
from spatialflink_tpu_torch.utils.metrics import ControlTupleExit


class _Joined(Deferred):
    """Two window results of one realtime cut read back as one: the first
    one's pairs, then the second one's."""

    __slots__ = ("parts",)

    def __init__(self, parts):
        self.parts = parts

    def finish(self) -> PairRecords:
        out = PairRecords()
        for p in self.parts:
            out = out + (p.finish() if isinstance(p, Deferred) else p)
        return out


def _combine_windows(r1: WindowResult, r2: WindowResult) -> WindowResult:
    """One result whose pairs are r1's followed by r2's; deferred inputs
    stay deferred."""
    if not isinstance(r1.records, Deferred) \
            and not isinstance(r2.records, Deferred):
        return WindowResult(r1.window_start, r1.window_end,
                            r1.records + r2.records)
    return WindowResult(r1.window_start, r1.window_end,
                        _Joined((r1.records, r2.records)))


def _view(segs):
    """The records of ``(chunk, idx)`` slices, or None without any."""
    segs = [s for s in segs if s[1].size]
    return segs[0][0].view(segs) if segs else None


def _concat(panes):
    """The records of a window's ``(pane_start, records)`` list, in pane
    order (the coalesced window's order)."""
    return _view([seg for _, recs in panes for seg in recs._segs])


class _Blocks(Deferred):
    """A pane window's pairs: its blocks' pairs, block by block, each block
    read back once however many windows share it."""

    __slots__ = ("blocks",)

    def __init__(self, blocks):
        self.blocks = blocks

    def finish(self) -> PairRecords:
        out = PairRecords()
        for h in self.blocks:
            out = out + h.resolve()
        return out


def _merge_sealed(gens, sealed, size_ms: int) -> Iterator:
    """``runtime.merge_windows`` over the two sides' start-ordered window
    streams, the window taken from a side and not yet emitted held in
    ``sealed[side]`` (start -> records), where a checkpoint finds it (and
    a restored one is emitted first)."""
    its = [iter(g) for g in gens]
    done = [False, False]

    def head(s: int):
        if not sealed[s] and not done[s]:
            w = next(its[s], None)
            if w is None:
                done[s] = True
            else:
                sealed[s][w[0]] = w[2]
        return min(sealed[s]) if sealed[s] else None

    while True:
        heads = (head(0), head(1))
        if heads == (None, None):
            return
        start = min(h for h in heads if h is not None)
        recs = [sealed[s].pop(start) if heads[s] == start else None
                for s in (0, 1)]
        yield start, start + size_ms, recs[0], recs[1]


def _keep(ai, bi, recs_a, recs_b, max_dt):
    """The pairs of real records (not padding), and with ``max_dt`` only
    those whose event times lie within it of each other."""
    keep = (ai < len(recs_a)) & (bi < len(recs_b))
    ai, bi = ai[keep], bi[keep]
    if max_dt is not None and ai.size:
        near = np.abs(recs_a.ts()[ai] - recs_b.ts()[bi]) <= max_dt
        ai, bi = ai[near], bi[near]
    return PairRecords([(recs_a, recs_b, ai, bi)])


class PointPointJoinQuery(SpatialOperator):
    """Point stream x point query stream (``PointPointJoinQuery.java``)."""
    telemetry_label = "join"

    #: the naive twins (the trajectory join's 2090) turn the grid pruning
    #: off: every cell is a neighbour, the exact distance filter stays
    prune_cells = True

    def __init__(self, conf, grid, grid2=None, *, device="cuda"):
        """``grid2``, the query stream's grid, is taken for the JAX
        package's signature: its decode assigned the query stream's cells,
        and the join compares cells on ``grid``."""
        if conf.query_type is QueryType.CountBased:
            # a count trigger over two streams is ambiguous (whose
            # arrivals count?); the JAX package refuses it too
            raise NotImplementedError(
                "CountBased queries are not yet supported")
        super().__init__(conf, grid, device=device)
        self.grid2 = grid2 if grid2 is not None else grid
        #: pane-pair blocks of the last pane run coalesced into their
        #: windows' one lattice (``pane_cache`` counts the blocks
        #: evaluated, its misses, and those taken from it, its hits)
        self.blocks_coalesced = 0

    def run(self, ordinary: Iterable, query_stream: Iterable,
            radius: float) -> Iterator[WindowResult]:
        J.lattice_strategy()  # refuses the unported bf16 lattice up front
        if self.realtime:
            results = self._run_realtime(ordinary, query_stream, radius)
        elif self._panes_active():
            results = self._run_windowed_panes(ordinary, query_stream,
                                               radius)
        else:
            results = self._run_windowed(ordinary, query_stream, radius)
        return self._pipeline(results)

    def _pipeline(self, results: Iterator[WindowResult]
                  ) -> Iterator[WindowResult]:
        """Up to ``conf.pipeline_depth`` deferred windows in flight, read
        back in window order; eager results pass through once the older
        deferred ones have drained."""
        depth = max(1, self.conf.pipeline_depth)
        pending: deque = deque()
        coord = self.conf.checkpointer

        def force(r: WindowResult) -> WindowResult:
            if isinstance(r.records, Deferred):
                r.records = r.records.finish()
            return r

        results = iter(results)
        while True:
            try:
                r = next(results)
            except StopIteration:
                break
            except ControlTupleExit:
                while pending:  # a stop: the windows in flight emit first
                    yield force(pending.popleft())
                raise
            if isinstance(r.records, Deferred):
                pending.append(r)
                while len(pending) > depth - 1:
                    yield force(pending.popleft())
            else:
                while pending:
                    yield force(pending.popleft())
                yield r
            if coord is not None:
                # the checkpoint barrier: the windows in flight have left
                # the snapshotted assemblers and sealed maps, so they are
                # emitted before the manifest is written
                coord.note_batch()
                if coord.due():
                    while pending:
                        yield force(pending.popleft())
                    coord.commit()
        while pending:
            yield force(pending.popleft())

    def _sides(self, ordinary, query_stream, buffer_cls, panes: bool):
        """Both sides' assemblers (``buffer_cls``: window assemblers or pane
        buffers) and their sealed-on-one-side maps, registered with the
        checkpoint coordinator; returns the merged ``(start, end, a, b)``
        window stream."""
        spec = self.conf.window_spec()
        bufs = [buffer_cls(spec, self.conf.allowed_lateness_ms)
                for _ in range(2)]
        sealed = ({}, {})
        self._register_ckpt_join(bufs, sealed, panes)
        gens = [b.assemble(_record_chunks(s, self.grid))
                for b, s in zip(bufs, (ordinary, query_stream))]
        return _merge_sealed(gens, sealed, spec.size_ms)

    def _register_ckpt_join(self, bufs, sealed, panes: bool) -> None:
        """The coordinator's ``join-windows`` participant: both sides'
        buffers and sealed maps (``panes``: a sealed window is a list of
        ``(pane_start, records)``), side b on the query stream's grid."""
        coord = self.conf.checkpointer
        if coord is None:
            return
        from spatialflink_tpu_torch.runtime.checkpoint import record_codec

        enc, dec_a = record_codec(self.grid)
        _, dec_b = record_codec(self.grid2)

        def enc_recs(recs):
            return encode_view(recs, enc)

        def enc_sealed(m):
            if panes:
                return {str(s): [[p, enc_recs(r)] for p, r in pl]
                        for s, pl in m.items()}
            return {str(s): enc_recs(r) for s, r in m.items()}

        def dec_sealed(state, m, dec):
            def view(recs):
                return restored_view(recs, dec)
            for s, v in state.items():
                m[int(s)] = ([(int(p), view(r)) for p, r in v] if panes
                             else view(v))

        def snap():
            return ({}, {"a": bufs[0].snapshot(enc),
                         "b": bufs[1].snapshot(enc),
                         "sealed_a": enc_sealed(sealed[0]),
                         "sealed_b": enc_sealed(sealed[1])})

        def restore(_arrays, meta):
            bufs[0].restore(meta["a"], dec_a)
            bufs[1].restore(meta["b"], dec_b)
            dec_sealed(meta["sealed_a"], sealed[0], dec_a)
            dec_sealed(meta["sealed_b"], sealed[1], dec_b)

        coord.register("join-windows", snap, restore)

    def _run_windowed(self, ordinary, query_stream, radius
                      ) -> Iterator[WindowResult]:
        for start, end, recs_a, recs_b in self._sides(
                ordinary, query_stream, WindowAssembler, panes=False):
            yield self._join_window(start, end, recs_a, recs_b, radius)

    def _run_windowed_panes(self, ordinary, query_stream, radius
                            ) -> Iterator[WindowResult]:
        """The pane join (``conf.panes``): the window set, sealing and late
        drops of :meth:`_run_windowed`, each side's windows as pane lists;
        a window's pairs are its pane-pair blocks' in pane order (the pair
        SET is the full window's), or one coalesced lattice when its blocks
        are dispatch-bound (:meth:`_blocks_dispatch_bound`)."""
        slide = self.conf.window_spec().slide_ms
        windows = self._sides(ordinary, query_stream, PaneBuffer, panes=True)
        # a block is needed while both its panes can appear in a later
        # window: its eviction hinges on the earlier pane
        cache = self.pane_cache = PaneCache(slide, key_floor=min)
        self._register_ckpt_pane_cache("pane-cache", cache)
        # each pane's batch once per side, shared by every block holding it
        memo = ({}, {})
        self.blocks_coalesced = 0

        def block(pa, ra, pb, rb) -> PanePartial:
            def evaluate():
                if pa not in memo[0]:
                    memo[0][pa] = self._batch_a(ra, pa)
                if pb not in memo[1]:
                    memo[1][pb] = self._pane_batch_b(rb, pb)
                return PanePartial(self._join_block(
                    memo[0][pa], ra, memo[1][pb], rb, radius))

            return cache.get((pa, pb), evaluate)

        def evict(start: int) -> None:
            cache.evict_before(start)
            for m in memo:
                for dead in [p for p in m if p < start + slide]:
                    del m[dead]

        for start, end, panes_a, panes_b in windows:
            panes_a, panes_b = panes_a or [], panes_b or []
            if self._blocks_dispatch_bound(panes_a, panes_b):
                self.blocks_coalesced += len(panes_a) * len(panes_b)
                evict(start)
                yield self._join_window(start, end, _concat(panes_a),
                                        _concat(panes_b), radius)
                continue
            blocks = [block(pa, ra, pb, rb)
                      for pa, ra in panes_a for pb, rb in panes_b]
            evict(start)
            yield WindowResult(start, end,
                               _Blocks(blocks) if blocks else PairRecords())

    def _blocks_dispatch_bound(self, panes_a, panes_b) -> bool:
        """The window's mean pane-pair block, in padded cells (the launch
        shapes), lies below ``ops.join.adaptive_block_min_cells`` on the
        operator's device."""
        if not panes_a or not panes_b or len(panes_a) * len(panes_b) <= 1:
            return False
        min_cells = J.adaptive_block_min_cells(self.device)
        if min_cells <= 0:
            return False
        mean_a = sum(bucket_size(max(len(rs), 1))
                     for _, rs in panes_a) / len(panes_a)
        mean_b = sum(bucket_size(max(len(rs), 1))
                     for _, rs in panes_b) / len(panes_b)
        return mean_a * mean_b < min_cells

    def _pane_batch_b(self, records, ts_base: int):
        """A b pane's batch and its join index, built once for all the
        blocks that hold the pane."""
        b = self._batch_b(records, ts_base)
        return b, J.join_index(b, self.grid.n)

    def _join_block(self, batch_a, recs_a, batch_b, recs_b, radius):
        """One pane-pair block from the panes' prebuilt batches; the batches'
        ts bases differ, and the join reads positions and cells only."""
        b, index = batch_b
        ai, bi = self._pairs(batch_a, b, radius, index=index)
        return _keep(ai, bi, recs_a, recs_b, None)

    def _pairs(self, batch_a, batch_b, radius, *, index=None):
        """Two point batches' pairs as host arrays (``ops.join.
        join_pairs_host``), every cell a neighbour where ``prune_cells`` is
        off: the one pair call of the window, block and bulk paths."""
        return J.join_pairs_host(batch_a, batch_b, radius, self.grid,
                                 nb_layers=None if self.prune_cells
                                 else self.grid.n, index=index)

    def run_bulk(self, parsed_a, parsed_b, radius: float
                 ) -> Iterator[WindowResult]:
        """Windowed join of two bulk-parsed point streams
        (``streams.bulk.ParsedPoints``): both sides' windows from
        ``bulk_window_batches`` on the operator's grid, one-sided windows
        with no pairs; records are ``(index_a, index_b)`` pairs of original
        records."""
        from spatialflink_tpu_torch.streams.bulk import bulk_window_batches

        if self.realtime:
            raise ValueError("run_bulk supports windowed mode only")
        J.lattice_strategy()
        spec = self.conf.window_spec()
        sides = [((s, e, (idx, batch)) for s, e, idx, batch in
                  bulk_window_batches(p, spec, self.grid,
                                      device=self.device))
                 for p in (parsed_a, parsed_b)]
        for start, end, a_win, b_win in merge_windows(*sides):
            pairs = []
            if a_win is not None and b_win is not None:
                (idx_a, batch_a), (idx_b, batch_b) = a_win, b_win
                ai, bi = self._pairs(batch_a, batch_b, radius)
                keep = (ai < idx_a.size) & (bi < idx_b.size)
                pairs = list(zip(idx_a[ai[keep]].tolist(),
                                 idx_b[bi[keep]].tolist()))
            yield WindowResult(start, end, pairs)

    def _run_realtime(self, ordinary, query_stream, radius
                      ) -> Iterator[WindowResult]:
        """Cuts of ``realtime_batch_size`` merged arrivals over a rolling
        buffer of the last ``window_size_ms`` (the reference's realtime
        joins buffer a small window per stream with fire-per-element
        triggers, ``tJoin/TJoinQuery.java:216-268``)."""
        win = self.conf.window_size_ms
        size = max(1, int(self.conf.realtime_batch_size))
        buf: List[List] = [[], []]  # (chunk, idx) slices per side
        new: List[List] = [[], []]

        def fire(end_ts: int) -> Optional[WindowResult]:
            # evict only what cannot pair with ANY new arrival: the earliest
            # new record sets the horizon; the max_dt filter keeps
            # |ta - tb| <= win exactly
            first_new = min(int(ch.ts[idx].min()) for side in new
                            for ch, idx in side)
            cutoff = first_new - win
            for s in (0, 1):
                buf[s] = [(ch, idx[ch.ts[idx] >= cutoff])
                          for ch, idx in buf[s]]
                buf[s] = [seg for seg in buf[s] if seg[1].size]
            all_b = buf[1] + new[1]
            # new_a x (old_b + new_b) and old_a x new_b: every pair with a
            # new member once, never the old x old block again
            start = end_ts - win
            r1 = self._join_window(start, end_ts, _view(new[0]), _view(all_b),
                                   radius, max_dt=win)
            r2 = self._join_window(start, end_ts, _view(buf[0]),
                                   _view(new[1]), radius, max_dt=win)
            res = _combine_windows(r1, r2)
            buf[0], buf[1] = buf[0] + new[0], all_b
            new[0], new[1] = [], []
            if not isinstance(res.records, Deferred) and not res.records:
                return None  # realtime cuts never emit known-empty results
            return res

        chunks = (_record_chunks(ordinary, self.grid),
                  _record_chunks(query_stream, self.grid))
        seen = last = 0
        for side, ch, idx in merge_by_time(*chunks):
            pos = 0
            while pos < idx.size:
                take = min(size - seen, idx.size - pos)
                new[side].append((ch, idx[pos:pos + take]))
                seen += take
                pos += take
                last = int(ch.ts[idx[pos - 1]])
                if seen >= size:
                    seen = 0
                    res = fire(last)
                    if res is not None:
                        yield res
        if new[0] or new[1]:
            res = fire(last)
            if res is not None:
                yield res

    # ---------------------------------------------------------------- #

    def _point_batch(self, records, ts_base: int) -> PointBatch:
        """A side's point batch with cells assigned on the operator's grid
        from the coordinates (whatever grid the stream was decoded on)."""
        x, y, ts, oid, _, _ = records.columns()
        return PointBatch.from_arrays(x, y, device=self.device,
                                      grid=self.grid, obj_id=oid, ts=ts,
                                      ts_base=ts_base)

    def _batch_a(self, records, ts_base: int):
        return self._point_batch(records, ts_base)

    _batch_b = _batch_a

    def _join_window(self, start, end, recs_a, recs_b, radius, *,
                     max_dt: Optional[int] = None) -> WindowResult:
        """One window's pairs (eagerly: K6's pair total is read to size its
        output). ``max_dt``: the realtime co-residence bound."""
        if not (recs_a is not None and len(recs_a)
                and recs_b is not None and len(recs_b)):
            return WindowResult(start, end, PairRecords())
        ai, bi = self._pairs(self._batch_a(recs_a, start),
                             self._batch_b(recs_b, start), radius)
        return WindowResult(start, end,
                            _keep(ai, bi, recs_a, recs_b, max_dt))


class _GenericStreamJoin(PointPointJoinQuery):
    """Two-stream join over a geometry lattice: subclasses give the batches
    and ``_lattice(a, b, radius) -> (Ga, Gb)`` bool on the device. The
    pairs are compacted on the device and read back deferred."""

    def _nb_layers(self, radius):
        # radius 0 => every cell is a neighbour (UniformGrid.java:264-266)
        return self.grid.n if radius == 0 \
            else self.grid.candidate_layers(radius)

    def _geom_batch(self, records, ts_base: int):
        return records.geom_batch(ts_base, self.device, self.interner)[0]

    def _join_window(self, start, end, recs_a, recs_b, radius, *,
                     max_dt: Optional[int] = None) -> WindowResult:
        if not (recs_a is not None and len(recs_a)
                and recs_b is not None and len(recs_b)):
            return WindowResult(start, end, PairRecords())
        m = self._lattice(self._batch_a(recs_a, start),
                          self._batch_b(recs_b, start), radius)
        pairs = torch.nonzero(m.contiguous())

        def collect(host):
            (p,) = host
            return _keep(p[:, 0], p[:, 1], recs_a, recs_b, max_dt)

        return WindowResult(start, end, Deferred((pairs,), collect))

    def _pane_batch_b(self, records, ts_base: int):
        return self._batch_b(records, ts_base)

    def _join_block(self, batch_a, recs_a, batch_b, recs_b, radius):
        """One pane-pair block from the panes' prebuilt batches: the
        window's lattice kernel, the pairs compacted on the device and read
        back deferred."""
        pairs = torch.nonzero(self._lattice(batch_a, batch_b,
                                            radius).contiguous())

        def collect(host):
            (p,) = host
            return _keep(p[:, 0], p[:, 1], recs_a, recs_b, None)

        return Deferred((pairs,), collect)


class PointGeomJoinQuery(_GenericStreamJoin):
    """Point stream x polygon/linestring query stream
    (``PointPolygonJoinQuery.java``, ``PointLineStringJoinQuery``)."""

    def _batch_b(self, records, ts_base: int):
        return self._geom_batch(records, ts_base)

    def _lattice(self, a, b, radius):
        return J.join_point_geom_rows(a, b, radius, self._nb_layers(radius),
                                      n=self.grid.n).T


class GeomPointJoinQuery(_GenericStreamJoin):
    """Polygon/linestring stream x point query stream
    (``PolygonPointJoinQuery.java``, ``LineStringPointJoinQuery``): the
    point x geometry rows with the sides swapped."""

    def _batch_a(self, records, ts_base: int):
        return self._geom_batch(records, ts_base)

    def _batch_b(self, records, ts_base: int):
        return self._point_batch(records, ts_base)

    def _lattice(self, a, b, radius):
        return J.join_point_geom_rows(b, a, radius, self._nb_layers(radius),
                                      n=self.grid.n)


class GeomGeomJoinQuery(_GenericStreamJoin):
    """Polygon/linestring stream x polygon/linestring query stream
    (``PolygonPolygonJoinQuery.java`` and its three siblings)."""

    def _batch_a(self, records, ts_base: int):
        return self._geom_batch(records, ts_base)

    _batch_b = _batch_a

    def _lattice(self, a, b, radius):
        return J.join_geom_geom_mask(a, b, radius, self._nb_layers(radius),
                                     n=self.grid.n)


# Reference-named aliases
PointPolygonJoinQuery = PointGeomJoinQuery
PointLineStringJoinQuery = PointGeomJoinQuery
PolygonPointJoinQuery = GeomPointJoinQuery
LineStringPointJoinQuery = GeomPointJoinQuery
PolygonPolygonJoinQuery = GeomGeomJoinQuery
PolygonLineStringJoinQuery = GeomGeomJoinQuery
LineStringPolygonJoinQuery = GeomGeomJoinQuery
LineStringLineStringJoinQuery = GeomGeomJoinQuery
