"""Trajectory operators (port of ``spatialflink_tpu.operators.trajectory``;
reference: ``spatialOperators/t*``). All six families, keyed by object id:

- :class:`PointTFilterQuery` — trajectory-id filter + windowed LineString
  re-assembly (``tFilter/PointTFilterQuery.java``); no device work.
- :class:`PointPolygonTRangeQuery` — trajectories passing through a set of
  query polygons (``tRange/PointPolygonTRangeQuery.java``): a cell
  prefilter on the host, then the even-odd containment of K4x's parity
  output; :meth:`~PointPolygonTRangeQuery.run_naive` tests every point
  (``tRange/TRangeQuery.java:33-63``).
- :class:`PointTStatsQuery` — running spatial / temporal length and speed
  (K8a ``tstats_update``; panes: K8b ``tstats_window_summary`` per pane
  and the host stitch).
- :class:`PointTAggregateQuery` — per-cell heatmap of trajectory lengths
  (K8c, K8d; realtime over the host extent store with stale-trajectory
  eviction; per-cell count windows on the host).
- :class:`PointPointTJoinQuery` — trajectory x trajectory proximity join
  (the point join's K7/K6), deduped per (trajectory, partner) keeping the
  latest pair (``tJoin/PointPointTJoinQuery.java:133-177``); naive twin
  without cell pruning.
- :class:`PointPointTKNNQuery` — the k nearest trajectories within an exact
  radius (K2 with its radius filter), single and multi-query; naive twin
  without cell pruning.

Windows. The JAX package gives these operators materialized records
(``columnar_windows = False``) because their device batches number object
ids through the OPERATOR's interner, across windows, in the order the
batches are built (``PointBatch.from_points``): the first-seen order of the
records each family batches (all of a window's, a tRange window's cell
candidates, a tStats window's allowed ones, a pane's). Here windows stay
columnar (``LazyRecords`` / ``PointRows`` over the decoded chunks) and
:meth:`_TrajOperator._op_ids` renumbers a batch's stream ids through the
operator's interner in that same first-seen order, so the sort orders,
ties and emission orders that follow the ids are the JAX operator's.
Records become :class:`Point` / :class:`LineString` objects only where a
result holds them (sub-trajectories, selections).

Checkpoints. Under a ``runtime.checkpoint.CheckpointCoordinator``
(``conf.checkpointer``) the windowed loops register their window or pane
buffers and pane caches (with the operator's interner) and barrier after
each emitted window; realtime tStats registers ``tstats`` (K8a's carried
state read back to the host, its capacity, ``ts_base``, the records
consumed and the interner) and realtime tAggregate ``taggregate`` (the
extent rows), the JAX package's components. The legacy single-file
``--checkpoint`` of realtime tStats / tAggregate (``checkpoint_path``,
every ``checkpoint_every`` micro-batches and at the end) writes the JAX
package's files; a restored tStats state goes back to the operator's
device in fresh tensors, and K8a carries it on.

The trajectory self-join (:meth:`PointPointTJoinQuery.run_single`) joins
a stream with itself through the same K6 / K7 path and drops the pairs of
one object with itself. Not ported: the device mesh.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

import numpy as np

from spatialflink_tpu_torch.index.uniform_grid import observe_cells
from spatialflink_tpu_torch.models import (EdgeGeomBatch, LineString, Point,
                                            PointBatch)
from spatialflink_tpu_torch.operators.base import (PaneCache, QueryType,
                                                   SpatialOperator,
                                                   WindowResult,
                                                   _record_chunks)
from spatialflink_tpu_torch.operators.join_query import PointPointJoinQuery
from spatialflink_tpu_torch.ops import hopper_kernels as HK
from spatialflink_tpu_torch.ops import knn as K
from spatialflink_tpu_torch.ops import trajectory as T
from spatialflink_tpu_torch.runtime import MicroBatcher, PaneBuffer
from spatialflink_tpu_torch.runtime.state import (CheckpointableState,
                                                  TrajStateStore)
from spatialflink_tpu_torch.streams.bulk import PairRecords, PointRows
from spatialflink_tpu_torch.utils import IdInterner, bucket_size


# ------------------------------------------------------------------------ #
# columnar records


def _rows(records) -> PointRows:
    """A window's records as one :class:`PointRows` (columns concatenated
    once)."""
    if isinstance(records, PointRows):
        return records
    return PointRows(records.columns(), records.interner)


def _ts(rows: PointRows) -> np.ndarray:
    return rows.columns()[2]


def _with_ids(rows: PointRows, names: Set[str]) -> np.ndarray:
    """(N,) bool: the records whose object id is one of ``names``."""
    lookup = rows.interner._to_int if rows.interner is not None else {}
    ids = [lookup[s] for s in names if s in lookup]
    return np.isin(rows.columns()[3], np.asarray(ids, np.int32))


def _ids_of(rows: PointRows, idx) -> Set[str]:
    """The object id strings of the records at ``idx``."""
    oid = np.unique(rows.columns()[3][idx])
    return {rows.interner.lookup(int(o)) for o in oid}


def assemble_subtrajectories(rows) -> Dict[str, object]:
    """objID -> time-sorted LineString of its window points (a single point
    stays a Point), objects in order of first appearance, each object's
    points stably sorted by timestamp (``tFilter/PointTFilterQuery.java:79-
    123``; the JAX package's ``assemble_subtrajectories`` on a record
    list)."""
    x, y, ts, oid, cell, ingest = rows.columns()
    out: Dict[str, object] = {}
    if oid.shape[0] == 0:
        return out
    uniq, first, inv = np.unique(oid, return_index=True, return_inverse=True)
    rank = np.empty(uniq.shape[0], np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(uniq.shape[0])
    group = rank[inv.reshape(-1)]
    order = np.lexsort((ts, group))
    gs = group[order]
    bounds = np.flatnonzero(np.r_[True, gs[1:] != gs[:-1], True])
    lo, hi = bounds[:-1], bounds[1:]
    xs, ys = x[order], y[order]
    box = [f.reduceat(a, lo).tolist() for f, a in
           ((np.minimum, xs), (np.minimum, ys), (np.maximum, xs),
            (np.maximum, ys))]
    xl, yl, tl = xs.tolist(), ys.tolist(), ts[order].tolist()
    lookup = rows.interner.lookup
    for g, (a, b) in enumerate(zip(lo.tolist(), hi.tolist())):
        i = int(order[a])
        sid = lookup(int(oid[i]))
        if b - a >= 2:
            out[sid] = LineString(
                obj_id=sid, timestamp=tl[b - 1],
                coords_list=list(zip(xl[a:b], yl[a:b])),
                bbox=(box[0][g], box[1][g], box[2][g], box[3][g]))
        else:
            out[sid] = Point(obj_id=sid, timestamp=int(ts[i]),
                             x=float(x[i]), y=float(y[i]), cell=int(cell[i]),
                             ingestion_time=int(ingest[i]))
    return out


def _to_host(*tensors) -> List[np.ndarray]:
    return [t.cpu().numpy() for t in tensors]


class _TrajOperator(SpatialOperator):
    """Shared plumbing: window batches whose object ids the operator's
    interner numbers across windows, in the JAX operator's order."""

    def __init__(self, conf, grid, *, device="cuda"):
        super().__init__(conf, grid, device=device)
        # stream interner -> (interner, operator id of each stream id)
        self._id_maps: Dict[int, Tuple[object, np.ndarray]] = {}

    def _op_ids(self, rows: PointRows) -> np.ndarray:
        """The operator interner's id of each record, interning new ids in
        the order the records first show them (``PointBatch.from_points``
        of the JAX package over the same records)."""
        oid = rows.columns()[3]
        src = rows.interner
        entry = self._id_maps.get(id(src))
        size = len(src) if src is not None else 0
        if entry is None or entry[1].shape[0] < size:
            old = entry[1] if entry is not None else np.zeros(0, np.int64)
            grown = np.full(max(size, 2 * old.shape[0]), -1, np.int64)
            grown[:old.shape[0]] = old
            entry = self._id_maps[id(src)] = (src, grown)
        table = entry[1]
        out = table[oid]
        new = out < 0
        if new.any():
            fresh = oid[new]
            uniq, first = np.unique(fresh, return_index=True)
            for s in uniq[np.argsort(first, kind="stable")].tolist():
                table[s] = self.interner.intern(src.lookup(s))
            out = table[oid]
        return out

    def _windows(self, stream: Iterable):
        """The base windows; a windowed run's checkpoint also carries the
        operator's interner, so a resumed window lists its trajectories in
        the uninterrupted run's id order (a realtime tStats run carries it
        in its ``tstats`` component)."""
        if not self.realtime:
            self._register_ckpt_interner()
        return super()._windows(stream)

    def _point_batch(self, rows: PointRows, ts_base: int) -> PointBatch:
        x, y, ts, _, cell, _ = rows.columns()
        observe_cells(cell)
        return PointBatch.from_arrays(x, y, device=self.device,
                                      obj_id=self._op_ids(rows), ts=ts,
                                      ts_base=ts_base, cell=cell)

    def _micro_batches(self, stream: Iterable) -> Iterator[PointRows]:
        """Realtime micro-batches of ``realtime_batch_size`` arrivals,
        whatever the query type (the naive twins' driver)."""
        mb = MicroBatcher(self.conf.realtime_batch_size)
        for _, _, records in mb.batches(_record_chunks(stream, self.grid)):
            yield _rows(records)

    def _pane_stream(self, stream: Iterable) -> Iterator[Tuple]:
        """``(start, end, [(pane_start, rows), ...])`` pane windows."""
        self.pane_cache = PaneCache(self.conf.slide_ms)
        self._register_ckpt_pane_cache("pane-cache", self.pane_cache)
        pb = PaneBuffer(self.conf.window_spec(),
                        self.conf.allowed_lateness_ms)
        self._register_ckpt_windows("panes", pb)
        for start, end, panes in pb.assemble(_record_chunks(stream,
                                                            self.grid)):
            yield start, end, [(p, _rows(r)) for p, r in panes]


class PointTFilterQuery(_TrajOperator):
    """Keep only trajectories whose objID is in ``traj_ids`` (empty =>
    all); windows emit each kept trajectory as a sub-trajectory."""
    telemetry_label = "tfilter"

    def run(self, stream: Iterable, traj_ids: Set[str]
            ) -> Iterator[WindowResult]:
        allowed = set(traj_ids)
        for start, end, records in self._windows(stream):
            rows = _rows(records)
            sel = rows.take(_with_ids(rows, allowed)) if allowed else rows
            if self.realtime:
                if len(sel):
                    yield WindowResult(start, end, sel)
            else:
                yield WindowResult(
                    start, end, list(assemble_subtrajectories(sel).values()))
                self._checkpoint_barrier()


class PointPolygonTRangeQuery(_TrajOperator):
    """Trajectories passing through any of a set of query polygons."""
    telemetry_label = "trange"

    def _prepare(self, polygons):
        """The query side, once per run: the polygons' edge batch (their
        ids interned first, as the JAX package's ``EdgeGeomBatch``
        does) and the union of their cells."""
        gb = EdgeGeomBatch.from_objects(list(polygons), device=self.device,
                                        interner=self.interner)
        cells = set()
        for poly in polygons:
            cells |= poly.cells
        cell_mask = np.zeros(self.grid.num_cells, bool)
        cell_mask[sorted(cells)] = True
        return gb, cell_mask

    @staticmethod
    def _cell_prefilter(rows: PointRows, cell_mask) -> np.ndarray:
        """Positions of the records whose cell is one of the polygons'
        cells (a point inside a polygon lies in its bbox's cells)."""
        cell = rows.columns()[4]
        ok = cell >= 0
        ok[ok] = cell_mask[cell[ok]]
        return np.nonzero(ok)[0]

    def _match_mask(self, rows: PointRows, gb, ts_base: int) -> np.ndarray:
        """(len(rows),) bool: inside any query polygon by the even-odd rule
        (K4x's parity output, the JAX package's ``points_in_geoms``)."""
        b = self._point_batch(rows, ts_base)
        _, inside = HK.pip_lattice(b.x, b.y, gb.edges, gb.edge_mask,
                                   gb.is_areal, cell=b.cell,
                                   num_cells=self.grid.num_cells,
                                   parity=True)
        m = (inside & gb.valid[:, None]).any(dim=0) & b.valid
        return m.cpu().numpy()[:len(rows)]

    def _matched(self, rows: PointRows, gb, cell_mask, ts_base: int
                 ) -> np.ndarray:
        """Positions of the matching records among the cell candidates."""
        cand = self._cell_prefilter(rows, cell_mask)
        if cand.size == 0:
            return cand
        return cand[self._match_mask(rows.take(cand), gb, ts_base)]

    def run(self, stream: Iterable, polygons) -> Iterator[WindowResult]:
        gb, cell_mask = self._prepare(polygons)
        if self.realtime:
            for start, end, records in self._windows(stream):
                rows = _rows(records)
                hit = self._matched(rows, gb, cell_mask, start)
                if hit.size:
                    yield WindowResult(start, end, rows.take(hit))
        elif self._panes_active():
            yield from self._run_windowed_panes(stream, gb, cell_mask)
        else:
            # the matched trajectories' FULL window points, as
            # sub-trajectories (tRange/PointPolygonTRangeQuery.java:90-177)
            for start, end, records in self._windows(stream):
                rows = _rows(records)
                hit = self._matched(rows, gb, cell_mask, start)
                matched = _ids_of(rows, hit) if hit.size else set()
                sel = rows.take(_with_ids(rows, matched))
                yield WindowResult(
                    start, end, list(assemble_subtrajectories(sel).values()),
                    extras={"matched_ids": matched})
                self._checkpoint_barrier()

    def _run_windowed_panes(self, stream, gb, cell_mask
                            ) -> Iterator[WindowResult]:
        """``--panes``: the containment runs once per pane, giving its
        matched id set; a window's set is the union of its panes' sets and
        its sub-trajectories are assembled from its panes' records in pane
        order."""
        for start, end, panes in self._pane_stream(stream):
            matched: Set[str] = set()
            for pstart, prows in panes:
                matched |= self.pane_cache.get(
                    pstart, lambda: self._pane_partial(prows, gb, cell_mask,
                                                       pstart))
            self.pane_cache.evict_before(start)
            sel = PointRows.concat([r.take(_with_ids(r, matched))
                                    for _, r in panes])
            yield WindowResult(
                start, end, list(assemble_subtrajectories(sel).values()),
                extras={"matched_ids": matched})
            self._checkpoint_barrier()

    def _pane_partial(self, prows, gb, cell_mask, pstart) -> Set[str]:
        hit = self._matched(prows, gb, cell_mask, pstart)
        return _ids_of(prows, hit) if hit.size else set()

    def run_naive(self, stream: Iterable, polygons
                  ) -> Iterator[WindowResult]:
        """Exhaustive twin: every polygon tested per point, no cell pruning
        (``tRange/TRangeQuery.java:33-63``), over realtime micro-batches."""
        gb, _ = self._prepare(polygons)
        for rows in self._micro_batches(stream):
            ts = _ts(rows)
            hit = np.nonzero(self._match_mask(rows, gb, int(ts[0])))[0]
            if hit.size:
                yield WindowResult(int(ts[0]), int(ts[-1]), rows.take(hit))


class PointTStatsQuery(_TrajOperator):
    """Per-trajectory spatial length / temporal length / average speed.

    Realtime mode carries the state across micro-batches (the reference's
    per-objID ValueStates) with a per-batch ``ts_base`` and the carried
    offsets rebased between batches; windowed mode recomputes each window
    from fresh state (``tStats/TStatsQuery.java:153-197``) and reports one
    tuple per trajectory: (objID, spatial, temporal ms, speed)."""
    telemetry_label = "tstats"

    #: device ts offsets are int32: a micro-batch spanning more event time
    #: is split on the host first
    _SPAN_HORIZON_MS = 2 ** 30

    def run(self, stream: Iterable, traj_ids: Optional[Set[str]] = None,
            *, checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 16, resume: bool = True,
            checkpoint_job: Optional[str] = None
            ) -> Iterator[WindowResult]:
        """``checkpoint_path`` (realtime) makes the run durable: every
        ``checkpoint_every`` micro-batches with records, and at the end,
        the carried state, the interner, ``ts_base`` and the records
        consumed are saved atomically; ``resume`` restores them at start.
        ``checkpoint_job`` (the driver's job fingerprint) is stored, and a
        file of another job is refused."""
        allowed = set(traj_ids or ())
        if self.realtime:
            yield from self._run_realtime(
                stream, allowed, checkpoint_path=checkpoint_path,
                checkpoint_every=checkpoint_every, resume=resume,
                checkpoint_job=checkpoint_job)
        elif self._panes_active():
            yield from self._run_windowed_panes(stream, allowed)
        else:
            for start, end, records in self._windows(stream):
                rows = _rows(records)
                if allowed:
                    rows = rows.take(_with_ids(rows, allowed))
                yield WindowResult(start, end,
                                   self._window_tuples(rows, start))
                self._checkpoint_barrier()

    def _run_realtime(self, stream, allowed, *, checkpoint_path=None,
                      checkpoint_every=16, resume=True, checkpoint_job=None
                      ) -> Iterator[WindowResult]:
        # a mutable cell, so the coordinator's closures see the live state
        st = {"store": TrajStateStore(device=self.device), "ts_base": None,
              "consumed": 0}
        if checkpoint_path and resume and os.path.exists(checkpoint_path):
            (st["store"], st["ts_base"],
             st["consumed"]) = self._restore_checkpoint(checkpoint_path,
                                                        job=checkpoint_job)
        self._register_ckpt_tstats(st)
        n_batches = 0
        for _, _, records in self._windows(stream):
            batch = _rows(records)
            st["consumed"] += len(batch)
            for rows in self._split_by_span(batch):
                if allowed:
                    rows = rows.take(_with_ids(rows, allowed))
                if not len(rows):
                    continue
                ts = _ts(rows)
                if st["ts_base"] is None:
                    st["ts_base"] = int(ts[0])
                elif int(ts[0]) != st["ts_base"]:
                    st["store"].rebase_ts(int(ts[0]) - st["ts_base"])
                    st["ts_base"] = int(ts[0])
                oid, sp, tm, speed = self._update(st["store"], rows,
                                                  st["ts_base"])
                n_batches += 1
                if checkpoint_path and \
                        n_batches % max(1, checkpoint_every) == 0:
                    self._save_checkpoint(st, checkpoint_path,
                                          job=checkpoint_job)
                tuples = self._tuples(oid, sp, tm, speed)
                if tuples:
                    yield WindowResult(int(ts[0]), int(ts[-1]), tuples)
            self._checkpoint_barrier()
        if checkpoint_path and n_batches:
            self._save_checkpoint(st, checkpoint_path, job=checkpoint_job)

    def _state_meta(self, st: dict) -> dict:
        return {"capacity": st["store"].capacity, "ts_base": st["ts_base"],
                "consumed": st["consumed"],
                "interner": self.interner.to_list()}

    def _adopt_state(self, cp: CheckpointableState, meta: dict, st: dict
                     ) -> None:
        """Apply a saved state: the store in fresh tensors on the
        operator's device, and the interner its ids index."""
        cp.meta["capacity"] = int(meta["capacity"])
        st["store"] = TrajStateStore.restore(cp, self.device)
        st["ts_base"] = (None if meta.get("ts_base") is None
                         else int(meta["ts_base"]))
        st["consumed"] = int(meta.get("consumed", 0))
        self.interner = IdInterner.from_list(meta["interner"])
        self._id_maps = {}

    def _register_ckpt_tstats(self, st: dict) -> None:
        """The coordinator's ``tstats`` participant: the carried state's
        arrays and its capacity / ts_base / consumed / interner meta (the
        legacy file's payload)."""
        coord = self._ckpt
        if coord is None:
            return

        def restore(arrays, meta):
            cp = CheckpointableState()
            cp.arrays.update(arrays)
            self._adopt_state(cp, meta, st)

        coord.register("tstats", lambda: (st["store"].snapshot().arrays,
                                          self._state_meta(st)), restore)

    def _save_checkpoint(self, st: dict, path: str,
                         job: Optional[str] = None) -> None:
        """The legacy ``--checkpoint`` file: the state, ``ts_base``, the
        interner, the records consumed (a file replay skips them on
        resume) and the job fingerprint."""
        cp = st["store"].snapshot()
        cp.meta.update(self._state_meta(st))
        cp.meta["ts_base"] = int(st["ts_base"])
        if job:
            cp.meta["job"] = job
        cp.save(path)

    def _restore_checkpoint(self, path: str, job: Optional[str] = None):
        from spatialflink_tpu_torch.runtime.checkpoint import (
            check_job_fingerprint)

        cp = CheckpointableState.load(path)
        check_job_fingerprint(cp.meta.get("job"), job, path)
        st: dict = {}
        self._adopt_state(cp, cp.meta, st)
        return st["store"], st["ts_base"], st["consumed"]

    def _split_by_span(self, rows: PointRows) -> Iterator[PointRows]:
        """The micro-batch cut where an event time lies more than
        :data:`_SPAN_HORIZON_MS` from the first of its piece."""
        ts = _ts(rows)
        lo, n = 0, ts.shape[0]
        while lo < n:
            far = np.nonzero(np.abs(ts[lo:] - ts[lo])
                             > self._SPAN_HORIZON_MS)[0]
            hi = lo + int(far[0]) if far.size else n
            yield rows if (lo, hi) == (0, n) else rows.take(
                np.arange(lo, hi))
            lo = hi

    def _update(self, store: TrajStateStore, rows: PointRows, ts_base: int):
        """One K8a call: the emitted points' (operator id, spatial,
        temporal, speed), in sorted (object, ts) order."""
        batch = self._point_batch(rows, ts_base)
        store.ensure(len(self.interner))
        store.state, out = T.tstats_update(
            store.state, batch,
            ts_range=PointBatch.ts_range(_ts(rows), ts_base))
        emit, oid, sp, tm, speed = _to_host(out.emit, out.obj_id, out.spatial,
                                            out.temporal, out.speed)
        return oid[emit], sp[emit], tm[emit], speed[emit]

    def _tuples(self, oid, sp, tm, speed) -> List[Tuple]:
        lookup = self.interner.lookup
        return [(lookup(o), s, int(round(t)), v) for o, s, t, v in
                zip(oid.tolist(), sp.tolist(), tm.tolist(), speed.tolist())]

    def _window_tuples(self, rows: PointRows, start: int) -> List[Tuple]:
        """A window from fresh state: each trajectory's last emitted tuple
        (its totals), in ascending interned id."""
        if not len(rows):
            return []
        oid, sp, tm, speed = self._update(TrajStateStore(device=self.device),
                                          rows, start)
        last = np.r_[oid[1:] != oid[:-1], True] if oid.size else oid.astype(
            bool)
        return self._tuples(oid[last], sp[last], tm[last], speed[last])

    def _run_windowed_panes(self, stream, allowed) -> Iterator[WindowResult]:
        """``--panes``: one K8b launch per sealed pane (per-trajectory pair
        sums, counts, ts extents, boundary points; extents rebased to
        absolute ms), and per window the stitch of its panes' tables in
        time order (:func:`ops.trajectory.tstats_stitch_host`); emission
        in ascending interned id, count >= 2."""
        i64 = np.int64

        def pane_partial(prows, pstart) -> Optional[dict]:
            if allowed:
                prows = prows.take(_with_ids(prows, allowed))
            if not len(prows):
                return None
            batch = self._point_batch(prows, pstart)
            s = T.tstats_window_summary(
                batch, m=bucket_size(len(self.interner)),
                ts_range=PointBatch.ts_range(_ts(prows), pstart))
            host = dict(zip(s._fields, _to_host(*s)))
            cnt = host["count"].astype(i64)
            present = cnt > 0
            host["count"] = cnt
            host["min_ts"] = np.where(
                present, host["min_ts"].astype(i64) + pstart,
                np.iinfo(i64).max)
            host["max_ts"] = np.where(
                present, host["max_ts"].astype(i64) + pstart,
                np.iinfo(i64).min)
            return host

        for start, end, panes in self._pane_stream(stream):
            parts = []
            for pstart, prows in panes:
                part = self.pane_cache.get(
                    pstart, lambda: pane_partial(prows, pstart))
                if part is not None:
                    parts.append(part)
            self.pane_cache.evict_before(start)
            tuples: List[Tuple] = []
            if parts:
                sp, tm, cnt = T.tstats_stitch_host(parts)
                for o in np.nonzero(cnt >= 2)[0]:
                    t, s = float(tm[o]), float(sp[o])
                    tuples.append((self.interner.lookup(int(o)), s,
                                   int(round(t)), s / t if t > 0 else 0.0))
            yield WindowResult(start, end, tuples)
            self._checkpoint_barrier()


class PointTAggregateQuery(_TrajOperator):
    """Per-cell heatmap of trajectory lengths (max - min timestamp of each
    (cell, objID) group). ``aggregate`` in {SUM, AVG, MIN, MAX, COUNT,
    ALL}: ALL emits the groups as (cell, objID, length) records, the others
    a (num_cells,) heatmap in ``extras["heatmap"]``. Realtime mode merges
    group extents into host state with stale-trajectory eviction after
    ``traj_deletion_threshold_ms``; CountBased mode runs per-cell count
    windows (``TAggregateQuery.java:381-494``)."""
    telemetry_label = "taggregate"

    def run(self, stream: Iterable, aggregate: str = "SUM",
            traj_deletion_threshold_ms: int = 0, *,
            checkpoint_path: Optional[str] = None,
            checkpoint_every: int = 16, resume: bool = True,
            checkpoint_job: Optional[str] = None
            ) -> Iterator[WindowResult]:
        """``checkpoint_path`` (realtime): the legacy single-file
        checkpoint of the extent rows, as :meth:`PointTStatsQuery.run`."""
        agg = aggregate.upper()
        if self.realtime:
            yield from self._run_realtime(
                stream, agg, traj_deletion_threshold_ms,
                checkpoint_path=checkpoint_path,
                checkpoint_every=checkpoint_every, resume=resume,
                checkpoint_job=checkpoint_job)
            return
        if self.conf.query_type is QueryType.CountBased:
            yield from self._run_count_windows(stream, agg)
            return
        if self._panes_active():
            yield from self._run_windowed_panes(stream, agg)
            return
        cells = self.grid.num_cells
        for start, end, records in self._windows(stream):
            rows = _rows(records)
            batch = self._point_batch(rows, start)
            groups = T.taggregate_groups(batch, num_cells=cells,
                                         num_ids=len(self.interner))
            if agg == "ALL":
                first, cell, oid, length = _to_host(
                    groups.first, groups.cell, groups.obj_id, groups.length)
                lookup = self.interner.lookup
                yield WindowResult(start, end, list(zip(
                    cell[first].tolist(),
                    [lookup(o) for o in oid[first].tolist()],
                    length[first].tolist())))
            else:
                hm = T.taggregate_heatmap(groups, num_cells=cells, agg=agg)
                yield WindowResult(start, end, [],
                                   extras={"heatmap": hm.cpu().numpy()})
            self._checkpoint_barrier()

    def _run_windowed_panes(self, stream, agg: str) -> Iterator[WindowResult]:
        """``--panes``: one K8c launch per sealed pane, read back as (cell,
        objID, min_ts, max_ts) rows in absolute ms; a window merges its
        panes' rows (a group split across panes merges its extent before
        its length is taken) and derives the heatmap or ALL records."""
        if agg not in ("ALL", "SUM", "AVG", "MIN", "MAX", "COUNT"):
            raise ValueError(f"unknown aggregate {agg!r}")

        def pane_partial(prows, pstart):
            batch = self._point_batch(prows, pstart)
            e = T.taggregate_group_extents(batch,
                                           num_cells=self.grid.num_cells,
                                           num_ids=len(self.interner))
            first, cell, oid, mn, mx = _to_host(e.first, e.cell, e.obj_id,
                                                e.min_ts, e.max_ts)
            return (cell[first], oid[first],
                    mn[first].astype(np.int64) + pstart,
                    mx[first].astype(np.int64) + pstart)

        for start, end, panes in self._pane_stream(stream):
            parts = [self.pane_cache.get(pstart,
                                         lambda: pane_partial(prows, pstart))
                     for pstart, prows in panes]
            self.pane_cache.evict_before(start)
            merged = T.taggregate_merge_extents_host(parts)
            if agg == "ALL":
                yield WindowResult(start, end, [
                    (c, self.interner.lookup(int(o)), int(mx - mn))
                    for (c, o), (mn, mx) in sorted(merged.items())])
            else:
                yield WindowResult(start, end, [], extras={
                    "heatmap": self._heatmap_from_groups(merged, agg)})
            self._checkpoint_barrier()

    def _heatmap_from_groups(self, merged: Dict, agg: str) -> np.ndarray:
        """(num_cells,) f32 heatmap from merged (cell, objID) -> extent
        groups: the host mirror of K8d over pane-merged groups."""
        num_cells = self.grid.num_cells
        hm = np.zeros(num_cells, np.float32)
        if not merged:
            return hm
        cells = np.fromiter((k[0] for k in merged), np.int64, len(merged))
        lengths = np.fromiter((mx - mn for mn, mx in merged.values()),
                              np.float64, len(merged))
        if agg in ("AVG", "COUNT"):
            counts = np.zeros(num_cells, np.int64)
            np.add.at(counts, cells, 1)
        if agg in ("SUM", "AVG"):
            acc = np.zeros(num_cells, np.float64)
            np.add.at(acc, cells, lengths)
            if agg == "AVG":
                acc = np.where(counts > 0, acc / np.maximum(counts, 1), 0.0)
            hm = acc.astype(np.float32)
        elif agg == "COUNT":
            hm = counts.astype(np.float32)
        elif agg == "MIN":
            acc = np.full(num_cells, np.inf)
            np.minimum.at(acc, cells, lengths)
            hm = np.where(np.isfinite(acc), acc, 0.0).astype(np.float32)
        elif agg == "MAX":
            acc = np.full(num_cells, -np.inf)
            np.maximum.at(acc, cells, lengths)
            hm = np.where(np.isfinite(acc), acc, 0.0).astype(np.float32)
        else:
            raise ValueError(f"unknown aggregate {agg!r}")
        return hm

    def _points(self, stream) -> Iterator[Point]:
        """The stream's records as Point objects, in arrival order."""
        for chunk in _record_chunks(stream, self.grid):
            rows = chunk.view([(chunk, np.arange(len(chunk)))])
            yield from _rows(rows)

    def _run_count_windows(self, stream, agg) -> Iterator[WindowResult]:
        """Per-cell sliding COUNT windows (Flink ``countWindow(size,
        slide)``): keyed by cell, every ``slide`` arrivals in a cell
        evaluate its last ``size`` points; ``window_size_ms`` / ``slide_ms``
        are counts here."""
        size = max(1, int(self.conf.window_size_ms))
        slide = max(1, int(self.conf.slide_ms))
        buffers: Dict[int, deque] = {}
        arrivals: Dict[int, int] = {}
        for p in self._points(stream):
            if p.cell < 0:
                continue  # the reference filters null-gridID points first
            buf = buffers.setdefault(p.cell, deque(maxlen=size))
            buf.append(p)
            arrivals[p.cell] = arrivals.get(p.cell, 0) + 1
            if arrivals[p.cell] % slide == 0:
                result = self._count_window_result(p.cell, list(buf), agg)
                # SUM/AVG need a sum > 0 and MIN/MAX a re-sighted object;
                # the reference collects nothing otherwise
                if result.records:
                    yield result

    @staticmethod
    def _count_window_result(cell: int, pts: List[Point], agg: str
                             ) -> WindowResult:
        # MIN/MAX replicate CountWindowProcessFunction's per-point tracker
        # scan (TAggregateQuery.java:438-494): a length updates the
        # trackers only when an object is re-sighted
        extents: Dict[str, Tuple[int, int]] = {}
        min_len = min_oid = max_len = max_oid = None
        for p in pts:
            if p.obj_id in extents:
                mn, mx = extents[p.obj_id]
                mn, mx = min(mn, p.timestamp), max(mx, p.timestamp)
                extents[p.obj_id] = (mn, mx)
                length = mx - mn
                if max_len is None or length > max_len:
                    max_len, max_oid = length, p.obj_id
                if min_len is None or length < min_len:
                    min_len, min_oid = length, p.obj_id
            else:
                extents[p.obj_id] = (p.timestamp, p.timestamp)
        lengths = {oid: mx - mn for oid, (mn, mx) in extents.items()}
        n_objs = len(lengths)
        start = min(p.timestamp for p in pts)
        end = max(p.timestamp for p in pts)
        extras = {"cell": cell, "num_objects": n_objs, "aggregate": agg}
        if agg == "ALL":
            records = [(cell, lengths)]
        elif agg == "SUM":
            s = sum(lengths.values())
            records = [(cell, s)] if s > 0 else []
        elif agg == "AVG":
            s = sum(lengths.values())
            records = [(cell, round(s / n_objs))] if s > 0 else []
        elif agg == "MIN":
            records = [(cell, min_oid, min_len)] if min_len is not None else []
        elif agg == "MAX":
            records = [(cell, max_oid, max_len)] if max_len is not None else []
        elif agg == "COUNT":
            records = [(cell, n_objs)]
        else:
            records = [(cell, lengths)]
        return WindowResult(start, end, records, extras)

    def _run_realtime(self, stream, agg, eviction_ms, *,
                      checkpoint_path=None, checkpoint_every=16,
                      resume=True, checkpoint_job=None
                      ) -> Iterator[WindowResult]:
        """Host state (cell, objID) -> [min_ts, max_ts, last_seen] in the
        array-backed :class:`_ExtentStore`, updated per micro-batch, stale
        rows evicted after ``eviction_ms``; each micro-batch emits the
        heatmap over the live rows (ALL served as per-cell SUM, flagged).
        ``checkpoint_path`` saves the rows and the records consumed every
        ``checkpoint_every`` micro-batches and at the end."""
        st = {"store": _ExtentStore(), "consumed": 0}
        if checkpoint_path and resume and os.path.exists(checkpoint_path):
            st["store"], st["consumed"] = self._restore_checkpoint(
                checkpoint_path, job=checkpoint_job)
        self._register_ckpt_taggregate(st)
        n_batches = 0
        for start, end, records in self._windows(stream):
            rows = _rows(records)
            st["consumed"] += len(rows)
            n_batches += 1
            latest = st["store"].update_batch(rows)
            if eviction_ms > 0:
                st["store"].evict(latest, eviction_ms)
            if checkpoint_path and n_batches % max(1, checkpoint_every) == 0:
                self._save_checkpoint(st, checkpoint_path, checkpoint_job)
            extras = {"heatmap": st["store"].aggregate(agg,
                                                       self.grid.num_cells),
                      "aggregate": agg}
            if agg == "ALL":
                extras["heatmap_semantics"] = "SUM"
            yield WindowResult(start, end, [], extras=extras)
            self._checkpoint_barrier()
        if checkpoint_path and n_batches:
            self._save_checkpoint(st, checkpoint_path, checkpoint_job)

    def _register_ckpt_taggregate(self, st: dict) -> None:
        """The coordinator's ``taggregate`` participant: the live extent
        rows (the legacy file's payload)."""
        coord = self._ckpt
        if coord is None:
            return

        def snap():
            cells, oids, extents = st["store"].rows()
            return ({"cell": cells, "extent": extents},
                    {"obj_id": oids, "consumed": st["consumed"]})

        def restore(arrays, meta):
            st["store"] = _ExtentStore.from_rows(
                arrays.get("cell", np.empty(0, np.int64)),
                meta.get("obj_id", []),
                arrays.get("extent", np.empty((0, 3), np.int64)))
            st["consumed"] = int(meta.get("consumed", 0))

        coord.register("taggregate", snap, restore)

    @staticmethod
    def _save_checkpoint(st: dict, path: str,
                         job: Optional[str] = None) -> None:
        cells, oids, extents = st["store"].rows()
        cp = CheckpointableState()
        cp.arrays["cell"] = cells
        cp.arrays["extent"] = extents
        cp.meta["obj_id"] = oids
        cp.meta["consumed"] = int(st["consumed"])
        if job:
            cp.meta["job"] = job
        cp.save(path)

    @staticmethod
    def _restore_checkpoint(path: str, job: Optional[str] = None):
        from spatialflink_tpu_torch.runtime.checkpoint import (
            check_job_fingerprint)

        cp = CheckpointableState.load(path)
        check_job_fingerprint(cp.meta.get("job"), job, path)
        store = _ExtentStore.from_rows(
            cp.arrays.get("cell", np.empty(0, np.int64)),
            cp.meta.get("obj_id", []),
            cp.arrays.get("extent", np.empty((0, 3), np.int64)))
        return store, int(cp.meta.get("consumed", 0))


class _ExtentStore:
    """Array-backed (cell, objID) -> [min_ts, max_ts, last_seen] extent map
    of the realtime tAggregate state (the JAX package's): rows allocated
    per new key, min/max/seen merged with vectorized scatters, evicted rows
    tombstoned and compacted once dead rows exceed half the store."""

    _I64_MAX = np.iinfo(np.int64).max
    _I64_MIN = np.iinfo(np.int64).min

    def __init__(self, capacity: int = 1024):
        self.index: Dict[Tuple[int, str], int] = {}
        self.keys: List[Tuple[int, str]] = []
        self.cells = np.zeros(capacity, np.int64)
        self.ext = np.zeros((capacity, 3), np.int64)
        self.alive = np.zeros(capacity, bool)
        self.n = 0

    def _ensure(self, need: int) -> None:
        cap = self.cells.shape[0]
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        grow = cap - self.cells.shape[0]
        self.cells = np.concatenate([self.cells, np.zeros(grow, np.int64)])
        self.ext = np.concatenate([self.ext, np.zeros((grow, 3), np.int64)])
        self.alive = np.concatenate([self.alive, np.zeros(grow, bool)])

    def update_batch(self, rows: PointRows) -> int:
        """Merge one micro-batch; returns its latest in-grid timestamp (0
        when it has none)."""
        _, _, ts_all, oid_all, cell_all, _ = rows.columns()
        keep = cell_all >= 0
        ts = ts_all[keep]
        cells = cell_all[keep].tolist()
        lookup = rows.interner.lookup
        r_of = np.empty(ts.shape[0], np.int64)
        for j, (c, o) in enumerate(zip(cells, oid_all[keep].tolist())):
            key = (c, lookup(o))
            r = self.index.get(key)
            if r is None:
                r = self.n
                self._ensure(r + 1)
                self.index[key] = r
                self.keys.append(key)
                self.cells[r] = c
                self.ext[r] = (self._I64_MAX, self._I64_MIN, self._I64_MIN)
                self.alive[r] = True
                self.n += 1
            r_of[j] = r
        np.minimum.at(self.ext[:, 0], r_of, ts)
        np.maximum.at(self.ext[:, 1], r_of, ts)
        np.maximum.at(self.ext[:, 2], r_of, ts)
        return max(0, int(ts.max())) if ts.size else 0

    def evict(self, latest: int, eviction_ms: int) -> None:
        """Tombstone rows unseen for eviction_ms (deleteHaltedTrajectories,
        ``TAggregateQuery.java:367-376``); compact when mostly dead."""
        live = self.alive[: self.n]
        stale = live & (latest - self.ext[: self.n, 2] > eviction_ms)
        if not stale.any():
            return
        for r in np.nonzero(stale)[0]:
            del self.index[self.keys[r]]
        self.alive[: self.n] &= ~stale
        if self.n and self.alive[: self.n].sum() < self.n // 2:
            self._compact()

    def _compact(self) -> None:
        keep = np.nonzero(self.alive[: self.n])[0]
        self.cells[: keep.size] = self.cells[keep]
        self.ext[: keep.size] = self.ext[keep]
        self.keys = [self.keys[r] for r in keep]
        self.alive[:] = False
        self.alive[: keep.size] = True
        self.n = keep.size
        self.index = {k: i for i, k in enumerate(self.keys)}

    def rows(self):
        """(cells, obj_ids, extents) of the live rows: the checkpoint
        payload."""
        live = np.nonzero(self.alive[: self.n])[0]
        return (self.cells[live].copy(), [self.keys[r][1] for r in live],
                self.ext[live].copy())

    @classmethod
    def from_rows(cls, cells, oids, extents) -> "_ExtentStore":
        store = cls(capacity=max(1024, len(oids)))
        for c, o, e in zip(cells, oids, extents):
            key = (int(c), str(o))
            r = store.n
            store.index[key] = r
            store.keys.append(key)
            store.cells[r] = int(c)
            store.ext[r] = (int(e[0]), int(e[1]), int(e[2]))
            store.alive[r] = True
            store.n += 1
        return store

    def aggregate(self, agg: str, num_cells: int) -> np.ndarray:
        """Per-cell heatmap (f64) over the live rows."""
        live = np.nonzero(self.alive[: self.n])[0]
        cells = self.cells[live]
        lengths = (self.ext[live, 1] - self.ext[live, 0]).astype(np.float64)
        hm = np.zeros(num_cells, np.float64)
        if agg in ("AVG", "COUNT"):
            counts = np.zeros(num_cells, np.int64)
            np.add.at(counts, cells, 1)
        if agg in ("SUM", "AVG"):
            np.add.at(hm, cells, lengths)
            if agg == "AVG":
                hm = np.where(counts > 0, hm / np.maximum(counts, 1), 0.0)
        elif agg == "MIN":
            hm[:] = np.inf
            np.minimum.at(hm, cells, lengths)
        elif agg == "MAX":
            hm[:] = -np.inf
            np.maximum.at(hm, cells, lengths)
        elif agg == "COUNT":
            hm = counts.astype(np.float64)
        else:  # ALL behaves like SUM for the heatmap form
            np.add.at(hm, cells, lengths)
        hm[~np.isfinite(hm)] = 0.0
        return hm


class _CapturingJoin(PointPointJoinQuery):
    """The point join of tJoin: windowed, each result keeps its window's
    two sides' records (the trajectories the pairs join back to)."""

    windowed = False

    def _join_window(self, start, end, recs_a, recs_b, radius, *,
                     max_dt=None) -> WindowResult:
        res = super()._join_window(start, end, recs_a, recs_b, radius,
                                   max_dt=max_dt)
        if self.windowed:
            res.extras["_recs_a"] = recs_a
            res.extras["_recs_b"] = recs_b
        return res


def _drop_self_pairs(pairs: PairRecords) -> PairRecords:
    """``pairs`` without the pairs whose two records carry the same object
    id (the two sides intern ids apart: they compare as strings)."""
    parts = []
    for recs_a, recs_b, ai, bi in pairs._parts:
        names = []
        for recs, idx in ((recs_a, ai), (recs_b, bi)):
            ids, inv = np.unique(recs.columns()[3][idx], return_inverse=True)
            look = recs.interner.lookup
            names.append(np.array([look(int(o)) for o in ids],
                                  dtype=object)[inv.reshape(-1)])
        keep = names[0] != names[1]
        parts.append((recs_a, recs_b, ai[keep], bi[keep]))
    return PairRecords(parts)


class PointPointTJoinQuery(_TrajOperator):
    """Trajectory x trajectory proximity join: one output per (trajectory,
    partner) pair per window, keeping the pair with the LATEST co-located
    timestamp (``tJoin/PointPointTJoinQuery.java:133-177``). Windowed mode
    emits sub-trajectory LineString pairs over the window's records, only
    where both trajectories have >= 2 points in the window
    (``TJoinQuery.java:184``); realtime mode emits point pairs. Count
    windows are refused, as for the point join."""
    telemetry_label = "tjoin"

    def __init__(self, conf, grid, grid2=None, *, device="cuda"):
        if conf.query_type is QueryType.CountBased:
            raise NotImplementedError(
                "CountBased queries are not yet supported")
        super().__init__(conf, grid, device=device)
        self.grid2 = grid2 or grid

    def _inner(self, prune_cells: bool = True) -> _CapturingJoin:
        inner = _CapturingJoin(self.conf, self.grid, self.grid2,
                               device=self.device)
        inner.windowed = not self.realtime
        inner.prune_cells = prune_cells
        return inner

    def run(self, ordinary: Iterable, query_stream: Iterable,
            radius: float) -> Iterator[WindowResult]:
        inner = self._inner()
        for res in inner.run(ordinary, query_stream, radius):
            yield self._post(res, inner.windowed)

    def run_naive(self, ordinary: Iterable, query_stream: Iterable,
                  radius: float) -> Iterator[WindowResult]:
        """All-pairs twin without cell pruning (``tJoin/TJoinQuery.java:
        61-155``); the exact distance filter still applies."""
        inner = self._inner(prune_cells=False)
        for res in inner.run(ordinary, query_stream, radius):
            yield self._post(res, inner.windowed)

    def run_single(self, stream: Iterable, radius: float
                   ) -> Iterator[WindowResult]:
        """The self-join (``tJoin/PointPointTJoinQuery.java:341-435``): the
        stream joined with itself, each window's pairs of one object with
        itself dropped before the dedup."""
        records = list(stream)
        inner = self._inner()
        for res in inner.run(iter(records), iter(list(records)), radius):
            res.records = _drop_self_pairs(res.records)
            yield self._post(res, inner.windowed)

    def _post(self, res: WindowResult, windowed: bool) -> WindowResult:
        res = self._dedup(res)
        if windowed:
            res = self._to_trajectory_pairs(res)
        return res

    @staticmethod
    def _pair_columns(pairs: PairRecords):
        """Each pair's two records as (rows_a, rows_b) of equal length."""
        sides = ([], [])
        interners = [None, None]
        for recs_a, recs_b, ai, bi in pairs._parts:
            for s, (recs, idx) in enumerate(((recs_a, ai), (recs_b, bi))):
                cols = recs.columns()
                sides[s].append(tuple(a[idx] for a in cols))
                interners[s] = recs.interner
        return tuple(PointRows(tuple(np.concatenate([c[i] for c in cols])
                                     for i in range(6)), interners[s])
                     for s, cols in enumerate(sides))

    @classmethod
    def _dedup(cls, res: WindowResult) -> WindowResult:
        """One pair per (objID, partner objID): the first pair of the
        latest max(ta, tb), in order of the key's first pair."""
        pairs = res.records
        if not len(pairs):
            return WindowResult(res.window_start, res.window_end,
                                PairRecords(), res.extras)
        ra, rb = cls._pair_columns(pairs)
        ta, oa = ra.columns()[2], ra.columns()[3].astype(np.int64)
        tb, ob = rb.columns()[2], rb.columns()[3].astype(np.int64)
        key = oa * (int(ob.max()) + 1) + ob
        latest = np.maximum(ta, tb)
        pos = np.arange(key.shape[0])
        # per key: the latest max(ta, tb), its first pair on ties
        order = np.lexsort((pos, -latest, key))
        ks = key[order]
        head = np.r_[True, ks[1:] != ks[:-1]]
        best = order[head]
        first_pos = np.minimum.reduceat(pos[np.argsort(key, kind="stable")],
                                        np.flatnonzero(head))
        keep = best[np.argsort(first_pos, kind="stable")]
        out = PairRecords([(ra, rb, keep, keep)])
        return WindowResult(res.window_start, res.window_end, out,
                            res.extras)

    @staticmethod
    def _to_trajectory_pairs(res: WindowResult) -> WindowResult:
        """Deduped point pairs -> (LineString, LineString) sub-trajectory
        pairs over the window's full per-side records; a pair whose side
        has fewer than 2 window points is dropped."""
        recs_a = res.extras.pop("_recs_a", None)
        recs_b = res.extras.pop("_recs_b", None)
        out = []
        if len(res.records):
            ra, rb = PointPointTJoinQuery._pair_columns(res.records)
            subs = []
            for recs, side in ((recs_a, ra), (recs_b, rb)):
                rows = _rows(recs)
                ids = {side.interner.lookup(int(o))
                       for o in np.unique(side.columns()[3])}
                subs.append(assemble_subtrajectories(
                    rows.take(_with_ids(rows, ids))))
            la_of = ra.interner.lookup
            lb_of = rb.interner.lookup
            for oa, ob in zip(ra.columns()[3].tolist(),
                              rb.columns()[3].tolist()):
                la = subs[0].get(la_of(oa))
                lb = subs[1].get(lb_of(ob))
                if isinstance(la, LineString) and isinstance(lb, LineString):
                    out.append((la, lb))
        return WindowResult(res.window_start, res.window_end, out,
                            res.extras)


class PointPointTKNNQuery(_TrajOperator):
    """The k nearest *trajectories* to a query point within ``radius``
    (exact radius enforced, unlike plain kNN: K2's radius filter): each
    window's (objID, min distance, sub-trajectory) triples."""
    telemetry_label = "tknn"

    def run(self, stream: Iterable, query_point: Point, radius: float,
            k: Optional[int] = None) -> Iterator[WindowResult]:
        yield from self._run(stream, query_point, radius, k, prune=True)

    def run_naive(self, stream: Iterable, query_point: Point, radius: float,
                  k: Optional[int] = None) -> Iterator[WindowResult]:
        """Exhaustive twin (``tKnn/PointPointTKNNQuery.java:59-78``): no
        cell pruning."""
        yield from self._run(stream, query_point, radius, k, prune=False)

    def _run(self, stream, query_point, radius, k, prune
             ) -> Iterator[WindowResult]:
        k = k or self.conf.k
        nb_layers = (self.grid.candidate_layers(radius)
                     if (prune and radius > 0) else self.grid.n)

        def eval_batch(records, ts_base):
            rows = _rows(records)
            if not len(rows):
                return []
            batch = self._point_batch(rows, ts_base)
            res = K.knn_point(batch, query_point.x, query_point.y,
                              query_point.cell, radius, nb_layers,
                              n=self.grid.n, k=k,
                              enforce_radius=radius > 0,
                              num_ids=len(self.interner))
            valid, oid, dist = _to_host(res.valid, res.obj_id, res.dist)
            oids = [self.interner.lookup(o) for o in oid[valid].tolist()]
            subs = self._subs(rows, set(oids))
            return [(o, d, subs.get(o))
                    for o, d in zip(oids, dist[valid].tolist())]

        for result in self._drive(stream, eval_batch):
            result.extras["k"] = k
            yield result

    @staticmethod
    def _subs(rows: PointRows, ids: Set[str]) -> Dict[str, object]:
        return assemble_subtrajectories(rows.take(_with_ids(rows, ids)))

    def run_multi(self, stream: Iterable, query_points, radius: float,
                  k: Optional[int] = None) -> Iterator[WindowResult]:
        """Q query points, each answered with its k nearest trajectories, in
        one K2 launch per window; sub-trajectories are assembled once for
        the union of the queries' selections."""
        k = k or self.conf.k
        qx, qy, qc = self._query_point_arrays(query_points, self.device)
        nb_layers = (self.grid.candidate_layers(radius) if radius > 0
                     else self.grid.n)
        n_q = len(query_points)

        def eval_batch(records, ts_base):
            rows = _rows(records)
            if not len(rows):
                return [[] for _ in range(n_q)]
            batch = self._point_batch(rows, ts_base)
            res, _ = K.knn_point_multi_stats(
                batch, qx, qy, qc, nb_layers, n=self.grid.n, k=k,
                num_ids=len(self.interner),
                radius=radius if radius > 0 else None)
            valid, oid, dist = _to_host(res.valid, res.obj_id, res.dist)
            per_q = []
            union: Set[str] = set()
            for q in range(n_q):
                oids = [self.interner.lookup(o)
                        for o in oid[q][valid[q]].tolist()]
                per_q.append((oids, dist[q][valid[q]].tolist()))
                union.update(oids)
            subs = self._subs(rows, union)
            return [[(o, d, subs.get(o)) for o, d in zip(oids, ds)]
                    for oids, ds in per_q]

        for result in self._multi_results(stream, eval_batch):
            result.extras["k"] = k
            result.extras["queries"] = n_q
            yield result


# Reference base-class names
TFilterQuery = PointTFilterQuery
TRangeQuery = PointPolygonTRangeQuery
TStatsQuery = PointTStatsQuery
TAggregateQuery = PointTAggregateQuery
TJoinQuery = PointPointTJoinQuery
TKNNQuery = PointPointTKNNQuery
