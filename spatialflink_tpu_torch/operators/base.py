"""Operator plumbing (port of ``spatialflink_tpu.operators.base`` for the
point stream): query configuration, deferred device results (selection
masks and kNN lists, single- and multi-query), the pipelined driver over
time windows, count windows and realtime micro-batches, the shared
multi-query range driver, and query-side precomputation.

Realtime mode: the reference uses tiny tumbling windows with
fire-per-element triggers; here arrivals are cut into micro-batches of
``realtime_batch_size`` records (``runtime.MicroBatcher``), each evaluated
in one dispatch, and a micro-batch whose selection is empty is not
emitted. Count windows: every ``slide`` arrivals, the last ``size``
records (``runtime.count_windows``); ``window_size_ms``/``slide_ms`` are
then counts.

Not yet ported: panes, the device mesh, checkpointing, the adaptive grid,
the dynamic query registry, and the drive loop's telemetry, latency-plane,
governor and accounting hooks. The JAX package's single-device seams
around the mesh (``_multi_filter_stream``, ``_knn_multi_result``) have no
mesh to route here, so the port calls the per-batch closures directly.
"""

from __future__ import annotations

import dataclasses
import enum
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Iterable, Iterator, List, Tuple

import numpy as np
import torch

from spatialflink_tpu_torch.device import resolve_device
from spatialflink_tpu_torch.index import UniformGrid
from spatialflink_tpu_torch.models import (EdgeGeomBatch, MultiPolygon,
                                            Point, PointBatch, Polygon,
                                            single_query_edges)
from spatialflink_tpu_torch.models.batches import to_device
from spatialflink_tpu_torch.runtime import (MicroBatcher, WindowAssembler,
                                            WindowSpec, count_windows)
from spatialflink_tpu_torch.streams.bulk import (LazyRecords, PointChunk,
                                                 points_to_parsed)
from spatialflink_tpu_torch.utils import IdInterner

NOT_PORTED = "not yet ported to spatialflink_tpu_torch"


class QueryType(enum.Enum):
    RealTime = "realtime"
    WindowBased = "window"
    CountBased = "count"


@dataclass
class QueryConfiguration:
    query_type: QueryType = QueryType.WindowBased
    # record counts, not milliseconds, for CountBased
    window_size_ms: int = 10_000
    slide_ms: int = 5_000
    allowed_lateness_ms: int = 0
    # range queries skip the candidate-cell distance check
    approximate: bool = False
    # windows in flight on the device before the driver waits on the
    # oldest; >= 2 overlaps host batch assembly with device work
    pipeline_depth: int = 2
    # kNN result size when the caller gives none (query.k)
    k: int = 10
    # records per realtime micro-batch (one dispatch each)
    realtime_batch_size: int = 512

    def window_spec(self) -> WindowSpec:
        return WindowSpec.sliding(self.window_size_ms, self.slide_ms)


@dataclass
class WindowResult:
    """One emitted result: the records selected in [start, end) of a time
    window, in [start, end] of a count window (its records' min and max
    event time), or in a realtime micro-batch (start and end are its first
    and last record's event time) — one list per query when
    ``extras["queries"]`` is set (run_multi windows), and (objID,
    distance) pairs for kNN."""

    window_start: int
    window_end: int
    records: List = field(default_factory=list)
    extras: dict = field(default_factory=dict)

    def flat_records(self) -> List:
        """Records flattened across the multi-query axis (the one-record-
        per-line contract of the record sinks)."""
        if "queries" in self.extras:
            return [r for per_query in self.records for r in per_query]
        return self.records


class Deferred:
    """A window's result that has been dispatched to the device but not read
    back. At construction the result tensors are queued for an asynchronous
    copy into pinned host memory on the current stream, and a CUDA event is
    recorded after it; :meth:`finish` waits on that event — the only place
    the host waits for the device — and hands the host arrays to
    ``collect``. CPU results pass straight through."""

    __slots__ = ("device_result", "collect", "_host", "_event")

    def __init__(self, device_result: Tuple[torch.Tensor, ...],
                 collect: Callable[[Tuple[np.ndarray, ...]], List]):
        self.device_result = device_result
        self.collect = collect
        self._event = None
        if device_result[0].device.type == "cuda":
            self._host = tuple(
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                .copy_(t, non_blocking=True) for t in device_result)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = device_result

    def finish(self) -> List:
        if self._event is not None:
            self._event.synchronize()
        return self.collect(tuple(t.numpy() for t in self._host))


def _record_chunks(stream: Iterable, grid: UniformGrid,
                   chunk: int = 4096) -> Iterator:
    """The stream as decoded chunks: a chunked decode stream passes its
    ``.chunks()`` through; a plain iterable of Point records is cut into
    chunks whose cells are assigned on ``grid``."""
    chunks_fn = getattr(stream, "chunks", None)
    if chunks_fn is not None:
        yield from chunks_fn()
        return
    interner = IdInterner()
    buf: List[Point] = []
    for rec in stream:
        buf.append(rec)
        if len(buf) >= chunk:
            yield PointChunk.build(points_to_parsed(buf, interner), grid)
            buf = []
    if buf:
        yield PointChunk.build(points_to_parsed(buf, interner), grid)


class SpatialOperator:
    """Shared driver: turns a record stream into point-window batches on
    ``device`` and pipelines their evaluation."""

    def __init__(self, conf: QueryConfiguration, grid: UniformGrid, *,
                 device="cuda"):
        self.conf = dataclasses.replace(conf)
        self.grid = grid
        self.device = resolve_device(device)
        #: pruning counters summed over the run's windows
        self.pruning = {"gn-bypassed": 0, "distance-computations": 0}

    def _point_batch(self, records: LazyRecords, ts_base: int) -> PointBatch:
        return records.point_batch(ts_base, self.device)[0]

    @property
    def realtime(self) -> bool:
        return self.conf.query_type is QueryType.RealTime

    def _windows(self, stream: Iterable
                 ) -> Iterator[Tuple[int, int, LazyRecords]]:
        """The stream's evaluation units as (start, end, records): realtime
        micro-batches, count windows, or sealed event-time windows."""
        chunks = _record_chunks(stream, self.grid)
        if self.realtime:
            return MicroBatcher(self.conf.realtime_batch_size).batches(chunks)
        if self.conf.query_type is QueryType.CountBased:
            return count_windows(chunks, self.conf.window_size_ms,
                                 self.conf.slide_ms)
        wa = WindowAssembler(self.conf.window_spec(),
                             self.conf.allowed_lateness_ms)
        return wa.assemble(chunks)

    def _filter_stream(self, batch: PointBatch, mask_stats_fn):
        """(mask, gn_bypassed, dist_evals) for one batch on one device."""
        return mask_stats_fn(batch)

    def _defer_with_stats(self, dev, stats, rows) -> Deferred:
        """``stats`` = (gn_bypassed, dist_evals) device counts — scalars, or
        per-query (Q,) rows summed here — ride the same readback as the
        result and bump :attr:`pruning` at collect time; ``rows(host_result)``
        turns the result into records."""
        def collect(host):
            main, gn, evals = host
            self.pruning["gn-bypassed"] += int(gn.sum())
            self.pruning["distance-computations"] += int(evals.sum())
            return rows(main)
        return Deferred((dev, *stats), collect)

    def _defer_mask_select(self, mask, records: LazyRecords,
                           stats) -> Deferred:
        """Deferred selection of ``records`` by a device boolean mask."""
        def rows(m):
            idx = np.nonzero(m)[0]
            return records.take(idx[idx < len(records)])
        return self._defer_with_stats(mask, stats, rows)

    def _defer_knn(self, res, ids, dist_evals) -> Deferred:
        """Deferred (objID, distance) list from a (k,) KnnResult, ids
        resolved through ``ids.lookup`` (the window's interner, or a
        micro-batch's compacted ids). ``dist_evals`` feeds
        the distance-computation counter: kNN has no GN bypass, every
        candidate-cell point costs one distance."""
        def collect(host):
            oid, dist, valid, evals = host
            self.pruning["distance-computations"] += int(evals.sum())
            return _knn_pairs(oid, dist, valid, ids)
        return Deferred((*res, dist_evals), collect)

    def _defer_knn_multi(self, res, ids, dist_evals) -> Deferred:
        """Deferred per-query (objID, distance) lists from a (Q, k)
        KnnResult; ``dist_evals`` (Q,) is summed into the counter."""
        def collect(host):
            oid, dist, valid, evals = host
            self.pruning["distance-computations"] += int(evals.sum())
            return [_knn_pairs(o, d, v, ids)
                    for o, d, v in zip(oid, dist, valid)]
        return Deferred((*res, dist_evals), collect)

    @staticmethod
    def _query_point_arrays(query_points, device: torch.device):
        """(qx (Q,) f32, qy (Q,) f32, q_cell (Q,) int32) tensors on
        ``device`` from a list of query points (built once per run)."""
        return (to_device([q.x for q in query_points], np.float32, device),
                to_device([q.y for q in query_points], np.float32, device),
                to_device([q.cell for q in query_points], np.int32, device))

    def _run_multi_filter(self, stream: Iterable, n_queries: int,
                          multi_mask_stats) -> Iterator[WindowResult]:
        """Shared run_multi driver for the range operators:
        ``multi_mask_stats(batch) -> (masks (Q, N), gn (Q,), evals (Q,))``
        in one dispatch per window; records become Q per-query record
        lists, pruning counters sum over the queries."""
        def eval_batch(records, ts_base):
            if not len(records):
                return [[] for _ in range(n_queries)]
            batch = self._point_batch(records, ts_base)
            masks, gn_c, evals = multi_mask_stats(batch)

            def rows(m):  # ONE (Q, N) device->host transfer
                n = len(records)
                return records.take_many(
                    [idx[idx < n] for idx in (np.nonzero(r)[0] for r in m)])
            return self._defer_with_stats(masks, (gn_c, evals), rows)

        for result in self._multi_results(stream, eval_batch):
            result.extras["queries"] = n_queries
            yield result

    def _drive(self, stream: Iterable, eval_batch
               ) -> Iterator[WindowResult]:
        """The drive loop of every mode: ``eval_batch(records, ts_base)``
        returns a record list or a :class:`Deferred`; deferred results are
        pipelined, up to ``conf.pipeline_depth`` in flight, and emitted in
        order. Every window is reported, selected-or-not; a realtime
        micro-batch only when its selection is not empty."""
        return self._drive_batched(self._windows(stream), eval_batch,
                                   realtime=self.realtime)

    def _multi_results(self, stream: Iterable, eval_batch
                       ) -> Iterator[WindowResult]:
        """:meth:`_drive` for multi-query evaluators, whose result (a list
        of Q per-query lists) is always truthy: in realtime mode a
        micro-batch is dropped when every query's list is empty."""
        for result in self._drive(stream, eval_batch):
            if self.realtime and not any(result.records):
                continue
            yield result

    def _drive_batched(self, batched: Iterable, eval_batch, *,
                       realtime: bool = False) -> Iterator[WindowResult]:
        depth = max(1, self.conf.pipeline_depth)
        pending: deque = deque()  # (start, end, Deferred)

        def emit(start, end, sel) -> Iterator[WindowResult]:
            # realtime mode fires only on a non-empty selection (the
            # reference's fire-per-element trigger never emits empties)
            if sel or not realtime:
                yield WindowResult(start, end, sel)

        def drain(n: int) -> Iterator[WindowResult]:
            while len(pending) > n:
                start, end, dfd = pending.popleft()
                yield from emit(start, end, dfd.finish())

        for start, end, payload in batched:
            sel = eval_batch(payload, start)
            if isinstance(sel, Deferred):
                pending.append((start, end, sel))
                yield from drain(depth - 1)
            else:
                yield from drain(0)  # keep window order
                yield from emit(start, end, sel)
        yield from drain(0)


def _knn_pairs(oid, dist, valid, ids) -> List:
    """The valid slots of one (k,) kNN row as (objID string, distance)."""
    return [(ids.lookup(int(o)), float(d))
            for o, d in zip(oid[valid], dist[valid])]


class GeomQueryMixin:
    """Query-side precomputation: dense GN/CN/NB cell masks (union over the
    query geometry's cells; one row per query for the multi-query paths),
    the padded query edge array, and the Q query geometries as one edge
    batch, on the operator's device."""

    def _query_cells(self, query) -> list:
        if isinstance(query, Point):
            return [query.cell] if query.cell >= 0 else []
        return sorted(query.cells)

    def _query_masks(self, query, radius: float):
        cells = self._query_cells(query)
        gn = self.grid.guaranteed_cells_mask(radius, cells)
        cn = self.grid.candidate_cells_mask(radius, cells, gn)
        return tuple(to_device(m, np.bool_, self.device) for m in (gn, cn))

    def _query_nb(self, query, radius: float):
        """Dense neighbouring-cells (GN ∪ CN) mask of a query; radius 0
        selects every cell."""
        return to_device(self.grid.neighboring_cells_mask(
            radius, self._query_cells(query)), np.bool_, self.device)

    def _stack_query_masks(self, queries, radius: float):
        """(Q, n*n) GN and CN mask stacks, one row per query (the
        multi-query form of :meth:`_query_masks`)."""
        gn, cn = [], []
        for q in queries:
            cells = self._query_cells(q)
            gn.append(self.grid.guaranteed_cells_mask(radius, cells))
            cn.append(self.grid.candidate_cells_mask(radius, cells, gn[-1]))
        return tuple(to_device(np.stack(m), np.bool_, self.device)
                     for m in (gn, cn))

    def _stack_query_nb(self, queries, radius: float):
        """(Q, n*n) neighbouring-cells masks, one row per query (the
        multi-query form of :meth:`_query_nb`)."""
        return to_device(np.stack([self.grid.neighboring_cells_mask(
            radius, self._query_cells(q)) for q in queries]), np.bool_,
            self.device)

    def _query_geom_batch(self, queries) -> EdgeGeomBatch:
        """The Q query geometries as ONE exact-capacity padded edge batch
        (no bucket padding on the query axis: it must match the (Q,)
        mask stacks)."""
        return EdgeGeomBatch.from_objects(queries, device=self.device,
                                          pad=len(queries))

    def _query_pip(self, query):
        """ONE query geometry prepared for K4 once per run: its padded
        edges and its per-cell edge table over the operator's grid
        (``hopper_kernels.pip_table``)."""
        from spatialflink_tpu_torch.ops import hopper_kernels as HK

        e, m = single_query_edges(query)
        return HK.pip_table(to_device(e, np.float32, self.device),
                            to_device(m, np.bool_, self.device),
                            isinstance(query, (Polygon, MultiPolygon)),
                            grid=self.grid)

    def _query_bbox(self, query):
        return to_device(np.asarray(query.bbox, np.float32), np.float32,
                         self.device)
