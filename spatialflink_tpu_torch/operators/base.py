"""Operator plumbing (port of the windowed path of
``spatialflink_tpu.operators.base``): query configuration, deferred device
results, the pipelined window driver, and query-side precomputation.

Not yet ported: realtime and count windows, panes, the device mesh,
checkpointing, the adaptive grid, and the drive loop's telemetry, latency,
governor and accounting hooks.
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
from spatialflink_tpu_torch.models import (MultiPolygon, Point, PointBatch,
                                            Polygon, single_query_edges)
from spatialflink_tpu_torch.models.batches import to_device
from spatialflink_tpu_torch.runtime import WindowAssembler, WindowSpec
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
    window_size_ms: int = 10_000
    slide_ms: int = 5_000
    allowed_lateness_ms: int = 0
    # range queries skip the candidate-cell distance check
    approximate: bool = False
    # windows in flight on the device before the driver waits on the
    # oldest; >= 2 overlaps host batch assembly with device work
    pipeline_depth: int = 2

    def window_spec(self) -> WindowSpec:
        return WindowSpec.sliding(self.window_size_ms, self.slide_ms)


@dataclass
class WindowResult:
    """One emitted result: the records selected in [start, end)."""

    window_start: int
    window_end: int
    records: List = field(default_factory=list)


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
        if conf.query_type is not QueryType.WindowBased:
            raise NotImplementedError(
                f"{conf.query_type.value} queries: {NOT_PORTED}")
        self.conf = dataclasses.replace(conf)
        self.grid = grid
        self.device = resolve_device(device)
        #: pruning counters summed over the run's windows
        self.pruning = {"gn-bypassed": 0, "distance-computations": 0}

    def _point_batch(self, records: LazyRecords, ts_base: int) -> PointBatch:
        return records.point_batch(ts_base, self.device)

    def _windows(self, stream: Iterable
                 ) -> Iterator[Tuple[int, int, LazyRecords]]:
        wa = WindowAssembler(self.conf.window_spec(),
                             self.conf.allowed_lateness_ms)
        return wa.assemble(_record_chunks(stream, self.grid))

    def _filter_stream(self, batch: PointBatch, mask_stats_fn):
        """(mask, gn_bypassed, dist_evals) for one batch on one device."""
        return mask_stats_fn(batch)

    def _defer_with_stats(self, dev, stats, rows) -> Deferred:
        """``stats`` = (gn_bypassed, dist_evals) device scalars ride the same
        readback as the result and bump :attr:`pruning` at collect time;
        ``rows(host_result)`` turns the result into records."""
        def collect(host):
            main, gn, evals = host
            self.pruning["gn-bypassed"] += int(gn)
            self.pruning["distance-computations"] += int(evals)
            return rows(main)
        return Deferred((dev, *stats), collect)

    def _defer_mask_select(self, mask, records: LazyRecords,
                           stats) -> Deferred:
        """Deferred selection of ``records`` by a device boolean mask."""
        def rows(m):
            idx = np.nonzero(m)[0]
            return records.take(idx[idx < len(records)])
        return self._defer_with_stats(mask, stats, rows)

    def _drive(self, stream: Iterable, eval_batch
               ) -> Iterator[WindowResult]:
        """Windowed driver: ``eval_batch(records, ts_base)`` returns a record
        list or a :class:`Deferred`; deferred results are pipelined, up to
        ``conf.pipeline_depth`` windows in flight, and emitted in window
        order. Every window is reported, selected-or-not."""
        return self._drive_batched(self._windows(stream), eval_batch)

    def _drive_batched(self, batched: Iterable, eval_batch
                       ) -> Iterator[WindowResult]:
        depth = max(1, self.conf.pipeline_depth)
        pending: deque = deque()  # (start, end, Deferred)

        def drain(n: int) -> Iterator[WindowResult]:
            while len(pending) > n:
                start, end, dfd = pending.popleft()
                yield WindowResult(start, end, dfd.finish())

        for start, end, payload in batched:
            sel = eval_batch(payload, start)
            if isinstance(sel, Deferred):
                pending.append((start, end, sel))
                yield from drain(depth - 1)
            else:
                yield from drain(0)  # keep window order
                yield WindowResult(start, end, sel)
        yield from drain(0)


class GeomQueryMixin:
    """Query-side precomputation: dense GN/CN cell masks (union over the
    query geometry's cells) and the padded query edge array, on the
    operator's device."""

    def _query_cells(self, query) -> list:
        if isinstance(query, Point):
            return [query.cell] if query.cell >= 0 else []
        return sorted(query.cells)

    def _query_masks(self, query, radius: float):
        cells = self._query_cells(query)
        gn = self.grid.guaranteed_cells_mask(radius, cells)
        cn = self.grid.candidate_cells_mask(radius, cells, gn)
        return tuple(to_device(m, np.bool_, self.device) for m in (gn, cn))

    def _query_edges(self, query):
        e, m = single_query_edges(query)
        areal = isinstance(query, (Polygon, MultiPolygon))
        return (to_device(e, np.float32, self.device),
                to_device(m, np.bool_, self.device), areal)

    def _query_bbox(self, query):
        return to_device(np.asarray(query.bbox, np.float32), np.float32,
                         self.device)
