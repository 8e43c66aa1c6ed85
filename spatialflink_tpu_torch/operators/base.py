"""Operator plumbing (port of ``spatialflink_tpu.operators.base`` for point,
polygon and linestring streams): query configuration, deferred device
results (selection masks and kNN lists, single- and multi-query), the
pipelined driver over time windows, count windows and realtime
micro-batches, the shared multi-query range driver, the window batches
(``PointBatch`` of a point stream, ``EdgeGeomBatch`` of a geometry stream,
whose ids the operator's own interner numbers, as the JAX package's
``_geom_batch`` does), and query-side precomputation.

Realtime mode: the reference uses tiny tumbling windows with
fire-per-element triggers; here arrivals are cut into micro-batches of
``realtime_batch_size`` records (``runtime.MicroBatcher``), each evaluated
in one dispatch, and a micro-batch whose selection is empty is not
emitted. Count windows: every ``slide`` arrivals, the last ``size``
records (``runtime.count_windows``); ``window_size_ms``/``slide_ms`` are
then counts.

Pane-incremental windows (``conf.panes``, sliding time windows whose
slide divides their size): records are buffered once per slide-aligned
pane (``runtime.PaneBuffer``), the window evaluator runs once per sealed
pane, and each window merges its panes' cached partials
(:meth:`SpatialOperator._pane_eval`): range selections concatenate in pane
order, kNN lists merge on the host (``ops.knn.merge_topk_host``) or, for
the device merge, in one K3 launch over the partials still on the device.

The dynamic standing-query plane (:meth:`SpatialOperator._run_dynamic_filter`
and the kNN ``run_dynamic``): the Q axis comes from a live
``runtime.queryplane.QueryRegistry``, applied once per window and padded to
a power-of-two bucket whose padded slots a valid gate forces empty.

Checkpoints (``conf.checkpointer``, a ``runtime.checkpoint.
CheckpointCoordinator``): the window assembler (``windows``), the pane
buffer (``panes``), the realtime micro-batcher (``realtime-batcher``), the
pane cache (``pane-cache``, with the operator's ``interner``) register with
the coordinator under the JAX package's names, and :meth:`_drive_batched`
is the barrier: when a checkpoint is due it drains every deferred window
(each drained result is consumed downstream before the next is pulled)
and commits. Restored pane partials come back on the host; where the
family merges on the device (kNN), they go onto the device at the first
window that reads them and take the device merge with the fresh ones.

The adaptive grid (``conf.adaptive_grid``, an ``index.AdaptiveGrid``): the
point-stream range operators keep each query's GN ∪ CN leaf mask
(:class:`_LeafMaskCache`, rebuilt when the grid's version moves), and
:meth:`SpatialOperator._prefilter` keeps only a window's records whose leaf
is in it, on the host, before the batch is built: K1 / K4 / K4x run on the
kept rows (base cells, as ever), and a window that keeps nothing launches
nothing. The leaf masks over-approximate the kernels' own selection for
every layout, so exact-mode results are those of the uniform grid.

Telemetry (``utils.telemetry``): the drive loop reads
``telemetry.active()`` once per loop. With a session it times each
window's assembly pull, dispatch and readback as ``window`` / ``kernel``
/ ``merge`` spans under the family label (``range.kernel``), sets the
``window-backlog`` gauge, records the ``dispatch-overlap-ratio``
histogram, the latency plane's stage budget, the trace book's notes
(``--trace-dir``), the cost profiles' attribution and the tenant ledger's
dispatch; ``kernel`` spans time the host's dispatch (no device sync), and
``merge`` is where ``Deferred.finish`` already waits. One loop serves
both cases: each hook is guarded by ``tel is not None``, as in the JAX
package. The registry counters (``batches-evaluated``, ``records-evaluated``,
``gn-bypassed``, ``distance-computations``, the pane cache's and the pane
readbacks') are always on, as in the JAX package.

Not yet ported: the device mesh (with it the JAX package's
``conf.shard_order``; the driver accepts ``--shard-order`` and drops it,
as one device has no shards to place) and the chunk governor's drain
depth. The JAX package's single-device seams around the mesh
(``_multi_filter_stream``, ``_knn_multi_result``) have no mesh to route
here, so the port calls the per-batch closures directly.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from spatialflink_tpu_torch.device import resolve_device
from spatialflink_tpu_torch.index import UniformGrid
from spatialflink_tpu_torch.index.uniform_grid import observe_cells
from spatialflink_tpu_torch.models import (EdgeGeomBatch, MultiPolygon,
                                            Point, PointBatch, Polygon,
                                            single_query_edges)
from spatialflink_tpu_torch.models.batches import to_device
from spatialflink_tpu_torch.runtime import (MicroBatcher, PaneBuffer,
                                            WindowAssembler, WindowSpec,
                                            count_windows)
from spatialflink_tpu_torch.streams.bulk import (BulkStream, BulkWindow,
                                                 GeomChunk, LazyRecords,
                                                 PointChunk, PointRows,
                                                 points_to_parsed)
from spatialflink_tpu_torch.utils import IdInterner, metrics
from spatialflink_tpu_torch.utils import telemetry as _telemetry
from spatialflink_tpu_torch.utils.metrics import ControlTupleExit

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
    # pane-incremental sliding windows (the --panes switch): the window
    # evaluator runs once per slide-aligned pane and windows merge the
    # cached partials; identical results. Tumbling windows, specs whose
    # slide does not divide the size, realtime and count windows bypass it
    panes: bool = False
    # where kNN pane partials merge (--pane-merge): True on the device (one
    # K3 launch per window over the partials still there), False on the
    # host; None picks the device on CUDA and the host on the CPU
    pane_device_merge: Optional[bool] = None
    # the run's runtime.checkpoint.CheckpointCoordinator (--checkpoint-dir):
    # the operator registers its window, pane and state participants with
    # it and barriers between processing units; None = no checkpoints
    checkpointer: Optional[Any] = field(default=None, repr=False,
                                        compare=False)
    # the skew-adaptive refinement layer (--adaptive-grid): an
    # index.AdaptiveGrid whose GN ∪ CN leaf masks select a window's records
    # on the host before the point-stream range kernels run; results are
    # the uniform grid's. None = the uniform grid alone
    adaptive_grid: Optional[Any] = field(default=None, repr=False,
                                         compare=False)

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
    ``collect``. CPU results pass straight through. With ``copy=False``
    (a pane partial that the device merge reads where it lies) nothing is
    queued, and :meth:`finish`, if it is ever called, copies then. ``ids``
    is the id space of a kNN result's device ids."""

    __slots__ = ("device_result", "collect", "ids", "_host", "_event")

    def __init__(self, device_result: Tuple[torch.Tensor, ...],
                 collect: Callable[[Tuple[np.ndarray, ...]], List], *,
                 copy: bool = True):
        self.device_result = device_result
        self.collect = collect
        self.ids = None
        self._host = self._event = None
        if copy:
            self._copy()

    def _copy(self) -> None:
        if self.device_result and \
                self.device_result[0].device.type == "cuda":
            self._host = tuple(
                torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                .copy_(t, non_blocking=True) for t in self.device_result)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = self.device_result

    def finish(self) -> List:
        if self._host is None:
            self._copy()
        if self._event is not None:
            self._event.synchronize()
        return self.collect(tuple(t.numpy() for t in self._host))


class PaneCache:
    """The pane partials of a run, keyed by pane start (or, for the join's
    pane-pair blocks, by ``(pane_a, pane_b)``, with ``key_floor`` mapping a
    key to the pane start its eviction hinges on): get-or-evaluate with
    hit and miss counts, and eviction in ascending window order (once
    window ``s`` has looked its panes up, no later window needs a key
    whose floor is below ``s + slide``). :meth:`snapshot` /
    :meth:`restore` carry the partials across a checkpoint. Hits and
    misses also count in the registry's ``pane-cache-hits`` /
    ``pane-cache-misses``."""

    __slots__ = ("slide", "cache", "hits", "misses", "key_floor",
                 "_hits_c", "_misses_c")

    def __init__(self, slide_ms: int, key_floor=None):
        self.slide = slide_ms
        self.cache: dict = {}
        self.hits = self.misses = 0
        self._hits_c = metrics.REGISTRY.counter("pane-cache-hits")
        self._misses_c = metrics.REGISTRY.counter("pane-cache-misses")
        self.key_floor = key_floor if key_floor is not None else (
            lambda k: k)

    def get(self, key, evaluate):
        if key in self.cache:
            self.hits += 1
            self._hits_c.inc()
            return self.cache[key]
        self.misses += 1
        self._misses_c.inc()
        value = self.cache[key] = evaluate()
        return value

    def evict_before(self, window_start: int) -> None:
        limit = window_start + self.slide
        for dead in [k for k in self.cache if self.key_floor(k) < limit]:
            del self.cache[dead]

    def snapshot(self, encode_value) -> dict:
        """The cache as JSON for the checkpoint coordinator, in the JAX
        package's form ``[json key, wrapped, encoded value]``.
        ``encode_value`` is ``runtime.checkpoint.value_codec``'s encoder; an
        entry it cannot encode is skipped (it is a miss on resume and
        recomputes). A :class:`PanePartial` still on the device is read
        back for the snapshot and stays on the device for the run."""
        import json as _json

        entries = []
        skipped = metrics.REGISTRY.counter("pane-cache-snapshot-skipped")
        for key, value in self.cache.items():
            wrapped = isinstance(value, PanePartial)
            try:
                enc = encode_value(value.peek() if wrapped else value)
            except TypeError:
                skipped.inc()
                continue
            entries.append([_json.dumps(key), wrapped, enc])
        return {"entries": entries}

    def restore(self, state: dict, decode_value) -> None:
        """Inverse of :meth:`snapshot` (list keys, the join's pane pairs,
        become tuples); restored partials are host values (the kNN device
        merge puts them on the device at their first use)."""
        import json as _json

        for raw_key, wrapped, enc in state.get("entries", []):
            key = _json.loads(raw_key)
            if isinstance(key, list):
                key = tuple(key)
            value = decode_value(enc)
            self.cache[key] = PanePartial(value) if wrapped else value


def _device_nbytes(x) -> int:
    """Summed ``nbytes`` over the tensors of a deferred device payload
    (tuples, named tuples, lists): the pane readback bytes."""
    total = 0
    stack = [x]
    while stack:
        v = stack.pop()
        if v is None:
            continue
        nb = getattr(v, "nbytes", None)
        if nb is not None:
            total += int(nb)
        elif isinstance(v, (tuple, list)):
            stack.extend(v)
    return total


class PanePartial:
    """One pane's cached partial: the evaluator's raw output (a
    :class:`Deferred` or a final host value), read back at most once
    however many windows share the pane. ``stats_done`` marks a partial
    whose pruning counts a device merge has already taken."""

    __slots__ = ("value", "stats_done")

    def __init__(self, value):
        self.value = value
        self.stats_done = False

    def resolve(self):
        if isinstance(self.value, Deferred):
            reg = metrics.REGISTRY
            reg.counter("pane-partial-readbacks").inc()
            reg.counter("pane-partial-readback-bytes").inc(
                _device_nbytes(self.value.device_result))
            self.value = self.value.finish()
        return self.value

    def peek(self):
        """The host value, read back without replacing a device partial
        (the device merge keeps reading it where it lies)."""
        if isinstance(self.value, Deferred):
            return self.value.finish()
        return self.value


class _LeafMaskCache:
    """One query's (or a fleet's union) leaf mask under the adaptive grid,
    stamped with the grid's version: after a repartition the next window
    rebuilds it (counted in ``prefilter-mask-recomputes``)."""

    __slots__ = ("grid", "build", "version", "mask")

    def __init__(self, grid, build):
        self.grid = grid
        self.build = build
        self.version = -1
        self.mask = None

    def get(self) -> np.ndarray:
        if self.mask is None or self.version != self.grid.version:
            if self.mask is not None:
                metrics.REGISTRY.counter("prefilter-mask-recomputes").inc()
            self.mask = self.build()
            self.version = self.grid.version
        return self.mask


def _take_many(records, idx_lists) -> List:
    """The records at each list of window positions: ``take_many`` of a
    columnar window, else lists of the records."""
    take_many = getattr(records, "take_many", None)
    if take_many is not None:
        return take_many(idx_lists)
    return [[records[int(i)] for i in idx] for idx in idx_lists]


def _take(records, idx) -> List:
    return _take_many(records, [idx])[0]


def _record_chunks(stream: Iterable, grid: UniformGrid,
                   chunk: int = 4096) -> Iterator:
    """The stream as decoded chunks: a chunked decode stream passes its
    ``.chunks()`` through; a plain iterable of records is cut into chunks:
    Point records into columnar chunks whose cells are assigned on
    ``grid``, polygons and linestrings (their cells assigned at creation)
    into geometry chunks."""
    chunks_fn = getattr(stream, "chunks", None)
    if chunks_fn is not None:
        yield from chunks_fn()
        return
    interner = IdInterner()

    def build(buf):
        if isinstance(buf[0], Point):
            return PointChunk.build(points_to_parsed(buf, interner), grid)
        return GeomChunk(buf)

    buf: List = []
    for rec in stream:
        buf.append(rec)
        if len(buf) >= chunk:
            yield build(buf)
            buf = []
    if buf:
        yield build(buf)


class SpatialOperator:
    """Shared driver: turns a record stream into point-window batches on
    ``device`` and pipelines their evaluation."""

    #: the query family that scopes telemetry span names (``knn.kernel``);
    #: None falls back to the class name
    telemetry_label: Optional[str] = None

    def __init__(self, conf: QueryConfiguration, grid: UniformGrid, *,
                 device="cuda"):
        self.conf = dataclasses.replace(conf)
        self.grid = grid
        self.device = resolve_device(device)
        #: pruning counters summed over the run's windows
        self.pruning = {"gn-bypassed": 0, "distance-computations": 0}
        #: object ids of a geometry stream's batches (kNN ties follow it)
        self.interner = IdInterner()
        #: the pane partial cache of the last pane run (hits, misses)
        self.pane_cache: Optional[PaneCache] = None
        #: pane partials stay on the device for the device merge
        self._pane_resident = False

    def _point_batch(self, records: LazyRecords, ts_base: int) -> PointBatch:
        if self.conf.query_type is QueryType.CountBased:
            observe_cells(records.columns()[4])
        return records.point_batch(ts_base, self.device)[0]

    def _geom_batch(self, records, ts_base: int) -> EdgeGeomBatch:
        """A geometry window's batch, ids interned through the operator's
        interner."""
        return records.geom_batch(ts_base, self.device, self.interner)[0]

    @property
    def realtime(self) -> bool:
        return self.conf.query_type is QueryType.RealTime

    def _windows(self, stream: Iterable
                 ) -> Iterator[Tuple[int, int, LazyRecords]]:
        """The stream's evaluation units as (start, end, records): realtime
        micro-batches, count windows, or sealed event-time windows."""
        chunks = _record_chunks(stream, self.grid)
        if self.realtime:
            mb = MicroBatcher(self.conf.realtime_batch_size)
            self._register_ckpt_windows("realtime-batcher", mb)
            return mb.batches(chunks)
        if self.conf.query_type is QueryType.CountBased:
            return count_windows(chunks, self.conf.window_size_ms,
                                 self.conf.slide_ms)
        wa = WindowAssembler(self.conf.window_spec(),
                             self.conf.allowed_lateness_ms)
        self._register_ckpt_windows("windows", wa)
        return wa.assemble(chunks)

    # ------------------------- checkpointing -------------------------- #

    @property
    def _ckpt(self):
        """The run's CheckpointCoordinator (None: no checkpoints)."""
        return self.conf.checkpointer

    def _register_ckpt_windows(self, name: str, wa) -> None:
        """Register a WindowAssembler, PaneBuffer or MicroBatcher (their
        ``snapshot(encode)`` / ``restore(state, decode)``) under ``name``;
        loaded state restores the moment it registers."""
        coord = self._ckpt
        if coord is None:
            return
        from spatialflink_tpu_torch.runtime.checkpoint import record_codec

        enc, dec = record_codec(self.grid)
        coord.register(name, lambda: ({}, wa.snapshot(enc)),
                       lambda _arrays, meta: wa.restore(meta, dec))

    def _register_ckpt_pane_cache(self, name: str, cache: PaneCache
                                  ) -> None:
        """Register a pane cache, and the operator's interner beside it
        (a trajectory family's partials index by its ids)."""
        coord = self._ckpt
        if coord is None:
            return
        from spatialflink_tpu_torch.runtime.checkpoint import value_codec

        enc, dec = value_codec(self.grid)
        coord.register(name, lambda: ({}, cache.snapshot(enc)),
                       lambda _arrays, meta: cache.restore(meta, dec))
        self._register_ckpt_interner()

    def _register_ckpt_interner(self) -> None:
        coord = self._ckpt
        if coord is None:
            return

        def restore(_arrays, meta):
            self.interner = IdInterner.from_list(meta["ids"])
            self._id_maps = {}

        coord.register("interner",
                       lambda: ({}, {"ids": self.interner.to_list()}),
                       restore)

    def _checkpoint_barrier(self) -> None:
        """The barrier of the loops with no deferred window in flight:
        called after a ``yield``, where the yielded result has been
        consumed downstream."""
        coord = self._ckpt
        if coord is not None:
            coord.barrier()

    # --------------------- adaptive-grid prefilter -------------------- #

    def _leaf_mask_cache(self, build) -> Optional[_LeafMaskCache]:
        """A version-stamped cache of ``build()``'s leaf mask, or None when
        the adaptive grid is off: the one gate of every prefiltering
        evaluator."""
        ag = self.conf.adaptive_grid
        return _LeafMaskCache(ag, build) if ag is not None else None

    @staticmethod
    def _record_arrays(records):
        """(x, y, ts, obj_id, cell) arrays of a window's records: the
        columns of a :class:`LazyRecords`, else one pass over the records'
        fields (obj_id None: the kept batch of such records carries no
        ids, which the range kernels do not read)."""
        if isinstance(records, LazyRecords):
            return records.columns()[:5]
        return (np.array([r.x for r in records], np.float64),
                np.array([r.y for r in records], np.float64),
                np.array([r.timestamp for r in records], np.int64), None,
                np.array([r.cell for r in records], np.int32))

    @staticmethod
    def _chunk_leaves(chunk: PointChunk, ag) -> np.ndarray:
        """A chunk's leaf ids under the grid's current layout, assigned
        once per chunk and version (a sliding window revisits a chunk
        size / slide times) and kept in ``chunk.leaf_cache``."""
        cache = chunk.leaf_cache
        if cache is not None and cache[0] == ag.version:
            return cache[1]
        leaf = ag.assign_leaf(chunk.parsed.x, chunk.parsed.y)
        chunk.leaf_cache = (ag.version, leaf)
        return leaf

    def _prefilter(self, records, mask_cache: Optional[_LeafMaskCache],
                   ts_base: int):
        """The pre-kernel prefilter over the leaf space: keep exactly the
        records whose leaf is in ``mask_cache``'s mask, and build the
        (smaller) device batch from them. Returns ``(keep, batch)``, the
        kept window positions, ascending, and their batch (None when no
        record is kept: the window launches nothing), or None when the
        adaptive grid is off or the window is a bulk replay's (whose
        batches are built before any window, as in the JAX package).

        The mask and the leaves are read at one grid version, here, between
        two pulls of the window source (where epochs fire), whatever is in
        flight. Counts ``prefilter-records``, ``prefilter-kept`` and
        ``prefilter-windows-skipped``."""
        if mask_cache is None or isinstance(records, BulkWindow):
            return None
        ag = self.conf.adaptive_grid
        mask = mask_cache.get()
        reg = metrics.REGISTRY
        if isinstance(records, LazyRecords):
            total = off = 0
            keep_pos: List[np.ndarray] = []
            cols: List[Tuple[np.ndarray, ...]] = []
            for chunk, idx in records._segs:
                leaf = self._chunk_leaves(chunk, ag)[idx]
                # one gather and one AND (an invalid leaf reads slot 0)
                k = mask[np.where(leaf >= 0, leaf, 0)] & (leaf >= 0)
                total += int(idx.size)
                kp = np.nonzero(k)[0]
                if kp.size:
                    keep_pos.append(off + kp)
                    sel = idx[kp]
                    p = chunk.parsed
                    cols.append((p.x[sel], p.y[sel], p.ts[sel],
                                 p.obj_id[sel], chunk.cells[sel]))
                off += int(idx.size)
            reg.counter("prefilter-records").inc(total)
            if not keep_pos:
                reg.counter("prefilter-windows-skipped").inc()
                return np.empty(0, np.int64), None
            keep = np.concatenate(keep_pos)
            reg.counter("prefilter-kept").inc(int(keep.size))
            x, y, ts, oid, cell = (np.concatenate(c) for c in zip(*cols))
        else:
            x, y, ts, oid, cell = self._record_arrays(records)
            leaf = ag.assign_leaf(x, y)
            k = np.zeros(leaf.shape, bool)
            v = leaf >= 0
            k[v] = mask[leaf[v]]
            keep = np.nonzero(k)[0]
            reg.counter("prefilter-records").inc(int(leaf.size))
            reg.counter("prefilter-kept").inc(int(keep.size))
            if keep.size == 0:
                reg.counter("prefilter-windows-skipped").inc()
                return keep, None
            x, y, ts, cell = x[keep], y[keep], ts[keep], cell[keep]
            oid = None if oid is None else oid[keep]
        return keep, PointBatch.from_arrays(
            x, y, device=self.device, obj_id=oid, ts=ts, ts_base=ts_base,
            cell=cell)

    def _defer_mask_select_at(self, mask, records, keep: np.ndarray,
                              stats) -> Deferred:
        """:meth:`_defer_mask_select` over a prefiltered batch: the mask's
        positions index ``keep``, the kept window positions."""
        def rows(m):
            sel = np.nonzero(m)[0]
            return _take(records, keep[sel[sel < keep.size]])
        return self._defer_with_stats(mask, stats, rows)

    def _filter_eval(self, mask_stats, mask_cache=None):
        """The window evaluator of a single-query point-stream filter: the
        prefilter's kept rows (``mask_cache`` set) or the whole window as
        one batch, through ``mask_stats``, selected at collect time."""
        def eval_batch(records, ts_base):
            if not len(records):
                return []
            pre = self._prefilter(records, mask_cache, ts_base)
            if pre is not None:
                keep, batch = pre
                if batch is None:  # no candidate leaf in this window
                    return []
                mask, gn_c, evals = self._filter_stream(batch, mask_stats)
                return self._defer_mask_select_at(mask, records, keep,
                                                  (gn_c, evals))
            batch = self._point_batch(records, ts_base)
            mask, gn_c, evals = self._filter_stream(batch, mask_stats)
            return self._defer_mask_select(mask, records, (gn_c, evals))
        return eval_batch

    def _filter_stream(self, batch: PointBatch, mask_stats_fn):
        """(mask, gn_bypassed, dist_evals) for one batch on one device."""
        return mask_stats_fn(batch)

    def _record_pruning_stats(self, gn_bypassed: int, dist_evals: int
                              ) -> None:
        """The pruning counters (the reference's "Distance Computation
        Count" and its complement): the operator's :attr:`pruning` and the
        registry's ``gn-bypassed`` / ``distance-computations``."""
        self.pruning["gn-bypassed"] += gn_bypassed
        self.pruning["distance-computations"] += dist_evals
        reg = metrics.REGISTRY
        reg.counter("gn-bypassed").inc(gn_bypassed)
        reg.counter("distance-computations").inc(dist_evals)

    def _defer_with_stats(self, dev, stats, rows) -> Deferred:
        """``stats`` = (gn_bypassed, dist_evals) device counts — scalars, or
        per-query (Q,) rows summed here — ride the same readback as the
        result and bump :attr:`pruning` at collect time; ``rows(host_result)``
        turns the result into records."""
        def collect(host):
            main, gn, evals = host
            self._record_pruning_stats(int(gn.sum()), int(evals.sum()))
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
            self._record_pruning_stats(0, int(evals.sum()))
            return _knn_pairs(oid, dist, valid, ids)
        return self._knn_deferred((*res, dist_evals), collect, ids)

    def _defer_knn_multi(self, res, ids, dist_evals,
                         live: Optional[int] = None, weigh=None) -> Deferred:
        """Deferred per-query (objID, distance) lists from a (Q, k)
        KnnResult, the first ``live`` rows (all by default); ``dist_evals``
        (Q,) is summed into the counter. ``weigh(valid)`` (the dynamic
        plane's tenant ledger) sees the live rows' host valid flags."""
        def collect(host):
            oid, dist, valid, evals = host
            self._record_pruning_stats(0, int(evals.sum()))
            if weigh is not None:
                weigh(valid[:live])
            return [_knn_pairs(o, d, v, ids)
                    for o, d, v in zip(oid[:live], dist[:live],
                                       valid[:live])]
        return self._knn_deferred((*res, dist_evals), collect, ids)

    def _knn_deferred(self, device_result, collect, ids) -> Deferred:
        """A kNN result's :class:`Deferred`, tagged with its id space; a
        pane partial for the device merge is not copied to the host."""
        d = Deferred(device_result, collect, copy=not self._pane_resident)
        d.ids = ids
        return d

    @staticmethod
    def _query_point_arrays(query_points, device: torch.device):
        """(qx (Q,) f32, qy (Q,) f32, q_cell (Q,) int32) tensors on
        ``device`` from a list of query points (built once per run)."""
        return (to_device([q.x for q in query_points], np.float32, device),
                to_device([q.y for q in query_points], np.float32, device),
                to_device([q.cell for q in query_points], np.int32, device))

    @staticmethod
    def _multi_rows(records, keep: Optional[np.ndarray], live: int):
        """``rows`` of a multi-query window: the first ``live`` rows of the
        (Q, N) host masks as per-query records; a prefiltered batch's mask
        positions index ``keep``, the kept window positions."""
        limit = keep.size if keep is not None else len(records)

        def rows(m):
            out = []
            for r in m[:live]:
                idx = np.nonzero(r)[0]
                idx = idx[idx < limit]
                out.append(keep[idx] if keep is not None else idx)
            return _take_many(records, out)
        return rows

    def _run_multi_filter(self, stream: Iterable, n_queries: int,
                          multi_mask_stats, batch_fn=None,
                          leaf_mask_builder=None
                          ) -> Iterator[WindowResult]:
        """Shared run_multi driver for the range operators:
        ``multi_mask_stats(batch) -> (masks (Q, N), gn (Q,), evals (Q,))``
        in one dispatch per window over ``batch_fn(records, ts_base)``'s
        batch (a point batch by default); records become Q per-query record
        lists, pruning counters sum over the queries.

        ``leaf_mask_builder`` (point streams, adaptive grid only) builds
        the UNION of the Q queries' GN ∪ CN leaf masks: a record outside
        every query's candidate leaves is in no query's result, so the
        (Q, N) launch shrinks to (Q, kept)."""
        batch_fn = batch_fn or self._point_batch
        mask_cache = (self._leaf_mask_cache(leaf_mask_builder)
                      if leaf_mask_builder is not None else None)

        def eval_batch(records, ts_base):
            if not len(records):
                return [[] for _ in range(n_queries)]
            pre = self._prefilter(records, mask_cache, ts_base)
            if pre is not None:
                keep, batch = pre
                if batch is None:
                    return [[] for _ in range(n_queries)]
            else:
                keep, batch = None, batch_fn(records, ts_base)
            masks, gn_c, evals = multi_mask_stats(batch)
            # ONE (Q, N) device->host transfer
            return self._defer_with_stats(
                masks, (gn_c, evals),
                self._multi_rows(records, keep, n_queries))

        for result in self._multi_results(
                stream, eval_batch,
                pane_merge=self._pane_concat_multi(n_queries)):
            result.extras["queries"] = n_queries
            yield result

    def _drive(self, stream: Iterable, eval_batch, *, pane_merge=None,
               pane_device_merge=None) -> Iterator[WindowResult]:
        """The drive loop of every mode: ``eval_batch(records, ts_base)``
        returns a record list or a :class:`Deferred`; deferred results are
        pipelined, up to ``conf.pipeline_depth`` in flight, and emitted in
        order. Every window is reported, selected-or-not; a realtime
        micro-batch only when its selection is not empty.

        ``pane_merge(parts) -> records`` opts the family into the pane mode
        (:meth:`_panes_active`): ``eval_batch`` then runs once per sealed
        pane and each window merges its panes' partials
        (:meth:`_pane_eval`, with the family's ``pane_device_merge``).

        A :class:`BulkStream` (bulk replay) gives its windows assembled at
        once, time windows only, pane by pane where it allows panes."""
        if isinstance(stream, BulkStream):
            return self._drive_bulk(stream, eval_batch, pane_merge,
                                    pane_device_merge)
        if pane_merge is not None and self._panes_active():
            return self._drive_batched(
                self._pane_windows(stream),
                self._pane_eval(eval_batch, pane_merge, pane_device_merge))
        self._pane_resident = False
        return self._drive_batched(self._windows(stream), eval_batch,
                                   realtime=self.realtime)

    def _drive_bulk(self, stream: BulkStream, eval_batch, pane_merge,
                    pane_device_merge) -> Iterator[WindowResult]:
        """The drive loop over a bulk-parsed stream's windows (the JAX
        package's ``_drive_bulk``); results are original-record index
        lists, or kNN pairs resolved through the parse's interner."""
        if self.conf.query_type is not QueryType.WindowBased:
            raise ValueError("bulk replay runs time windows only")
        spec = self.conf.window_spec()
        if pane_merge is not None and stream.panes and self._panes_active():
            return self._drive_batched(
                stream.pane_windows(spec, self.grid, self.device),
                self._pane_eval(eval_batch, pane_merge, pane_device_merge))
        self._pane_resident = False
        return self._drive_batched(
            stream.windows(spec, self.grid, self.device), eval_batch)

    def _multi_results(self, stream: Iterable, eval_batch, *,
                       pane_merge=None, pane_device_merge=None
                       ) -> Iterator[WindowResult]:
        """:meth:`_drive` for multi-query evaluators, whose result (a list
        of Q per-query lists) is always truthy: in realtime mode a
        micro-batch is dropped when every query's list is empty."""
        for result in self._drive(stream, eval_batch, pane_merge=pane_merge,
                                  pane_device_merge=pane_device_merge):
            if self.realtime and not any(result.records):
                continue
            yield result

    # ------------------------- pane-incremental ----------------------- #

    def _panes_active(self) -> bool:
        """The pane mode applies: ``conf.panes`` is on, the query runs time
        windows, and the spec decomposes into panes (tumbling windows and
        slides that do not divide the size bypass it)."""
        return (self.conf.panes
                and self.conf.query_type is QueryType.WindowBased
                and self.conf.window_spec().pane_decomposable())

    def _pane_windows(self, stream: Iterable) -> Iterator[Tuple]:
        """The window set and sealing of :meth:`_windows`, each window's
        payload its list of ``(pane_start, records)``; every record is
        buffered once."""
        pb = PaneBuffer(self.conf.window_spec(),
                        self.conf.allowed_lateness_ms)
        self._register_ckpt_windows("panes", pb)
        return pb.assemble(_record_chunks(stream, self.grid))

    def _pane_eval(self, pane_partial, merge_partials, device_merge=None):
        """The evaluator of pane-window payloads: ``pane_partial(records,
        pane_start)`` (the family's window evaluator) runs once per sealed
        pane, and a window's result is ``merge_partials`` of its panes'
        partials, read back at collect time. ``device_merge(parts)`` (kNN)
        merges the partials where they lie on the device and returns a
        :class:`Deferred` of the merged window, or None where the JAX
        package falls back to the host merge (partials of different id
        spaces): the results are the same. ``conf.pane_device_merge`` None
        picks the device merge on CUDA (the JAX package picks it off its
        CPU backend). With a telemetry session, each pane sealing is a
        ``pane-seal`` trace note, the cache's hits and misses go to the
        cost profiles, and the merge is a ``pane-merge`` span with its
        readback bytes."""
        cache = self.pane_cache = PaneCache(self.conf.slide_ms)
        self._register_ckpt_pane_cache("pane-cache", cache)
        want = self.conf.pane_device_merge
        if want is None:
            want = self.device.type == "cuda"
        use_device = device_merge is not None and want
        self._pane_resident = use_device
        tel = _telemetry.active()
        label = self.telemetry_label or type(self).__name__
        book = tel.traces if tel is not None else None
        costs = tel.costs if tel is not None else None
        reg = metrics.REGISTRY
        rb_bytes = reg.counter("pane-partial-readback-bytes")

        def seal_pane(p_start, payload, ts_base):
            if book is None:
                return PanePartial(pane_partial(payload, p_start))
            t0 = time.time()
            part = PanePartial(pane_partial(payload, p_start))
            book.note(label, ts_base, "pane-seal", t0, time.time(),
                      pane=int(p_start), records=int(len(payload)))
            return part

        def eval_batch(panes, ts_base):
            h0, m0 = cache.hits, cache.misses
            parts = [cache.get(p_start,
                               lambda: seal_pane(p_start, payload, ts_base))
                     for p_start, payload in panes]
            cache.evict_before(ts_base)
            if costs is not None:
                costs.note_pane(label, cache.hits - h0, cache.misses - m0)
            merged = device_merge(parts) if use_device else None
            if merged is not None:
                def collect_dev(_):
                    # the partials stay on the device: only the merged
                    # window crosses, counted as the window's readback
                    nb = _device_nbytes(merged.device_result)
                    reg.counter("pane-merged-readbacks").inc()
                    reg.counter("pane-merged-readback-bytes").inc(nb)
                    if tel is None:
                        return merged.finish()
                    with tel.span("pane-merge", query=label):
                        out = merged.finish()
                    costs.note_readback(label, nb)
                    return out

                return Deferred((), collect_dev)

            def collect(_):
                if tel is None:
                    return merge_partials([h.resolve() for h in parts])
                b0 = rb_bytes.count
                with tel.span("pane-merge", query=label):
                    out = merge_partials([h.resolve() for h in parts])
                costs.note_readback(label, rb_bytes.count - b0)
                return out

            return Deferred((), collect)

        return eval_batch

    @staticmethod
    def _pane_concat(parts: List) -> List:
        """The merge of filter-shaped partials: panes are disjoint, so the
        window's selection is their concatenation in pane order: one
        :class:`PointRows` over the panes' selected columns for a point
        stream (``--output`` and the latency variants read it as they read
        a full window's), the geometries in one list otherwise."""
        if parts and all(isinstance(p, PointRows) for p in parts):
            return PointRows.concat(parts)
        return [r for part in parts for r in part]

    @staticmethod
    def _pane_concat_multi(n_queries: int):
        """Per-query :meth:`_pane_concat` for multi-query partials (each a
        list of Q per-query selections)."""
        def merge(parts):
            return [SpatialOperator._pane_concat([part[q] for part in parts])
                    for q in range(n_queries)]
        return merge

    # ------------------------ the dynamic plane ----------------------- #

    def _run_dynamic_filter(self, stream: Iterable, registry, radius: float,
                            multi_mask_builder, batch_fn=None,
                            leaf_union_builder=None
                            ) -> Iterator[WindowResult]:
        """The standing-query driver of the range families: the Q axis is
        the live fleet of ``registry`` (``runtime.queryplane``). Per
        window: ``registry.apply()`` lands the staged admissions, updates
        and retirements; on a ``fleet_version`` bump the padded query
        arrays and the gated closure over ``multi_mask_builder(points,
        radius)`` are rebuilt (a change within a size bucket keeps the
        launch shape); the (B, N) masks are ANDed with the (B,) valid gate
        and the pruning counters scaled by it, so padded slots select and
        count nothing; only the live slots become per-query records, and
        each window carries ``extras["query_ids"]``, its fleet at
        dispatch. Panes do not engage: partials are fleet-shaped.
        ``leaf_union_builder(live_points)`` (point streams, adaptive grid
        only) gives the live fleet's union leaf mask for the prefilter; its
        cache is rebuilt with the closure on a fleet bump, and on a grid
        version bump like every leaf mask."""
        batch_fn = batch_fn or self._point_batch
        state: dict = {"v": -1, "entries": [], "fn": None,
                       "mask_cache": None}

        def ensure() -> None:
            if state["v"] == registry.fleet_version:
                return
            entries, qpts, valid = registry.padded_fleet(self.grid)
            fn = mask_cache = None
            if entries:
                base = multi_mask_builder(qpts, radius)
                gate = to_device(valid, np.bool_, self.device)

                def fn(b, _base=base, _g=gate):
                    masks, gn_c, evals = _base(b)
                    return masks & _g[:, None], gn_c * _g, evals * _g
                if leaf_union_builder is not None:
                    live_pts = qpts[:len(entries)]
                    mask_cache = self._leaf_mask_cache(
                        lambda: leaf_union_builder(live_pts))
            state.update(v=registry.fleet_version, entries=entries, fn=fn,
                         mask_cache=mask_cache)

        window_ids: dict = {}

        def eval_batch(records, ts_base):
            registry.apply()
            ensure()
            live = len(state["entries"])
            window_ids[ts_base] = [e.id for e in state["entries"]]
            if not live:
                return []
            if not len(records):
                return [[] for _ in range(live)]
            pre = self._prefilter(records, state["mask_cache"], ts_base)
            if pre is not None:
                keep, batch = pre
                if batch is None:
                    return [[] for _ in range(live)]
            else:
                keep, batch = None, batch_fn(records, ts_base)
            masks, gn_c, evals = state["fn"](batch)
            rows = self._multi_rows(records, keep, live)
            limit = keep.size if keep is not None else len(records)
            weigh = self._tenant_weigh(state["entries"], ts_base,
                                       lambda m: m[:live, :limit].sum(1))
            if weigh is not None:
                plain_rows = rows

                def rows(m):
                    weigh(m)
                    return plain_rows(m)
            # ONE (B, N) device->host transfer
            return self._defer_with_stats(masks, (gn_c, evals), rows)

        for result in self._drive(stream, eval_batch):
            ids = window_ids.pop(result.window_start, [])
            result.extras["query_ids"] = ids
            result.extras["queries"] = len(ids)
            yield result

    def _tenant_weigh(self, entries, ts_base: int, weights):
        """With a telemetry session, ``weigh(host_result)``: the window's
        parked dispatch span resolved on the tenant ledger across the live
        slots (``(query id, tenant)`` captured now: a later ``apply()`` may
        repad before the readback) in proportion to ``weights(host_result)``
        per slot (mask-true candidates, valid neighbours); None without a
        session."""
        tel = _telemetry.active()
        if tel is None:
            return None
        acct = tel.tenants
        label = self.telemetry_label or type(self).__name__
        slots = [(e.id, e.spec.tenant) for e in entries]

        def weigh(host) -> None:
            acct.resolve(label, ts_base, [
                (qid, tenant, int(c))
                for (qid, tenant), c in zip(slots, weights(host))])
        return weigh

    def _drive_batched(self, batched: Iterable, eval_batch, *,
                       realtime: bool = False) -> Iterator[WindowResult]:
        """Pipelined evaluation of (start, end, payload) windows; the
        registry's ``batches-evaluated`` / ``records-evaluated`` count
        them. The dispatch and readback are named ranges of a ``--profile``
        capture (:func:`~spatialflink_tpu_torch.utils.metrics.trace`, a
        shared null context otherwise). With a telemetry session (read once
        here) they are also ``window`` / ``kernel`` / ``merge`` spans under
        the family label, with the ``window-backlog`` gauge, the
        ``dispatch-overlap-ratio`` histogram (1 - blocked / round trip of
        each window), the latency plane's stage budget and in-flight notes,
        the trace book's notes, the cost profiles' kernel and merge
        attribution and the tenant ledger's dispatch. ``kernel`` times the
        host's dispatch; ``merge`` is the readback's wait. An installed
        chunk governor's fast lane bounds the windows in flight
        (``ChunkGovernor.drain_depth``); the results do not change."""
        reg = metrics.REGISTRY
        batches = reg.counter("batches-evaluated")
        records_c = reg.counter("records-evaluated")
        depth = max(1, self.conf.pipeline_depth)
        # the fast lane: while an interactive query serves, the chunk
        # governor bounds the windows in flight here (read per window, a
        # plain bool inside drain_depth)
        from spatialflink_tpu_torch.runtime.control import active_governor

        gov = active_governor()
        pending: deque = deque()  # (start, end, Deferred, t_disp, meta)
        op_name = type(self).__name__
        tel = _telemetry.active()
        label = self.telemetry_label or op_name
        book = tel.traces if tel is not None else None
        costs = tel.costs if tel is not None else None
        lat = tel.latency if tel is not None else None
        acct = tel.tenants if tel is not None else None
        if tel is not None:
            backlog = tel.gauge("window-backlog")
            overlap_hist = tel.histogram("dispatch-overlap-ratio")
            batched = self._spanned_batches(batched, tel, label)

        def emit(start, end, sel) -> Iterator[WindowResult]:
            # realtime mode fires only on a non-empty selection (the
            # reference's fire-per-element trigger never emits empties)
            if sel or not realtime:
                if book is not None:
                    book.seal(label, start, end)
                yield WindowResult(start, end, sel)

        def note_budget(start, end, meta, m0, m1) -> None:
            # consecutive wall-clock intervals from first-record ingest to
            # emission: the stages sum to record->emit by construction.
            # meta = (first_ingest_ms, last_ingest_ms, t_seal, t_kernel0,
            # t_kernel1); m0 / m1 bound the merge
            fi, li, t_seal, k0, k1 = meta
            t_emit = time.time()
            if fi is not None and fi > t_seal * 1e3:
                fi = None  # an int-ms ingest stamp past the seal clock
            lat.window_complete(label, start, end, fi, {
                "buffer": (t_seal * 1e3 - fi) if fi is not None else 0.0,
                "queue": (k0 - t_seal) * 1e3,
                "dispatch": (k1 - k0) * 1e3,
                "inflight": (m0 - k1) * 1e3,
                "merge": (m1 - m0) * 1e3,
                "emit": (t_emit - m1) * 1e3,
            }, t_emit, last_ingest_ms=li)

        def drain(n: int) -> Iterator[WindowResult]:
            while len(pending) > n:
                start, end, dfd, t_disp, meta = pending.popleft()
                if tel is not None:
                    w0 = time.time()
                    with tel.span("merge", query=label), \
                            metrics.trace(f"{op_name}.readback"):
                        sel = dfd.finish()
                    w1 = time.time()
                    if book is not None:
                        book.note(label, start, "merge", w0, w1)
                    costs.attribute_merge(label, w1 - w0)
                    total = w1 - t_disp
                    if total > 0:
                        overlap_hist.record(
                            max(0.0, 1.0 - (w1 - w0) / total))
                    backlog.set(len(pending))
                    if not realtime or sel:
                        note_budget(start, end, meta, w0, w1)
                else:
                    with metrics.trace(f"{op_name}.readback"):
                        sel = dfd.finish()
                yield from emit(start, end, sel)

        coord = self.conf.checkpointer
        batched = iter(batched)
        while True:
            try:
                start, end, payload = next(batched)
            except StopIteration:
                break
            except ControlTupleExit:
                # a stop (control tuple, SIGTERM): the windows in flight
                # emit before it propagates, so a final checkpoint misses
                # none of the records read
                yield from drain(0)
                raise
            batches.inc()
            n_rec = _payload_count(payload)
            records_c.inc(n_rec)
            if tel is not None:
                w0 = time.time()
                # the chain's seal point: the assembler's sweep noted the
                # true seal wall clock of every ready window before the
                # first yielded; without one the pull time stands (queue 0)
                t_seal = lat.pop_seal(start, w0)
                fi = self._first_ingest_ms(payload)
                li = self._last_ingest_ms(payload) if fi is not None \
                    else None
                with tel.span("kernel", query=label), \
                        metrics.trace(f"{op_name}.dispatch"):
                    sel = eval_batch(payload, start)
                w1 = time.time()
                if book is not None:
                    book.note(label, start, "kernel", w0, w1)
                nb = self._payload_nbytes(payload)
                costs.attribute_kernel(label, w1 - w0, records=n_rec,
                                       nbytes=nb)
                # parked on the tenant ledger: the dynamic demux resolves
                # it across the live slots, static paths age into the
                # default tenant
                acct.note_dispatch(label, start, w1 - w0, n_rec, nb)
                meta = (fi, li, min(t_seal, w0), w0, w1)
            else:
                w1, meta = 0.0, None
                with metrics.trace(f"{op_name}.dispatch"):
                    sel = eval_batch(payload, start)
            if isinstance(sel, Deferred):
                pending.append((start, end, sel, w1, meta))
                if tel is not None:
                    lat.note_dispatch(start, w1)
                    backlog.set(len(pending))
                eff = depth if gov is None else gov.drain_depth(depth)
                yield from drain(eff - 1)
            else:
                yield from drain(0)  # keep window order
                if tel is not None and (sel or not realtime):
                    note_budget(start, end, meta, w1, w1)
                yield from emit(start, end, sel)
            if coord is not None:
                # the checkpoint barrier: drain the windows in flight first
                # (their records have left the snapshotted assemblers), so
                # the manifest never misses a sealed, unsunk window
                coord.note_batch()
                if coord.due():
                    yield from drain(0)
                    coord.commit()
        yield from drain(0)

    @classmethod
    def _spanned_batches(cls, batched: Iterable, tel, label: str
                         ) -> Iterator:
        """Each pull of the (start, end, payload) source timed as the
        ``window`` stage (assembly and buffering, the host half the kernel
        spans do not see); with tracing on, each pull also opens the
        window's trace record with its first record's ingest clock. A stop
        raised by the pull propagates unchanged."""
        it = iter(batched)
        book = tel.traces
        while True:
            try:
                t0 = time.time()
                with tel.span("window", query=label):
                    item = next(it)
            except StopIteration:
                return
            if book is not None:
                book.note(label, item[0], "window", t0, time.time())
                ing = cls._first_ingest_ms(item[2])
                if ing is not None:
                    book.first_record(label, item[0], ing)
            yield item

    @staticmethod
    def _first_ingest_ms(payload):
        """The first record's ingest wall clock (ms): a decoded chunk's
        stamp for columnar windows, a record's ``ingestion_time``
        otherwise; None for payloads without one (bulk replay batches)."""
        return _ingest_ms(payload, 0)

    @staticmethod
    def _last_ingest_ms(payload):
        """The last record's ingest wall clock (ms): with the first one it
        bounds the window's buffer residency."""
        return _ingest_ms(payload, -1)

    @staticmethod
    def _payload_nbytes(payload) -> int:
        """Approximate host-to-device bytes of one window payload: the
        arrays' bytes where it carries arrays (bulk ``(idx, batch)``), 32
        bytes a record for host records — an estimate of data motion for
        the cost profiles, not a measured transfer."""
        try:
            if isinstance(payload, tuple) and len(payload) == 2:
                idx, batch = payload
                total = int(getattr(idx, "nbytes", 0) or 0)
                parts = (batch if isinstance(batch, tuple)
                         else [getattr(batch, f, None)
                               for f in getattr(batch, "_fields", ())])
                for a in parts:
                    total += int(getattr(a, "nbytes", 0) or 0)
                return total
            if _is_pane_payload(payload):
                return sum(SpatialOperator._payload_nbytes(p)
                           for _, p in payload)
            return 32 * len(payload)
        except Exception:
            return 0


def _is_pane_payload(payload) -> bool:
    return (isinstance(payload, list) and bool(payload)
            and isinstance(payload[0], tuple) and len(payload[0]) == 2
            and not isinstance(payload[0][1], (int, float)))


def _payload_count(payload) -> int:
    """A window payload's record count (the ``records-evaluated``
    counter): a pane payload's panes summed, a bulk ``(idx, batch)``
    payload's index length, else its length."""
    if isinstance(payload, tuple) and len(payload) == 2 \
            and isinstance(payload[0], np.ndarray):
        return int(payload[0].size)
    if _is_pane_payload(payload):
        return sum(_payload_count(p) for _, p in payload)
    return len(payload)


def _ingest_ms(payload, pos: int):
    """The first (``pos`` 0) or last (-1) record's ingest stamp of a window
    payload, reading one chunk stamp or one record; None when there is
    none."""
    try:
        recs = payload
        if _is_pane_payload(recs):
            recs = recs[pos][1]
        segs = getattr(recs, "_segs", None)
        if segs is not None:
            if not segs:
                return None
            ing = getattr(segs[pos][0], "ingest_ms", None)
        else:
            if not isinstance(recs, list) or not recs:
                return None
            ing = getattr(recs[pos], "ingestion_time", None)
        if isinstance(ing, (int, float)) and ing > 0:
            return int(ing)
    except Exception:
        pass
    return None


class BulkReplay:
    """``run_bulk`` / ``run_multi_bulk`` of the range and kNN operators:
    their ``run`` / ``run_multi`` over a :class:`BulkStream` of a
    bulk-parsed stream. Pane mode applies where the JAX package's bulk
    path takes it (``bulk_panes``: the point-stream range operators and
    the point x point kNN; never under multiQuery)."""

    bulk_panes = False

    def run_bulk(self, parsed, *args, **kw) -> Iterator[WindowResult]:
        return self.run(BulkStream(parsed, panes=self.bulk_panes), *args,
                        **kw)

    def run_multi_bulk(self, parsed, *args, **kw
                       ) -> Iterator[WindowResult]:
        return self.run_multi(BulkStream(parsed, panes=False), *args, **kw)


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

    def _stack_query_masks(self, queries, radius: float,
                           which=("gn", "cn")):
        """The (Q, n*n) mask stacks named in ``which`` ("gn", "cn", "nb"),
        one row per query, in that order (the multi-query form of
        :meth:`_query_masks` and :meth:`_query_nb`; the geometry-stream
        rule takes gn and nb)."""
        rows = {k: [] for k in which}
        for q in queries:
            cells = self._query_cells(q)
            gn = (self.grid.guaranteed_cells_mask(radius, cells)
                  if "gn" in which or "cn" in which else None)
            if "gn" in which:
                rows["gn"].append(gn)
            if "cn" in which:
                rows["cn"].append(
                    self.grid.candidate_cells_mask(radius, cells, gn))
            if "nb" in which:
                rows["nb"].append(
                    self.grid.neighboring_cells_mask(radius, cells))
        return tuple(to_device(np.stack(rows[k]), np.bool_, self.device)
                     for k in which)

    def _stack_query_nb(self, queries, radius: float):
        """(Q, n*n) neighbouring-cells masks, one row per query (the
        multi-query form of :meth:`_query_nb`)."""
        return self._stack_query_masks(queries, radius, which=("nb",))[0]

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
