"""Structured telemetry (port of ``spatialflink_tpu.utils.telemetry``):
spans, streaming histograms, gauges, cell occupancy and cost, the event
ring, the per-window trace book, the shared status snapshot, the
Prometheus text and the reporter thread.

The registry's counters (:mod:`.metrics`) say how much work happened;
this layer says where the time went, all on the host and O(1) per
observation. Names and schemas are the JAX package's, so the two
packages' ``telemetry.jsonl``, ``metrics.prom``, ``trace.json`` and
post-mortem bundles compare key by key:

- :meth:`Telemetry.span` times one stage (count / total / max / self
  wall clock, nesting-aware per thread), family-scoped (``knn.kernel``),
  and is a ``torch.profiler.record_function`` range while a
  ``--profile`` capture runs (:func:`~.metrics.trace`);
- :class:`StreamingHistogram` (fixed log buckets, p50/p95/p99/max),
  :class:`Gauge`, :class:`CellOccupancy` (top cells, skew, top share,
  Gini over the grid cells the decode assigns; the session's observer on
  ``index.uniform_grid._CELL_OBSERVER``, fed host arrays only);
- :class:`EventRing` / :func:`emit_event`: lifecycle events (checkpoint
  committed / fallback / restored, repartition, recompile, ...), dropped
  for free without a session;
- :class:`WindowTraceBook`: per-window trace lineage (``--trace-dir``),
  exported as Chrome trace-event JSON;
- :class:`CostProfiles`: records and attributed kernel / merge wall clock
  per grid cell and per query family, with a bounded time series;
- :func:`status_snapshot` / :func:`status_digest`: the one "current
  pipeline state" document the reporter's JSONL lines, the post-mortem
  bundle and the ``--live-stats`` digest share.

Off by default: :func:`active` is None until :func:`telemetry_session` is
entered, and every instrumented loop checks it once per stream, so a run
without a session runs the code it ran before telemetry existed.

Unlike the JAX package, :class:`CostProfiles` grows its three per-cell
arrays as one tuple swapped in under its lock, so a second writer never
indexes a grown array beside one not yet grown.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import math
import os
import threading
import time
import uuid
from typing import Callable, Dict, List, Optional, Tuple

from spatialflink_tpu_torch.utils import metrics as _metrics
from spatialflink_tpu_torch.utils.metrics import trace


class SpanStats:
    """Aggregate wall-clock stats for one named stage."""

    __slots__ = ("name", "count", "total_s", "max_s", "self_s", "errors")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self.total_s = 0.0
        self.max_s = 0.0
        #: total minus time spent in CHILD spans (the nesting-aware part:
        #: an outer "window" span wrapping a "kernel" span reports how much
        #: of the window was NOT kernel)
        self.self_s = 0.0
        self.errors = 0

    def to_dict(self) -> dict:
        return {
            "count": self.count,
            "total_ms": round(self.total_s * 1e3, 3),
            "max_ms": round(self.max_s * 1e3, 3),
            "self_ms": round(self.self_s * 1e3, 3),
            "errors": self.errors,
        }


class _Span:
    """One span activation. Class-based (not a generator contextmanager) so
    a StopIteration raised INSIDE the block propagates normally — spans wrap
    ``next()`` calls on the window assembly path."""

    __slots__ = ("tel", "name", "t0", "child_s", "_trace")

    def __init__(self, tel: "Telemetry", name: str):
        self.tel = tel
        self.name = name
        self.child_s = 0.0

    def __enter__(self) -> "_Span":
        self._trace = trace(self.name)
        self._trace.__enter__()
        self.tel._stack().append(self)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, et, ev, tb) -> bool:
        dt = time.perf_counter() - self.t0
        stack = self.tel._stack()
        if stack and stack[-1] is self:
            stack.pop()
        if stack:
            stack[-1].child_s += dt
        st = self.tel._span_stats(self.name)
        st.count += 1
        st.total_s += dt
        st.self_s += max(0.0, dt - self.child_s)
        if dt > st.max_s:
            st.max_s = dt
        # StopIteration through a span is normal control flow (the span
        # times the pull from an exhausted iterator), not a stage failure
        if et is not None and et is not StopIteration:
            st.errors += 1
        self._trace.__exit__(et, ev, tb)
        return False


class StreamingHistogram:
    """Fixed log-bucket streaming histogram: O(1) per record, constant
    memory, percentiles by cumulative bucket walk.

    Bucket ``i >= 1`` covers ``[lo * growth**(i-1), lo * growth**i)``;
    bucket 0 is the underflow bucket (values <= lo, including zeros and
    negatives); the last bucket absorbs overflow. A percentile returns the
    geometric midpoint of its bucket clamped to the observed [min, max], so
    the relative error is bounded by ``sqrt(growth)`` (~4.4% at the default
    8-buckets-per-octave growth) — the Dropwizard-reservoir answer without
    sampling jitter or per-record allocation.
    """

    __slots__ = ("name", "lo", "growth", "_log_lo", "_log_g", "_nb",
                 "counts", "count", "total", "min", "max")

    def __init__(self, name: str = "", lo: float = 1e-3, hi: float = 1e7,
                 growth: float = 2.0 ** 0.125):
        if not (lo > 0 and hi > lo and growth > 1.0):
            raise ValueError("need 0 < lo < hi and growth > 1")
        self.name = name
        self.lo = lo
        self.growth = growth
        self._log_lo = math.log(lo)
        self._log_g = math.log(growth)
        self._nb = int(math.ceil((math.log(hi) - self._log_lo) / self._log_g))
        self.counts: List[int] = [0] * (self._nb + 2)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def record(self, value: float) -> None:
        self.count += 1
        self.total += value
        if value < self.min:
            self.min = value
        if value > self.max:
            self.max = value
        if value <= self.lo:
            idx = 0
        else:
            idx = int((math.log(value) - self._log_lo) / self._log_g) + 1
            if idx > self._nb + 1:
                idx = self._nb + 1
        self.counts[idx] += 1

    def _bucket_value(self, idx: int) -> float:
        if idx == 0:
            return self.min if self.min < math.inf else self.lo
        if idx == self._nb + 1:
            # overflow bucket: the midpoint would lie about anything past
            # hi; the observed max is the honest representative
            return self.max
        # geometric midpoint of the bucket
        return math.exp(self._log_lo + (idx - 0.5) * self._log_g)

    def percentile(self, p: float) -> float:
        if not self.count:
            return 0.0
        target = max(1, math.ceil(self.count * min(max(p, 0.0), 100.0) / 100.0))
        cum = 0
        for idx, n in enumerate(self.counts):
            cum += n
            if cum >= target:
                v = self._bucket_value(idx)
                return float(min(max(v, self.min), self.max))
        return float(self.max)  # pragma: no cover - cum always reaches count

    def to_dict(self) -> dict:
        if not self.count:
            return {"count": 0}
        return {
            "count": self.count,
            "sum": round(self.total, 3),
            "min": round(self.min, 3),
            "max": round(self.max, 3),
            "p50": round(self.percentile(50), 3),
            "p95": round(self.percentile(95), 3),
            "p99": round(self.percentile(99), 3),
        }


class Gauge:
    """Last-value gauge; construct with ``fn`` for pull-style gauges that
    are read at snapshot time."""

    __slots__ = ("name", "fn", "_value")

    def __init__(self, name: str, fn: Optional[Callable[[], float]] = None):
        self.name = name
        self.fn = fn
        self._value = 0.0

    def set(self, value: float) -> None:
        self._value = float(value)

    def get(self) -> float:
        if self.fn is not None:
            try:
                return float(self.fn())
            except Exception:
                return float("nan")
        return self._value


class CellOccupancy:
    """Grid-cell assignment counts: top-k hottest cells + skew (max/mean
    over occupied cells). Fed int arrays (or scalars) of cell ids; invalid
    cells (-1) are dropped. Vectorized bincount accumulation — cheap even
    on the 1M-point bulk ingest paths."""

    def __init__(self):
        import numpy as np

        self._np = np
        self._counts = np.zeros(0, dtype=np.int64)

    def _ensure(self, hi: int) -> None:
        if hi > self._counts.size:
            np = self._np
            grown = np.zeros(max(hi, 2 * self._counts.size), dtype=np.int64)
            grown[: self._counts.size] = self._counts
            self._counts = grown

    def record_scalar(self, ci: int) -> None:
        """One pre-validated cell id (>= 0): a bounds check + increment."""
        self._ensure(ci + 1)
        self._counts[ci] += 1

    def record_counts(self, hi: int, counts) -> None:
        """A pre-normalized bincount (valid cells only, length ``hi``)."""
        self._ensure(hi)
        self._counts[:hi] += counts

    def record(self, cells) -> None:
        # scalar fast path: the per-record streaming ingest assigns one
        # cell at a time — a single bounds check + increment, O(1), no
        # array construction (the vectorized branch below would cost
        # O(num_cells) per record and dwarf the parse it observes).
        # Telemetry.record_cells normalizes ONCE and calls the
        # record_scalar/record_counts halves directly so the cost-profile
        # twin shares the same pass; this entry serves direct callers.
        norm = normalize_cells(cells, self._np)
        if norm is None:
            return
        kind, a, b = norm
        if kind == "scalar":
            self.record_scalar(a)
        else:
            self.record_counts(a, b)

    def top_k(self, k: int = 8) -> List[Tuple[int, int]]:
        np = self._np
        nz = np.nonzero(self._counts)[0]
        if nz.size == 0:
            return []
        order = nz[np.argsort(self._counts[nz])[::-1][:k]]
        return [(int(c), int(self._counts[c])) for c in order]

    def skew(self) -> float:
        """max/mean over occupied cells; 1.0 = perfectly uniform."""
        np = self._np
        nz = self._counts[self._counts > 0]
        if nz.size == 0:
            return 0.0
        return float(nz.max() / nz.mean())

    def top_share(self) -> float:
        """The hottest cell's share of ALL recorded assignments — the
        skew-concentration number the repartition split threshold is
        compared against (``--adaptive-grid`` splits when an epoch share
        crosses ``split_share``), surfaced so the trigger is observable
        before it fires."""
        total = int(self._counts.sum())
        if total == 0:
            return 0.0
        return float(self._counts.max()) / total

    def gini(self) -> float:
        """Gini coefficient of the per-cell record distribution over
        OCCUPIED cells: 0 = perfectly uniform, ->1 = everything in one
        cell. Companion concentration gauge to :meth:`top_share` (top
        share sees only the single hottest cell; Gini sees the whole
        tail)."""
        np = self._np
        nz = np.sort(self._counts[self._counts > 0].astype(np.float64))
        m = nz.size
        if m == 0:
            return 0.0
        total = float(nz.sum())
        if total <= 0 or m == 1:
            return 0.0
        # standard mean-difference form over the sorted counts
        idx = np.arange(1, m + 1)
        return float((2.0 * (idx * nz).sum() / (m * total)) - (m + 1) / m)

    def to_dict(self, k: int = 8) -> dict:
        # read one copy: the decode thread keeps counting (and may swap in
        # a grown array) while the reporter or a scrape reads, and
        # np.nonzero over an array that changes under it raises
        view = CellOccupancy.__new__(CellOccupancy)
        view._np, view._counts = self._np, self._counts.copy()
        occ = int((view._counts > 0).sum())
        return {"occupied_cells": occ, "skew": round(view.skew(), 3),
                "top_share": round(view.top_share(), 4),
                "gini": round(view.gini(), 4),
                "top_cells": view.top_k(k)}


def normalize_cells(cells, np):
    """ONE normalization pass shared by the occupancy and cost-profile
    accumulators (both are fed by the same observer hook — doing the
    scalar check / ravel / negative filter / bincount twice would double
    the hot ingest path's observation cost): returns
    ``("scalar", cell_id, None)`` for a single valid cell,
    ``("counts", hi, bincount)`` for an array, or None when nothing valid
    remains."""
    if isinstance(cells, (int, np.integer)) or (
            isinstance(cells, np.ndarray) and cells.ndim == 0):
        ci = int(cells)
        return None if ci < 0 else ("scalar", ci, None)
    c = np.asarray(cells).ravel()
    c = c[c >= 0]
    if c.size == 0:
        return None
    hi = int(c.max()) + 1
    return ("counts", hi, np.bincount(c, minlength=hi).astype(np.int64))


class EventRing:
    """Bounded ring buffer of structured lifecycle events. Appends are
    O(1) and lock-guarded (emitters live on pipeline, reporter, and HTTP
    threads); ``list()`` copies so readers never hold the lock while
    serializing. ``total`` counts every event ever appended, including
    those the ring has since evicted.

    Every event carries a monotonic ``seq`` (1-based, assigned under the
    lock — ``total`` IS the last assigned seq) plus BOTH a wall-clock
    ``ts_ms`` and a steady ``mono_ms`` (``time.monotonic``) timestamp, so
    a wall-clock step (NTP, DST) cannot reorder the stream a poller
    reconstructs. ``list(since=seq)`` returns only events newer than
    ``seq`` — the ``/events?since=`` cursor that lets pollers stop
    re-reading (and re-alerting on) the whole ring every fetch."""

    def __init__(self, capacity: int = 256):
        from collections import deque

        self._ring = deque(maxlen=max(1, int(capacity)))
        self._lock = threading.Lock()
        self.total = 0

    def append(self, kind: str, **fields) -> dict:
        ev = {"ts_ms": int(time.time() * 1000),
              "mono_ms": round(time.monotonic() * 1e3, 3), "kind": kind}
        ev.update(fields)
        with self._lock:
            self.total += 1
            ev["seq"] = self.total
            self._ring.append(ev)
        return ev

    def list(self, since: Optional[int] = None) -> List[dict]:
        with self._lock:
            evs = list(self._ring)
        if since is not None:
            evs = [e for e in evs if e.get("seq", 0) > since]
        return evs


class WindowTraceBook:
    """Per-window trace lineage: one record per window, keyed by a STABLE
    trace id derived from ``(query, window_start)`` (re-deliveries and
    resumed runs land on the same id). Each record accumulates timestamped
    events as the window moves through the pipeline — ``ingest`` (the
    first record's ingestion wall clock), ``window`` (assembly pull),
    ``pane-seal`` (one per fresh pane kernel, pane mode), ``kernel``
    (dispatch), ``merge`` (readback), ``emit``, then the downstream
    ``sink`` / ``sink-commit`` stages (appended by window_start — the
    driver and Kafka sink don't know the family).

    Bounded: at most ``capacity`` traces are retained (oldest-started
    evicted first); ``total`` counts every trace ever started. All methods
    are lock-guarded and called at WINDOW granularity, never per record.
    :meth:`chrome_trace` renders the ring as Chrome trace-event JSON
    (the ``{"traceEvents": [...]}`` form), loadable in Perfetto /
    ``chrome://tracing`` — durations become ``"ph": "X"`` slices, instants
    ``"ph": "i"`` marks, one named track (tid) per query family."""

    def __init__(self, capacity: int = 256):
        from collections import OrderedDict

        self._traces: "OrderedDict[str, dict]" = OrderedDict()
        self._lock = threading.Lock()
        self.capacity = max(1, int(capacity))
        self.total = 0
        #: traces dropped by the capacity ring — overflow used to be
        #: silent, leaving "where did my lineage go?" unanswerable; the
        #: ``trace-evictions`` counter and /trace/recent's ``evicted``
        #: field now say exactly how much history fell off
        self.evicted = 0

    @staticmethod
    def trace_id(query: str, window_start) -> str:
        return f"{query}:{int(window_start)}"

    def _trace(self, query: str, window_start) -> dict:
        """Get-or-start (caller holds the lock)."""
        tid = self.trace_id(query, window_start)
        tr = self._traces.get(tid)
        if tr is None:
            tr = {"trace_id": tid, "query": query,
                  "window_start": int(window_start), "window_end": None,
                  "first_record_ms": None, "emitted_ms": None, "events": []}
            self._traces[tid] = tr
            self.total += 1
            while len(self._traces) > self.capacity:
                self._traces.popitem(last=False)
                self.evicted += 1
                _metrics.REGISTRY.counter("trace-evictions").inc()
        return tr

    def note(self, query: str, window_start, stage: str, t0_s: float,
             t1_s: Optional[float] = None, **fields) -> None:
        """Append one event; ``t0_s``/``t1_s`` are ``time.time()`` seconds
        (wall clock, so slices line up across threads and processes)."""
        ev = {"stage": stage, "ts_ms": round(t0_s * 1e3, 3)}
        if t1_s is not None:
            ev["dur_ms"] = round((t1_s - t0_s) * 1e3, 3)
        ev.update(fields)
        with self._lock:
            self._trace(query, window_start)["events"].append(ev)

    def first_record(self, query: str, window_start, ingest_ms) -> None:
        """Record the window's first-record ingest wall clock (once)."""
        with self._lock:
            tr = self._trace(query, window_start)
            if tr["first_record_ms"] is None:
                tr["first_record_ms"] = int(ingest_ms)
                tr["events"].insert(
                    0, {"stage": "ingest", "ts_ms": int(ingest_ms)})

    def seal(self, query: str, window_start, window_end) -> None:
        """The window was emitted by its operator: stamp bounds + an
        ``emit`` instant (later sink stages still append — the trace stays
        in the ring until evicted by capacity)."""
        now_ms = round(time.time() * 1e3, 3)
        with self._lock:
            tr = self._trace(query, window_start)
            tr["window_end"] = int(window_end)
            tr["emitted_ms"] = now_ms
            tr["events"].append({"stage": "emit", "ts_ms": now_ms})

    def note_any(self, window_start, stage: str, t0_s: float,
                 t1_s: Optional[float] = None, **fields) -> None:
        """Append an event to EVERY trace with this ``window_start`` — the
        downstream sink stages see a WindowResult, not a family label.
        O(ring) per emitted window, never per record."""
        ws = int(window_start)
        ev = {"stage": stage, "ts_ms": round(t0_s * 1e3, 3)}
        if t1_s is not None:
            ev["dur_ms"] = round((t1_s - t0_s) * 1e3, 3)
        ev.update(fields)
        with self._lock:
            for tr in self._traces.values():
                if tr["window_start"] == ws:
                    tr["events"].append(dict(ev))

    # ------------------------------ readers --------------------------- #

    def get(self, trace_id: str) -> Optional[dict]:
        with self._lock:
            tr = self._traces.get(trace_id)
            if tr is None:
                return None
            return {**tr, "events": [dict(e) for e in tr["events"]]}

    def recent(self, k: int = 32) -> List[dict]:
        """Newest-started ``k`` trace summaries (id, window, event count,
        emitted) — the ``/trace/recent`` index."""
        with self._lock:
            traces = list(self._traces.values())[-max(0, int(k)):]
            return [{"trace_id": t["trace_id"], "query": t["query"],
                     "window_start": t["window_start"],
                     "window_end": t["window_end"],
                     "emitted_ms": t["emitted_ms"],
                     "events": len(t["events"])} for t in reversed(traces)]

    def chrome_trace(self) -> dict:
        """The ring as a Chrome trace-event document (Perfetto-loadable)."""
        events: List[dict] = []
        tids: Dict[str, int] = {}
        with self._lock:
            traces = [
                {**t, "events": [dict(e) for e in t["events"]]}
                for t in self._traces.values()
            ]
        for tr in traces:
            tid = tids.setdefault(tr["query"], len(tids) + 1)
            for ev in tr["events"]:
                args = {k: v for k, v in ev.items()
                        if k not in ("stage", "ts_ms", "dur_ms")}
                args["trace_id"] = tr["trace_id"]
                base = {"name": ev["stage"], "cat": tr["query"],
                        "ts": round(ev["ts_ms"] * 1e3, 1), "pid": 1,
                        "tid": tid, "args": args}
                if "dur_ms" in ev:
                    events.append({**base, "ph": "X",
                                   "dur": max(1.0, round(ev["dur_ms"] * 1e3,
                                                         1))})
                else:
                    events.append({**base, "ph": "i", "s": "t"})
        for query, tid in tids.items():
            events.append({"name": "thread_name", "ph": "M", "pid": 1,
                           "tid": tid, "args": {"name": query}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def export_chrome(self, path: str) -> str:
        """Write :meth:`chrome_trace` to ``path`` (atomic tmp+rename, like
        the Prometheus dump — a viewer must never load a torn file)."""
        doc = self.chrome_trace()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f)
        os.replace(tmp, path)
        return path


class CostProfiles:
    """Per-grid-cell and per-query-family COST accumulators — the
    where-does-the-time-go / who-pays complement to :class:`CellOccupancy`
    (which only counts). Fed at two grains:

    - per record (via :meth:`Telemetry.record_cells`, i.e. the existing
      ``UniformGrid.assign_cell`` observer hook): per-cell records-in,
      plus a PENDING bucket of cells seen since the last kernel dispatch;
    - per window (from the family-labeled spans in ``operators/base.py``):
      kernel/merge wall-clock, records, approximate bytes moved, and
      pane-cache hits/misses per family — and the pending cell bucket is
      folded into per-cell ``cost_ms`` proportionally (at steady state the
      records that arrived since the previous dispatch are the new slide
      of data, so each cell's share of fresh records is its share of the
      kernel it triggered). This is ATTRIBUTION, not measurement — the
      kernel runs on the whole window — but it is exactly the signal
      skew-aware balancing needs: a hot cell's records make every window
      containing them expensive, and its attributed cost ratchets
      accordingly.

    :meth:`tick` (called by the reporter once per interval) appends a
    delta bucket to a bounded ``series`` deque, so ``/profile/cells``
    serves a windowed time series of skew cost, not just a cumulative
    total."""

    def __init__(self, series_capacity: int = 128,
                 tick_interval_s: float = 5.0):
        import numpy as np

        self._np = np
        #: (records, cost_ms, pending) per cell, grown together: one tuple
        #: swapped in under the lock, so a writer that reads it once never
        #: sees a grown array beside one not yet grown
        self._arrays = (np.zeros(0, dtype=np.int64),
                        np.zeros(0, dtype=np.float64),
                        np.zeros(0, dtype=np.int64))
        self._pending_total = 0
        self._cost_at_tick = np.zeros(0, dtype=np.float64)
        self.families: Dict[str, dict] = {}
        from collections import deque

        self.series = deque(maxlen=max(1, int(series_capacity)))
        #: minimum spacing between :meth:`maybe_tick` buckets — the
        #: session's snapshot interval (telemetry_session sets it)
        self.tick_interval_s = max(0.01, float(tick_interval_s))
        self._last_tick_s = time.time()
        self._lock = threading.Lock()

    @property
    def _records(self):
        return self._arrays[0]

    @property
    def _cost_ms(self):
        return self._arrays[1]

    @property
    def _pending(self):
        return self._arrays[2]

    def _ensure(self, hi: int) -> tuple:
        """The arrays, at least ``hi`` long. A grow copies all three under
        the lock and publishes them as one tuple."""
        arrs = self._arrays
        if hi <= arrs[0].size:
            return arrs
        np = self._np
        with self._lock:
            arrs = self._arrays
            if hi > arrs[0].size:
                size = max(hi, 2 * arrs[0].size)
                grown = []
                for old in arrs:
                    g = np.zeros(size, dtype=old.dtype)
                    g[: old.size] = old
                    grown.append(g)
                arrs = self._arrays = tuple(grown)
        return arrs

    def record_scalar(self, ci: int) -> None:
        """One pre-validated cell id — the per-record ingest twin of
        :meth:`CellOccupancy.record_scalar`. Lock-free on the single
        writer (the pipeline thread records cells); only a grow takes the
        lock."""
        records, _, pending = self._ensure(ci + 1)
        records[ci] += 1
        pending[ci] += 1
        self._pending_total += 1

    def record_counts(self, hi: int, counts, n: int) -> None:
        """A pre-normalized bincount (``n`` = total valid records).
        Lock-free for the same reason as :meth:`record_scalar`."""
        records, _, pending = self._ensure(hi)
        records[:hi] += counts
        pending[:hi] += counts
        self._pending_total += n

    def record_cells(self, cells) -> None:
        """Normalizing entry for direct callers; the session observer
        (:meth:`Telemetry.record_cells`) normalizes ONCE and feeds the
        scalar/counts halves of both accumulators instead."""
        norm = normalize_cells(cells, self._np)
        if norm is None:
            return
        kind, a, b = norm
        if kind == "scalar":
            self.record_scalar(a)
        else:
            self.record_counts(a, b, int(b.sum()))

    def family(self, label: str) -> dict:
        f = self.families.get(label)
        if f is None:
            with self._lock:
                f = self.families.setdefault(label, {
                    "records_in": 0, "windows": 0, "kernel_ms": 0.0,
                    "merge_ms": 0.0, "pane_hits": 0, "pane_misses": 0,
                    "bytes_moved": 0})
        return f

    def attribute_kernel(self, label: str, dt_s: float, records: int = 0,
                         nbytes: int = 0) -> None:
        """One window's kernel dispatch: bump the family profile and fold
        the pending cell bucket into per-cell cost (proportional split of
        ``dt_s`` over the cells of records that arrived since the last
        dispatch; an all-cached window — no fresh records — attributes
        nothing, which is honest: it cost no new kernel work per cell)."""
        dt_ms = dt_s * 1e3
        f = self.family(label)
        with self._lock:
            f["windows"] += 1
            f["records_in"] += int(records)
            f["kernel_ms"] += dt_ms
            f["bytes_moved"] += int(nbytes)
            if self._pending_total:
                _, cost_ms, pending = self._arrays
                n = pending.size
                cost_ms[:n] += pending * (dt_ms / self._pending_total)
                pending[:] = 0
                self._pending_total = 0

    def attribute_merge(self, label: str, dt_s: float) -> None:
        f = self.family(label)
        with self._lock:
            f["merge_ms"] += dt_s * 1e3

    def note_readback(self, label: str, nbytes: int) -> None:
        """Device→host bytes actually read back for one window's pane merge
        (host-merged: the partials resolved this window; device-merged: the
        merged result only) — folded into the family's ``bytes_moved`` so
        the cost profile reflects real data motion on the pane path."""
        f = self.family(label)
        with self._lock:
            f["bytes_moved"] += int(nbytes)

    def note_pane(self, label: str, hits: int, misses: int) -> None:
        f = self.family(label)
        with self._lock:
            f["pane_hits"] += int(hits)
            f["pane_misses"] += int(misses)

    def cell_costs(self, size: int):
        """Per-cell cumulative attributed kernel cost (ms), zero-padded /
        truncated to ``size`` — the repartition controller's cost signal
        (``runtime.repartition``). A copy; callers may normalize freely."""
        np = self._np
        out = np.zeros(size, np.float64)
        n = min(size, self._cost_ms.size)
        out[:n] = self._cost_ms[:n]
        return out

    def top_cost_cells(self, k: int = 8, cost=None) -> List[list]:
        """``[cell, cost_ms, records]`` rows, costliest first."""
        np = self._np
        cost = cost if cost is not None else self._cost_ms
        nz = np.nonzero(cost > 0)[0]
        if nz.size == 0:
            return []
        order = nz[np.argsort(cost[nz])[::-1][:k]]
        return [[int(c), round(float(cost[c]), 3),
                 int(self._records[c]) if c < self._records.size else 0]
                for c in order]

    def maybe_tick(self) -> None:
        """Close a bucket only when ``tick_interval_s`` elapsed since the
        last one — safe to call from every periodic/read path (reporter
        snapshot, ``/profile/cells`` scrape) without double-bucketing."""
        if time.time() - self._last_tick_s >= self.tick_interval_s:
            self.tick()

    def tick(self) -> dict:
        """Close one time-series bucket: per-cell cost DELTA since the
        previous tick (top-k) plus the delta's total. Bounded by the
        series deque."""
        np = self._np
        with self._lock:
            self._last_tick_s = time.time()
            cur = self._cost_ms
            prev = self._cost_at_tick
            if prev.size < cur.size:
                grown = np.zeros(cur.size, dtype=np.float64)
                grown[: prev.size] = prev
                prev = grown
            delta = cur - prev[: cur.size]
            self._cost_at_tick = cur.copy()
        bucket = {"ts_ms": int(time.time() * 1000),
                  "kernel_ms": round(float(delta.sum()), 3),
                  "top_cells": self.top_cost_cells(8, cost=delta)}
        self.series.append(bucket)
        return bucket

    def _families_dict(self) -> dict:
        with self._lock:
            return {
                label: {k: (round(v, 3) if isinstance(v, float) else v)
                        for k, v in f.items()}
                for label, f in self.families.items()
            }

    def to_dict(self, k: int = 8) -> dict:
        """The compact form embedded in every snapshot."""
        return {
            "top_cost_cells": self.top_cost_cells(k),
            "total_kernel_ms": round(
                float(self._cost_ms.sum()), 3),
            "families": self._families_dict(),
            "series_len": len(self.series),
        }

    def cells_payload(self, k: int = 64) -> dict:
        """The full ``/profile/cells`` document: top-k per-cell rows with
        cost shares, the per-family table, and the windowed time series.
        Scrape-driven ticking (Prometheus-style): in a reporterless
        session (``--trace-dir``/``--status-port`` without
        ``--telemetry-dir``) the series still advances, one bucket per
        ``tick_interval_s`` of being read."""
        self.maybe_tick()
        total = float(self._cost_ms.sum())
        cells = [{"cell": c, "records": n, "cost_ms": cost,
                  "cost_share": round(cost / total, 4) if total else 0.0}
                 for c, cost, n in self.top_cost_cells(k)]
        return {"ts_ms": int(time.time() * 1000), "cells": cells,
                "total_kernel_ms": round(total, 3),
                "occupied_cells": int((self._records > 0).sum()),
                "families": self._families_dict(),
                "series": list(self.series)}


class Telemetry:
    """One session's span/histogram/gauge/occupancy state.

    ``registry`` pins the metrics registry whose counters ride the
    snapshots; None reads the ambient :data:`~.metrics.REGISTRY` at
    snapshot time (so :func:`~.metrics.scoped_registry` composes).
    Mutations on the hot path are single attribute bumps under the GIL;
    only entry creation and snapshotting take the lock, so a reporter
    thread reading mid-window sees a consistent-enough view (telemetry,
    not accounting).
    """

    def __init__(self, registry: Optional[_metrics.MetricsRegistry] = None,
                 trace: bool = False):
        self.registry = registry
        self.spans: Dict[str, SpanStats] = {}
        self.histograms: Dict[str, StreamingHistogram] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.cells = CellOccupancy()
        self.costs = CostProfiles()
        #: latency-decomposition plane (stage-residency budgets, record→
        #: emit histograms, backpressure timeline — utils.latencyplane);
        #: fed at WINDOW/tick granularity only, so it rides every session
        #: like the cost profiles do
        from spatialflink_tpu_torch.utils.latencyplane import LatencyPlane

        self.latency = LatencyPlane()
        #: per-query/per-tenant cost ledger (utils.accounting): the
        #: shared padded-fleet dispatch attributed to who asked for it;
        #: fed at dispatch/window granularity only, so it rides every
        #: session like the cost profiles do
        from spatialflink_tpu_torch.utils.accounting import TenantLedger

        self.tenants = TenantLedger()
        #: per-window trace lineage — OPT-IN (``trace=True`` /
        #: ``--trace-dir``): None keeps the plain session's hot-path cost
        #: exactly what it was without tracing; instrumented sites check this
        #: once per stream/loop like everything else
        self.traces: Optional[WindowTraceBook] = (
            WindowTraceBook() if trace else None)
        self.events = EventRing()
        #: optional runtime.health.HealthEvaluator attached by the driver
        #: (--slo): status_snapshot() stamps its verdict into every
        #: snapshot this session emits
        self.health = None
        #: the run's device (``--device``): the device block's platform
        #: and memory probes read it (None: CUDA when present)
        self.device = None
        self.started_at = time.time()
        self._lock = threading.Lock()
        self._tls = threading.local()

    def event(self, kind: str, **fields) -> None:
        """Record one structured lifecycle event (see :class:`EventRing`).
        Emitters are stage boundaries (checkpoint commits, breaker
        transitions, quarantines), never per-record paths."""
        self.events.append(kind, **fields)

    # ------------------------------ spans ---------------------------- #

    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _span_stats(self, name: str) -> SpanStats:
        st = self.spans.get(name)
        if st is None:
            with self._lock:
                st = self.spans.setdefault(name, SpanStats(name))
        return st

    def span(self, stage: str, query: Optional[str] = None) -> _Span:
        """Context manager timing one activation of ``stage``; ``query``
        scopes the stage name (``knn.kernel``) so families/queries stay
        separable. Exceptions propagate (and bump ``errors``)."""
        return _Span(self, f"{query}.{stage}" if query else stage)

    def observe(self, stage: str, dt_s: float,
                query: Optional[str] = None) -> None:
        """Record one pre-timed observation — the per-record loops use this
        instead of a context manager (no object churn on the ingest path)."""
        st = self._span_stats(f"{query}.{stage}" if query else stage)
        st.count += 1
        st.total_s += dt_s
        st.self_s += dt_s
        if dt_s > st.max_s:
            st.max_s = dt_s

    # --------------------------- histograms/gauges -------------------- #

    def histogram(self, name: str, **kw) -> StreamingHistogram:
        h = self.histograms.get(name)
        if h is None:
            with self._lock:
                h = self.histograms.setdefault(
                    name, StreamingHistogram(name, **kw))
        return h

    def gauge(self, name: str,
              fn: Optional[Callable[[], float]] = None) -> Gauge:
        g = self.gauges.get(name)
        if g is None:
            with self._lock:
                g = self.gauges.setdefault(name, Gauge(name, fn))
        elif fn is not None and g.fn is None:
            g.fn = fn
        return g

    def record_cells(self, cells) -> None:
        # ONE normalization (scalar check / filter / bincount) feeding
        # both accumulators — this is the per-record observer hook, so the
        # pass must not be paid twice
        norm = normalize_cells(cells, self.cells._np)
        if norm is None:
            return
        kind, a, b = norm
        if kind == "scalar":
            self.cells.record_scalar(a)
            self.costs.record_scalar(a)
        else:
            self.cells.record_counts(a, b)
            self.costs.record_counts(a, b, int(b.sum()))

    # ------------------------------ snapshot -------------------------- #

    def _registry(self) -> _metrics.MetricsRegistry:
        return self.registry if self.registry is not None else _metrics.REGISTRY

    def snapshot(self) -> dict:
        """One JSON-safe snapshot: stage spans, histogram percentiles,
        gauges, the registry's counters/meters, the degradation digest
        (the retry/breaker/DLQ/chaos counters — same stream, same
        timestamp, correlation for free), grid occupancy, and the device
        block (backend provenance, compile/recompile counters, memory
        gauges — ``utils.deviceplane``; the probe runs once per snapshot,
        never per record)."""
        from spatialflink_tpu_torch.utils import deviceplane as _deviceplane

        reg = self._registry()
        # close a backpressure bucket at most once per tick interval —
        # whoever snapshots first (reporter, /status, digest) drives it
        self.latency.maybe_tick(self)
        with self._lock:
            spans = {n: s.to_dict() for n, s in self.spans.items()}
            hists = {n: h.to_dict() for n, h in self.histograms.items()}
            gauges = {n: g.get() for n, g in self.gauges.items()}
        return {
            "ts_ms": int(time.time() * 1000),
            "uptime_s": round(time.time() - self.started_at, 3),
            "spans": spans,
            "histograms": hists,
            "gauges": gauges,
            "counters": reg.snapshot(),
            "degradation": _metrics.degradation_snapshot(reg),
            "grid": self.cells.to_dict(),
            "costs": self.costs.to_dict(),
            "latency": self.latency.to_dict(),
            "tenants": self.tenants.to_dict(),
            "device": _deviceplane.status_block(self, self._registry()),
            "traces": {
                "enabled": self.traces is not None,
                "total": self.traces.total if self.traces is not None else 0,
                "evicted": (self.traces.evicted
                            if self.traces is not None else 0),
            },
        }


# --------------------------------------------------------------------- #
# the active session (module-global, like metrics.REGISTRY)

_ACTIVE: Optional[Telemetry] = None
_NULL_CM = contextlib.nullcontext()

#: this process incarnation's identity + the monotonic snapshot counter
#: — stamped into every status_snapshot() so federated collectors can
#: order and dedupe worker snapshots (a restarted worker gets a fresh
#: run_id, so its seq restart reads as "new incarnation", never "stale")
_RUN_ID = uuid.uuid4().hex[:12]
_SNAP_SEQ = itertools.count(1)


def active() -> Optional[Telemetry]:
    """The active session's :class:`Telemetry`, or None when telemetry is
    off. Hot paths call this ONCE per stream/loop and branch to the
    uninstrumented code when it is None."""
    return _ACTIVE


def set_active(tel: Optional[Telemetry]) -> Optional[Telemetry]:
    global _ACTIVE
    old = _ACTIVE
    _ACTIVE = tel
    return old


def span(stage: str, query: Optional[str] = None):
    """Module-level convenience for call-once sites (stage boundaries, CLI
    plumbing): a real span when a session is active, a shared nullcontext
    otherwise. Per-record loops should capture :func:`active` instead."""
    tel = _ACTIVE
    return tel.span(stage, query) if tel is not None else _NULL_CM


def emit_event(kind: str, **fields) -> None:
    """Append a lifecycle event to the active session's ring; a no-op when
    telemetry is off (one attribute read — safe at stage boundaries even
    in uninstrumented runs)."""
    tel = _ACTIVE
    if tel is not None:
        tel.event(kind, **fields)


# --------------------------------------------------------------------- #
# the shared "current pipeline state" snapshot (reporter JSONL lines, the
# status server's /status, and the --live-stats stderr digest all render
# exactly this — one schema definition)

#: chain-stage membership for the dominant-stage digest (downstream sink
#: stages run after emit and must not win the "where did record→emit go"
#: headline)
CHAIN_STAGES_SET = frozenset(
    ("buffer", "queue", "dispatch", "inflight", "merge", "emit"))


def _hist_digest(hists: dict, name: str) -> dict:
    h = hists.get(name)
    if not h or not h.get("count"):
        return {"count": 0}
    return {k: h.get(k) for k in ("count", "p50", "p95", "p99", "max")}


def status_digest(snap: dict) -> dict:
    """Derive the compact operator view from a raw snapshot dict: the
    numbers an operator reads FIRST, by name, instead of fishing them out
    of the spans/histograms/gauges/counters maps. Keys are stable schema
    (shared with the JAX package's digest); absent instruments render as
    None / zero-count, never as missing keys."""
    counters = snap.get("counters") or {}
    gauges = snap.get("gauges") or {}
    hists = snap.get("histograms") or {}
    grid = snap.get("grid") or {}
    hits = int(counters.get("pane-cache-hits", 0))
    misses = int(counters.get("pane-cache-misses", 0))
    return {
        "records_in": int(counters.get("ingest-throughput.count", 0)),
        "throughput_rps": round(
            float(counters.get("ingest-throughput.rate", 0.0)), 3),
        "windows_evaluated": int(counters.get("batches-evaluated", 0)),
        "record_latency_ms": _hist_digest(hists, "record-latency-ms"),
        "window_latency_ms": _hist_digest(hists, "window-latency-ms"),
        "watermark_lag_ms": gauges.get("kafka.watermark-lag-ms"),
        "commit_backlog": gauges.get("kafka.commit-backlog"),
        "window_backlog": gauges.get("window-backlog"),
        "pane_cache": {
            "hits": hits, "misses": misses,
            "hit_rate": (round(hits / (hits + misses), 4)
                         if hits + misses else None),
        },
        "checkpoint": {
            "seq": gauges.get("checkpoint.seq"),
            "age_s": (round(gauges["checkpoint.age-s"], 3)
                      if "checkpoint.age-s" in gauges else None),
            "written": int(counters.get("checkpoints-written", 0)),
            "replay_depth": gauges.get("recovery.replay-depth"),
            "write_ms": _hist_digest(hists, "checkpoint-write-ms"),
            "size_bytes": _hist_digest(hists, "checkpoint-size-bytes"),
        },
        "breaker_state": gauges.get("broker.breaker-state"),
        "dlq_depth": int(counters.get("dlq-records", 0)),
        "mesh_degradations": int(counters.get("mesh-degradations", 0)),
        "slo_breaches": int(counters.get("slo-breaches", 0)),
        "top_cells": grid.get("top_cells", []),
        # skew-concentration gauges (CellOccupancy): top-cell record share
        # and Gini over occupied cells — what the --adaptive-grid
        # repartition trigger compares its split threshold against, so the
        # threshold is observable BEFORE it fires
        "skew": {
            "factor": grid.get("skew"),
            "top_share": grid.get("top_share"),
            "gini": grid.get("gini"),
        },
        # [[cell, attributed_kernel_ms, records], ...] — skew COST, the
        # companion to top_cells' occupancy counts (CostProfiles)
        "top_cost_cells": (snap.get("costs") or {}).get(
            "top_cost_cells", []),
        # device truth (utils.deviceplane): backend provenance, compile/
        # recompile counters, memory gauges — the --slo recompiles=/
        # device_mem_bytes= checks and the stderr digest read these
        "device": snap.get("device") or {},
        # per-window dispatch→ready vs wall-clock overlap: 1.0 = the whole
        # device round-trip was hidden behind host work (the
        # pipeline_depth payoff)
        "dispatch_overlap": _hist_digest(hists, "dispatch-overlap-ratio"),
        # latency decomposition (utils.latencyplane): record→emit
        # percentiles, the stage whose residency dominates, and the
        # freshest backpressure annotations — the full table lives at
        # GET /latency
        "latency": _latency_digest(snap.get("latency") or {}),
        # closed-loop chunk governor (runtime.control): the live actuator
        # value + step/shed totals, derived from the exported gauges/
        # counters so federated cross-process digests carry it too; the
        # full decision tail is the controller block on GET /latency.
        # chunk=None = no governor installed in this run.
        "controller": {
            "chunk": (int(gauges["decode.chunk"])
                      if gauges.get("decode.chunk") is not None else None),
            "fast_lane": bool(gauges.get("decode.fast-lane")),
            "shedding": bool(gauges.get("controller.shedding")),
            "grows": int(counters.get("chunk-grow", 0)),
            "shrinks": int(counters.get("chunk-shrink", 0)),
            "sheds": int(counters.get("shed", 0)),
        },
        # tenant accounting (utils.accounting): who pays for the shared
        # dispatch — tenant count, top payer by attributed kernel-ms,
        # the fairness shares + Gini, and the attribution residual;
        # the full per-tenant table lives at GET /tenants
        "tenants": _tenants_digest(snap.get("tenants") or {}),
    }


def _tenants_digest(ten: dict) -> dict:
    """The compact operator view of the tenant ledger's snapshot block.
    Absent plane (no session) renders zero-count, never missing keys."""
    fairness = ten.get("fairness") or {}
    return {
        "n": int(ten.get("n") or 0),
        "top": fairness.get("top"),
        "top_share": fairness.get("top_share", 0.0),
        "max_share": fairness.get("max_share", 0.0),
        "min_share": fairness.get("min_share", 0.0),
        "gini": fairness.get("gini", 0.0),
        "quota_rejections": sum(
            int((r or {}).get("quota_rejections") or 0)
            for r in (ten.get("tenants") or {}).values()),
        "max_residual_ms": ten.get("max_residual_ms", 0.0),
    }


def _latency_digest(lat: dict) -> dict:
    """The compact operator view of the latency plane's snapshot block:
    record→emit percentiles, the dominant stage by total residency, and
    the last backpressure bucket's stall/residency signals. Absent plane
    (no session) renders zero-count, never missing keys."""
    re_h = lat.get("record_emit") or {}
    stages = lat.get("stages") or {}
    dominant = None
    if stages:
        totals = {s: (h.get("sum") or 0.0) for s, h in stages.items()
                  if s in CHAIN_STAGES_SET}
        if any(totals.values()):
            dominant = max(totals, key=totals.get)
    bp = (lat.get("backpressure") or {}).get("last") or {}
    return {
        "record_emit_ms": ({k: re_h.get(k) for k in
                            ("count", "p50", "p95", "p99", "max")}
                           if re_h.get("count") else {"count": 0}),
        "dominant_stage": dominant,
        "stall": bp.get("stall"),
        "backlog_residency_ms": bp.get("backlog_residency_ms"),
    }


def registry_snapshot(registry: Optional[_metrics.MetricsRegistry] = None
                      ) -> dict:
    """A snapshot with the raw-snapshot SHAPE built from the always-on
    metrics registry alone — what a bare ``--status-port`` run (no
    telemetry session) serves. Spans/histograms/gauges are empty by
    construction: populating them needs the per-record instrumentation a
    session activates, and the no-session contract is a byte-identical
    record loop. The device block IS present — backend provenance and the
    compile registry are process truth, not session instrumentation, and
    this snapshot is only ever built on demand (per request), never per
    record."""
    from spatialflink_tpu_torch.utils import deviceplane as _deviceplane

    reg = registry if registry is not None else _metrics.REGISTRY
    return {
        "ts_ms": int(time.time() * 1000),
        "uptime_s": None,
        "spans": {},
        "histograms": {},
        "gauges": {},
        "counters": reg.snapshot(),
        "degradation": _metrics.degradation_snapshot(reg),
        "grid": {},
        "costs": {},
        "latency": {},
        "tenants": {},
        "device": _deviceplane.status_block(None, reg),
        "traces": {"enabled": False, "total": 0, "evicted": 0},
    }


def status_snapshot(tel: Optional[Telemetry] = None, health=None,
                    registry: Optional[_metrics.MetricsRegistry] = None
                    ) -> dict:
    """One full "current pipeline state" document: the raw snapshot (or
    the registry-only fallback), the derived ``status`` digest, and —
    when an SLO evaluator is attached (explicitly or on the session) —
    the ``health`` verdict. Built ON DEMAND only: per HTTP request, per
    reporter interval, per digest line; never per record."""
    tel = tel if tel is not None else _ACTIVE
    snap = tel.snapshot() if tel is not None else registry_snapshot(registry)
    # provenance + ordering stamp for federated collectors: run_id pins
    # the emitting process incarnation, snapshot_seq orders snapshots
    # WITHIN it — a poller (FleetMonitor, /fleet/tenants harvesting)
    # drops any snapshot whose (run_id, seq) it has already seen, and a
    # changed run_id (restart) resets the ordering instead of wedging it
    snap["run_id"] = _RUN_ID
    snap["snapshot_seq"] = next(_SNAP_SEQ)
    snap["status"] = status_digest(snap)
    if health is None and tel is not None:
        health = tel.health
    if health is not None:
        # evaluated AFTER the digest so checks read the same numbers the
        # operator sees; breach transitions count in the SAME registry the
        # snapshot was built from (a pinned/scoped registry must see its
        # own slo-breaches), landing in the NEXT snapshot's status
        reg = (tel._registry() if tel is not None
               else registry if registry is not None else _metrics.REGISTRY)
        snap["health"] = health.evaluate(snap, registry=reg)
    return snap


# --------------------------------------------------------------------- #
# reporter

def prometheus_text(tel: Optional[Telemetry] = None,
                    registry: Optional[_metrics.MetricsRegistry] = None
                    ) -> str:
    """Prometheus text exposition of a session: spans as count/total/max
    seconds, histograms as count/sum plus p50/p95/p99 quantile gauges,
    gauges and registry counters as-is. Metric names are fixed; the
    span/histogram/counter name rides a label (dots and dashes are legal
    in label VALUES, so the query-scoped names survive unmangled).
    Query-family-scoped spans and histograms (``knn.kernel``) split into
    PROPER labels — ``stage="kernel",family="knn"`` — instead of a
    flattened combined value, so live scrapes can aggregate a stage
    across families (``sum by (stage)``) or a family across stages
    without regex label surgery; unscoped names render as ``stage="..."``
    / ``name="..."`` with no family label.
    ``tel=None`` renders the registry-only view (counter families only) —
    the no-session ``/metrics`` endpoint. Rendered live by both the
    reporter (every snapshot rewrites ``metrics.prom``) and the status
    server's ``/metrics`` — one renderer, two transports."""
    lines: List[str] = []

    def emit(metric: str, mtype: str, rows: List[Tuple[str, float]]):
        lines.append(f"# TYPE {metric} {mtype}")
        for labels, v in rows:
            lines.append(f"{metric}{{{labels}}} {v}")

    def span_labels(name: str) -> str:
        family, sep, stage = name.rpartition(".")
        if sep:
            return f'stage="{stage}",family="{family}"'
        return f'stage="{name}"'

    def hist_labels(name: str, extra: str = "") -> str:
        # per-query instruments ride a '<base>@<query-id>' naming
        # convention (the standing-query plane's counters/histograms):
        # split into a PROPER query="<id>" label — the same treatment the
        # family-scoped '<family>.<base>' names get — so scrapes can
        # aggregate across the fleet (sum by (name)) or follow one query
        base, qsep, qid = name.partition("@")
        family, sep, leaf = base.rpartition(".")
        lab = (f'name="{leaf}",family="{family}"' if sep
               else f'name="{base}"')
        if qsep:
            lab += f',query="{qid}"'
        return lab + extra

    def counter_labels(name: str) -> str:
        base, qsep, qid = name.partition("@")
        if qsep:
            return f'name="{base}",query="{qid}"'
        return f'name="{name}"'

    if tel is None:
        reg = registry if registry is not None else _metrics.REGISTRY
        emit("spatialflink_counter", "counter",
             [(counter_labels(n), v)
              for n, v in sorted(reg.snapshot().items())])
        return "\n".join(lines) + "\n"

    snap_reg = tel._registry()
    with tel._lock:
        spans = dict(tel.spans)
        hists = dict(tel.histograms)
        gauges = dict(tel.gauges)
    emit("spatialflink_span_count", "counter",
         [(span_labels(n), s.count) for n, s in sorted(spans.items())])
    emit("spatialflink_span_seconds_total", "counter",
         [(span_labels(n), round(s.total_s, 6))
          for n, s in sorted(spans.items())])
    emit("spatialflink_span_seconds_max", "gauge",
         [(span_labels(n), round(s.max_s, 6))
          for n, s in sorted(spans.items())])
    emit("spatialflink_histogram_count", "counter",
         [(hist_labels(n), h.count) for n, h in sorted(hists.items())])
    emit("spatialflink_histogram_sum", "counter",
         [(hist_labels(n), round(h.total, 6))
          for n, h in sorted(hists.items())])
    qrows = []
    for n, h in sorted(hists.items()):
        for q in (50, 95, 99):
            qrows.append((hist_labels(n, f',quantile="0.{q}"'),
                          round(h.percentile(q), 6)))
    emit("spatialflink_histogram_quantile", "gauge", qrows)
    emit("spatialflink_gauge", "gauge",
         [(counter_labels(n), g.get()) for n, g in sorted(gauges.items())])
    emit("spatialflink_counter", "counter",
         [(counter_labels(n), v)
          for n, v in sorted(snap_reg.snapshot().items())])
    # tenant accounting families (utils.accounting): the attributed-cost
    # ledger under PROPER tenant="T" labels — the same label discipline
    # as stage/family/query, so /fleet/metrics relabeling federates them
    ten = tel.tenants.to_dict()
    trows = sorted((ten.get("tenants") or {}).items())
    emit("spatialflink_tenant_kernel_ms_total", "counter",
         [(f'tenant="{t}"', r.get("kernel_ms", 0.0)) for t, r in trows])
    emit("spatialflink_tenant_bytes_moved_total", "counter",
         [(f'tenant="{t}"', r.get("bytes_moved", 0)) for t, r in trows])
    emit("spatialflink_tenant_records_in_total", "counter",
         [(f'tenant="{t}"', r.get("records_in", 0)) for t, r in trows])
    emit("spatialflink_tenant_records_out_total", "counter",
         [(f'tenant="{t}"', r.get("records_out", 0)) for t, r in trows])
    emit("spatialflink_tenant_windows_total", "counter",
         [(f'tenant="{t}"', r.get("windows", 0)) for t, r in trows])
    emit("spatialflink_tenant_slo_breaches_total", "counter",
         [(f'tenant="{t}"', r.get("slo_breaches", 0)) for t, r in trows])
    emit("spatialflink_tenant_quota_rejections_total", "counter",
         [(f'tenant="{t}"', r.get("quota_rejections", 0))
          for t, r in trows])
    fairness = ten.get("fairness") or {}
    emit("spatialflink_tenant_fairness_gini", "gauge",
         [("", fairness.get("gini", 0.0))] if trows else [])
    return "\n".join(lines) + "\n"


def relabel_prometheus_lines(text: str, label: str, value: str) -> str:
    """Prepend ``label="value"`` to every sample line of a Prometheus
    text exposition; ``#`` comment/TYPE lines and blanks pass through
    unchanged. The fleet supervisor's ``/fleet/metrics`` federation uses
    this to pin ``worker="wN"`` onto each worker's scraped ``/metrics``
    body — the same proper-label discipline :func:`prometheus_text`
    applies to stage/family/query names, so one fleet scrape point can
    still ``sum by (stage)`` across workers."""
    pin = f'{label}="{value}"'
    out: List[str] = []
    for line in text.splitlines():
        if not line or line.startswith("#"):
            out.append(line)
            continue
        name, brace, rest = line.partition("{")
        if brace:
            # `metric{a="b",...} v` -> `metric{worker="wN",a="b",...} v`
            out.append(f"{name}{{{pin},{rest}" if not rest.startswith("}")
                       else f"{name}{{{pin}{rest}")
        else:
            metric, sp, val = line.partition(" ")
            out.append(f"{metric}{{{pin}}} {val}" if sp else line)
    return "\n".join(out) + ("\n" if text.endswith("\n") else "")


class TelemetryReporter:
    """Daemon thread writing shared-schema :func:`status_snapshot` JSONL
    lines to ``<out_dir>/telemetry.jsonl`` — one immediately at
    :meth:`start`, one per ``interval_s``, one final at :meth:`close` (so
    every run yields >= 2) — and REWRITING the Prometheus text dump
    ``<out_dir>/metrics.prom`` on every snapshot (atomic tmp+rename, so a
    scraper tailing the file never reads a torn exposition). Each line
    embeds the derived ``status`` digest and, when the session carries an
    SLO evaluator, the ``health`` verdict."""

    def __init__(self, telemetry: Telemetry, out_dir: str,
                 interval_s: float = 5.0):
        os.makedirs(out_dir, exist_ok=True)
        self.telemetry = telemetry
        self.interval_s = max(0.01, float(interval_s))
        self.jsonl_path = os.path.join(out_dir, "telemetry.jsonl")
        self.prom_path = os.path.join(out_dir, "metrics.prom")
        self.snapshots_written = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _emit(self) -> None:
        # close a cost-profile time-series bucket at most once per tick
        # interval (maybe_tick: the /profile/cells scrape path ticks too,
        # and the two must not double-bucket)
        self.telemetry.costs.maybe_tick()
        self.telemetry.tenants.maybe_tick()
        snap = status_snapshot(self.telemetry)
        with open(self.jsonl_path, "a") as f:
            f.write(json.dumps(snap, sort_keys=True) + "\n")
        self.snapshots_written += 1
        tmp = self.prom_path + ".tmp"
        with open(tmp, "w") as f:
            f.write(prometheus_text(self.telemetry))
        os.replace(tmp, self.prom_path)

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._emit()

    def start(self) -> "TelemetryReporter":
        self._emit()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="telemetry-reporter")
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 5.0)
            self._thread = None
        self._emit()


@contextlib.contextmanager
def telemetry_session(out_dir: Optional[str] = None, interval_s: float = 5.0,
                      registry: Optional[_metrics.MetricsRegistry] = None,
                      health=None, trace: bool = False,
                      trace_dir: Optional[str] = None, device=None):
    """Activate telemetry for the enclosed block: installs the
    :class:`Telemetry` as the active session, chains its cell recording
    onto the grid's cell observer (an observer already installed keeps
    being called first), and (when ``out_dir`` is given) runs a
    :class:`TelemetryReporter`. ``health`` attaches an SLO evaluator so
    every snapshot carries its verdict. ``trace=True`` (implied by
    ``trace_dir``) records per-window trace lineage in a
    :class:`WindowTraceBook`; ``trace_dir`` exports it as Chrome
    trace-event JSON (``trace.json``) at close. Everything is restored on
    exit — including after an exception — so a crashed run still gets its
    final snapshot and its trace. ``device`` is the run's device (the
    device block's platform and memory probes)."""
    from spatialflink_tpu_torch.index import uniform_grid as _ug

    tel = Telemetry(registry, trace=trace or bool(trace_dir))
    tel.health = health
    tel.device = device
    # the cost-profile series and the tenant ledger's delta buckets close
    # at the session's snapshot cadence, whoever drives them
    tel.costs.tick_interval_s = max(0.01, float(interval_s))
    tel.tenants.tick_interval_s = max(0.01, float(interval_s))
    old = set_active(tel)
    old_obs = _ug._CELL_OBSERVER
    record = tel.record_cells

    def observe(cells) -> None:
        if old_obs is not None:
            old_obs(cells)
        record(cells)

    def observe_each(cells) -> None:
        # cells one by one, as the JAX package records restored records:
        # the sums are the same taken at once
        _ug.hand_each(old_obs, cells)
        record(cells)

    observe.each = observe_each
    _ug._CELL_OBSERVER = observe
    reporter = None
    if out_dir:
        reporter = TelemetryReporter(tel, out_dir, interval_s).start()
    try:
        yield tel
    finally:
        try:
            if reporter is not None:
                reporter.close()
        finally:
            try:
                if trace_dir and tel.traces is not None:
                    os.makedirs(trace_dir, exist_ok=True)
                    tel.traces.export_chrome(
                        os.path.join(trace_dir, "trace.json"))
            except Exception:
                pass  # export is best-effort; never mask the run's error
            finally:
                # restore the globals even when the final snapshot/prom
                # write fails: a dead session left active would instrument
                # every later run in the process
                _ug._CELL_OBSERVER = old_obs
                set_active(old)
