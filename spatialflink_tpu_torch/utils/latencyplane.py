"""Latency decomposition (port of ``spatialflink_tpu.utils.latencyplane``):
stage-residency budgets, record→emit latency and the backpressure
timeline, host-side and window-granular.

Every emitted window's record→emit latency splits into consecutive
wall-clock stages, so the stages sum to the total by construction:

============ ========================================================
stage        interval
============ ========================================================
``buffer``   first-record ingest (the decode chunk's stamp) → window
             sealed by the watermark sweep
``queue``    sealed → the window's dispatch starts
``dispatch`` the ``eval_batch`` call (batch build, H2D copy, launches)
``inflight`` dispatch done → readback starts (the pipeline deque)
``merge``    the readback (``Deferred.finish``: the one host wait)
``emit``     readback done → the WindowResult leaves the operator
============ ========================================================

and two downstream stages after ``emit``, outside the sum: ``sink`` (the
driver's emission) and ``sink-commit`` (the Kafka window sink). Per-query
record→emit histograms (``record-emit-ms@<qid>``) are observed at the
query router's demux. The backpressure series closes one bucket per
``tick_interval_s`` (whoever snapshots first) with the decode buffer
depth, the window backlog and its residency, the control and sink queue
depths and the watermark slope, and emits one ``stage-budget`` event per
bucket. Each closed bucket, with the live record→emit p99, goes to the
installed chunk governor (``runtime/control.py``), whose ``status()`` is
the ``controller`` block of ``GET /latency``.

The plane lives on the session (:class:`~.telemetry.Telemetry`); without
one nothing here runs. Every method is called per window or per tick,
never per record.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

#: the consecutive-interval stages whose durations sum to record→emit
CHAIN_STAGES = ("buffer", "queue", "dispatch", "inflight", "merge", "emit")
#: stages appended after the operator emitted (outside the sum invariant)
DOWNSTREAM_STAGES = ("sink", "sink-commit")


def _hist(name: str):
    from spatialflink_tpu_torch.utils.telemetry import StreamingHistogram

    return StreamingHistogram(name)


class LatencyPlane:
    """One session's latency-decomposition state. Created with every
    :class:`~spatialflink_tpu_torch.utils.telemetry.Telemetry` session (like the
    cost profiles); fed by the window drive loop, the window assemblers'
    seal sweeps, the driver's sink stage, the Kafka window sink, and the
    query router — all under the existing once-per-stream telemetry
    gates."""

    def __init__(self, recent_capacity: int = 128,
                 series_capacity: int = 128,
                 tick_interval_s: float = 5.0):
        self._lock = threading.Lock()
        #: per-stage residency histograms (ms), lazily created
        self.stages: Dict[str, object] = {}
        #: record→emit per emitted window (ms)
        self.record_emit = _hist("record-emit-ms")
        #: per-query record→emit (ms), fed at the router demux point
        self.queries: Dict[str, object] = {}
        #: true seal wall clocks noted by the assemblers' sweep, popped by
        #: the drive loop at dispatch (bounded: stale entries evicted)
        self._seals: Dict[int, float] = {}
        #: dispatch wall clock of windows in flight (backlog RESIDENCY)
        self._inflight: Dict[int, float] = {}
        #: newest full decompositions (the /latency "recent" table)
        self._recent: "OrderedDict[int, dict]" = OrderedDict()
        self.recent_capacity = max(1, int(recent_capacity))
        #: sum-invariant bookkeeping: windows budgeted + worst residual
        self.windows = 0
        self.max_residual_ms = 0.0
        #: event-time progression (for the watermark slope)
        self._max_window_end = None  # type: Optional[int]
        # backpressure series
        self.series = deque(maxlen=max(1, int(series_capacity)))
        self.tick_interval_s = max(0.01, float(tick_interval_s))
        self._last_tick_s = time.time()
        self._tick_state: dict = {}
        self._stalled = False

    # ------------------------- the stage chain ------------------------ #

    def _stage_hist(self, stage: str):
        h = self.stages.get(stage)
        if h is None:
            with self._lock:
                h = self.stages.setdefault(stage, _hist(stage))
        return h

    def note_seal(self, window_start: int, t_s: float) -> None:
        """The assembler's watermark sweep sealed this window (noted for
        EVERY ready window before the first yields, so windows waiting in
        the generator behind earlier windows' eval accumulate ``queue``
        time). Keyed by window_start; bounded."""
        with self._lock:
            self._seals[int(window_start)] = t_s
            if len(self._seals) > 4096:  # runaway guard (realtime keys)
                for k in list(self._seals)[:2048]:
                    del self._seals[k]

    def pop_seal(self, window_start: int, default_s: float) -> float:
        """The window's true seal wall clock (falls back to the dispatch
        pull time for paths without a sweeping assembler — realtime
        micro-batches, bespoke join loops — where queue is honestly 0)."""
        with self._lock:
            return self._seals.pop(int(window_start), default_s)

    def note_dispatch(self, window_start: int, t_s: float) -> None:
        """A window entered the in-flight deque (backlog residency)."""
        with self._lock:
            self._inflight[int(window_start)] = t_s

    def backlog_residency_ms(self, now_s: Optional[float] = None) -> float:
        """Age of the OLDEST in-flight window — the backlog residency-time
        signal (count alone cannot distinguish healthy pipelining from a
        wedged readback)."""
        with self._lock:
            if not self._inflight:
                return 0.0
            oldest = min(self._inflight.values())
        return max(0.0, ((now_s or time.time()) - oldest) * 1e3)

    def window_complete(self, label: str, window_start: int, window_end: int,
                        first_ingest_ms: Optional[int], stages: Dict[str, float],
                        emit_s: float,
                        last_ingest_ms: Optional[int] = None) -> None:
        """One emitted window's full budget: ``stages`` are the chain
        durations in ms (consecutive intervals — their sum IS the
        record→emit latency when the ingest stamp exists; payloads without
        one, e.g. bulk replay batches, feed the stage histograms but skip
        the record→emit observation)."""
        ws = int(window_start)
        with self._lock:
            self._inflight.pop(ws, None)
        for stage, dur in stages.items():
            self._stage_hist(stage).record(max(0.0, dur))
        total = None
        residual = None
        if first_ingest_ms is not None:
            total = emit_s * 1e3 - first_ingest_ms
            self.record_emit.record(max(0.0, total))
            residual = abs(total - sum(stages.values()))
        row = {"query": label, "window_start": ws,
               "window_end": int(window_end),
               "first_ingest_ms": first_ingest_ms,
               # the last record's ingest stamp bounds the buffer-
               # residency SPREAD (first old + last fresh = normal window
               # fill; both old = the pipeline sat on a ready window)
               "last_ingest_ms": last_ingest_ms,
               "emitted_ms": round(emit_s * 1e3, 3),
               "record_emit_ms": None if total is None else round(total, 3),
               "stages": {k: round(v, 3) for k, v in stages.items()}}
        with self._lock:
            self.windows += 1
            if residual is not None and residual > self.max_residual_ms:
                self.max_residual_ms = residual
            if self._max_window_end is None \
                    or window_end > self._max_window_end:
                self._max_window_end = int(window_end)
            self._recent[ws] = row
            while len(self._recent) > self.recent_capacity:
                self._recent.popitem(last=False)

    def note_downstream(self, stage: str, window_start: int, t0_s: float,
                        t1_s: float) -> None:
        """Append a downstream stage (``sink`` / ``sink-commit``) by
        window_start — the driver and the Kafka sink see a WindowResult,
        not a family label. Outside the sum invariant (these run after
        ``emit``); folded into the window's recent row when it is still
        in the ring."""
        dur = max(0.0, (t1_s - t0_s) * 1e3)
        self._stage_hist(stage).record(dur)
        with self._lock:
            row = self._recent.get(int(window_start))
            if row is not None:
                row["stages"][stage] = round(
                    row["stages"].get(stage, 0.0) + dur, 3)

    # --------------------------- per query ---------------------------- #

    def query_emit(self, qid: str, window_start: int,
                   now_s: float) -> Optional[float]:
        """Observe one routed window on the query's ``record-emit-ms@id``
        histogram (router demux point — every route counts). The window's
        first-ingest stamp comes from the completed-window ring; returns
        the observed ms (None when the window has no ingest stamp or was
        already evicted)."""
        with self._lock:
            row = self._recent.get(int(window_start))
            fi = row.get("first_ingest_ms") if row is not None else None
        if fi is None:
            return None
        val = max(0.0, now_s * 1e3 - fi)
        h = self.queries.get(qid)
        if h is None:
            with self._lock:
                h = self.queries.setdefault(
                    qid, _hist(f"record-emit-ms@{qid}"))
        h.record(val)
        return val

    def query_p99(self, qid: str) -> Optional[float]:
        """The query's current record→emit p99 (None before any window) —
        what the per-query ``p99_emit_ms`` SLO compares against."""
        h = self.queries.get(qid)
        if h is None or not h.count:
            return None
        return h.percentile(99)

    # ------------------------ backpressure series ---------------------- #

    def maybe_tick(self, tel=None) -> None:
        """Close a backpressure bucket when ``tick_interval_s`` elapsed —
        safe from every snapshot path (reporter, /status, /latency)
        without double-bucketing, exactly like ``CostProfiles``."""
        if time.time() - self._last_tick_s >= self.tick_interval_s:
            self.tick(tel)

    def tick(self, tel=None) -> dict:
        """Close one bucket: current backpressure signals, the watermark
        slope since the previous bucket, and the per-stage time DELTA —
        emitted as one ``stage-budget`` event (snapshot cadence, never
        per window)."""
        from spatialflink_tpu_torch.utils import telemetry as _telemetry

        now = time.time()
        with self._lock:
            self._last_tick_s = now
        gauges = tel.gauges if tel is not None else {}

        def g(name):
            gg = gauges.get(name)
            return None if gg is None else gg.get()

        # control-queue depth: staged-but-unapplied fleet changes
        control_depth = None
        try:
            from spatialflink_tpu_torch.runtime.queryplane import active_registry

            reg = active_registry()
            if reg is not None:
                control_depth = reg.staged_count()
        except Exception:
            pass
        records_in = 0
        if tel is not None:
            try:
                records_in = int(tel._registry().snapshot().get(
                    "ingest-throughput.count", 0))
            except Exception:
                records_in = 0
        with self._lock:
            wm = self._max_window_end
            stage_totals = {s: h.total for s, h in self.stages.items()}
            prev = self._tick_state
            self._tick_state = {"ts": now, "wm": wm,
                                "records_in": records_in,
                                "stages": stage_totals}
        slope = None
        if wm is not None and prev.get("wm") is not None \
                and now > prev["ts"]:
            slope = (wm - prev["wm"]) / (now - prev["ts"]) / 1e3
        # stalled: event time frozen across a bucket while records flowed
        stall = bool(slope is not None and slope <= 0.0
                     and records_in > prev.get("records_in", 0))
        stage_delta = {
            s: round(t - prev.get("stages", {}).get(s, 0.0), 6)
            for s, t in stage_totals.items()}
        bucket = {
            "ts_ms": int(now * 1000),
            "decode_buffer_depth": g("decode.buffer-depth"),
            "window_backlog": g("window-backlog"),
            "backlog_residency_ms": round(self.backlog_residency_ms(now), 3),
            "control_queue_depth": control_depth,
            "sink_queue_depth": g("kafka.commit-backlog"),
            "watermark_lag_ms": g("kafka.watermark-lag-ms"),
            "event_time_ms": wm,
            "wm_slope": None if slope is None else round(slope, 4),
            "stall": stall,
            "stage_delta_s": stage_delta,
        }
        self.series.append(bucket)
        if stage_delta:
            _telemetry.emit_event(
                "stage-budget",
                **{f"{s.replace('-', '_')}_s": d
                   for s, d in stage_delta.items()},
                windows=self.windows, stall=stall)
        with self._lock:
            was_stalled = self._stalled
            self._stalled = stall
        if stall and not was_stalled:
            _telemetry.emit_event("backpressure-stall",
                                  event_time_ms=wm, records_in=records_in)
        # the closed bucket is the chunk governor's sensor input: one hook
        # per tick, never per window
        try:
            from spatialflink_tpu_torch.runtime.control import active_governor

            gov = active_governor()
            if gov is not None:
                p99 = (self.record_emit.percentile(99)
                       if self.record_emit.count else None)
                gov.on_tick(bucket, p99)
        except Exception:
            pass  # a controller fault never breaks the sensor plane
        return bucket

    # ------------------------------ readers ---------------------------- #

    def recent_rows(self, k: int = 32) -> List[dict]:
        """Newest ``k`` full decompositions (oldest first)."""
        with self._lock:
            rows = list(self._recent.values())[-max(0, int(k)):]
            return [dict(r, stages=dict(r["stages"])) for r in rows]

    def budget_row(self, window_start: int) -> Optional[dict]:
        """One window's full budget row (a copy), or None once evicted
        from the recent ring — the fleet worker reads this at outbox
        append time so the emitted window's stage chain can travel to
        the supervisor as a lineage sidecar."""
        with self._lock:
            row = self._recent.get(int(window_start))
            return (None if row is None
                    else dict(row, stages=dict(row["stages"])))

    def to_dict(self) -> dict:
        """The compact ``latency`` block embedded in every snapshot."""
        with self._lock:
            stages = {s: h.to_dict() for s, h in self.stages.items()}
            n_q = len(self.queries)
            last = self.series[-1] if self.series else None
        return {
            "windows": self.windows,
            "record_emit": self.record_emit.to_dict(),
            "stages": stages,
            "queries": n_q,
            "max_residual_ms": round(self.max_residual_ms, 3),
            "backpressure": {"len": len(self.series),
                             "last": None if last is None else dict(last)},
        }

    def payload(self, k: int = 32, tel=None) -> dict:
        """The full ``GET /latency`` document: the per-stage decomposition
        table, record→emit (global + per query), the recent-window budget
        rows, the sum-invariant check, and the backpressure series.
        Scrape-driven ticking (like ``CostProfiles.cells_payload``): a
        reporterless session still advances the backpressure series, one
        bucket per ``tick_interval_s`` of being read."""
        self.maybe_tick(tel)
        with self._lock:
            stages = {s: h.to_dict() for s, h in self.stages.items()}
            queries = {qid: h.to_dict() for qid, h in self.queries.items()}
            series = [dict(b) for b in self.series]
        controller = None
        try:
            from spatialflink_tpu_torch.runtime.control import active_governor

            gov = active_governor()
            if gov is not None:
                controller = gov.status()
        except Exception:
            pass
        return {
            "ts_ms": int(time.time() * 1000),
            "controller": controller,
            "stages": stages,
            "chain_stages": list(CHAIN_STAGES),
            "downstream_stages": list(DOWNSTREAM_STAGES),
            "record_emit": self.record_emit.to_dict(),
            "queries": queries,
            "recent": self.recent_rows(k),
            "sum_check": {"windows": self.windows,
                          "max_residual_ms": round(self.max_residual_ms, 3)},
            "backpressure": {"series": series,
                             "backlog_residency_ms": round(
                                 self.backlog_residency_ms(), 3)},
        }
