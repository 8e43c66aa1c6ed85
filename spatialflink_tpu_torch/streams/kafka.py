"""Kafka transport (port of ``spatialflink_tpu.streams.kafka``): the
in-memory broker, the source, the sinks and their delivery semantics.

GeoFlink's I/O backbone is Kafka: consumers feed every pipeline
(``StreamingJob.java:473``), producers ship the results with EXACTLY_ONCE
semantics (``StreamingJob.java:512``), and latency values go to a topic of
their own (``HelperClass.java:455-529``). The transport is written against
a small broker interface (produce / fetch / commit / committed /
end_offset) with two implementations:

- :class:`InMemoryBroker`: topics as one ordered log each, offsets and
  consumer-group commits, shared per process under a ``memory://<name>``
  URL (:func:`resolve_broker`);
- :class:`RealKafkaBroker`: an adapter over the kafka-python client API,
  imported only when a real cluster is named (:func:`connect_kafka`);
  kafka-python is not a dependency of the port, so tests drive it
  through a fake module.

Delivery: the consumer commits offsets only after the results that reflect
them were produced (at-least-once; :class:`WindowCommitTap` aligns the
commits with window emission), and :class:`KafkaWindowSink` keys every
window's records by the window and writes one commit marker per window,
seeding its delivered set from the markers already in the output topic,
so windows delivered again after a restart are suppressed: exactly-once
windowed output across process restarts.

Not ported: the live (``--kafka-follow``) wait and its starvation
sentinel, the dead-letter queue and the chaos and supervised brokers
(ROADMAP Queue 1 item 6b), and the telemetry spans and gauges (item 5).
"""

from __future__ import annotations

import json
import sys
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from spatialflink_tpu_torch.streams.bulk import PointRows
from spatialflink_tpu_torch.streams.formats import serialize_spatial
from spatialflink_tpu_torch.utils.metrics import (ControlTupleExit,
                                                  check_exit_control_tuple)


@dataclass(slots=True)
class BrokerRecord:
    """One record of a topic log."""

    offset: int
    key: Optional[str]
    value: Any
    timestamp_ms: int = 0


class InMemoryBroker:
    """Topics as append-only logs with consumer-group offsets; thread-safe,
    so a producer thread can feed a consuming pipeline."""

    def __init__(self):
        self._topics: Dict[str, List[BrokerRecord]] = {}
        self._commits: Dict[Tuple[str, str], int] = {}
        self._lock = threading.Lock()

    def produce(self, topic: str, value, key: Optional[str] = None,
                timestamp_ms: Optional[int] = None) -> int:
        """Append; returns the record's offset."""
        with self._lock:
            log = self._topics.setdefault(topic, [])
            rec = BrokerRecord(
                offset=len(log), key=key, value=value,
                timestamp_ms=timestamp_ms if timestamp_ms is not None
                else int(time.time() * 1000))
            log.append(rec)
            return rec.offset

    def produce_many(self, topic: str, values, key: Optional[str] = None
                     ) -> int:
        """:meth:`produce` of many values under one lock and timestamp;
        returns the first offset."""
        with self._lock:
            log = self._topics.setdefault(topic, [])
            base = len(log)
            now = int(time.time() * 1000)
            log.extend(BrokerRecord(offset=base + i, key=key, value=v,
                                    timestamp_ms=now)
                       for i, v in enumerate(values))
            return base

    def fetch(self, topic: str, offset: int, max_records: int = 500
              ) -> List[BrokerRecord]:
        """Records from ``offset`` on. Consumers keep their own position;
        the committed offset only says where a restarted group member
        resumes."""
        with self._lock:
            log = self._topics.get(topic, [])
            return log[offset:offset + max_records]

    def commit(self, topic: str, group: str, next_offset: int) -> None:
        with self._lock:
            cur = self._commits.get((group, topic), 0)
            self._commits[(group, topic)] = max(cur, next_offset)

    def committed(self, topic: str, group: str) -> int:
        with self._lock:
            return self._commits.get((group, topic), 0)

    def end_offset(self, topic: str) -> int:
        with self._lock:
            return len(self._topics.get(topic, []))

    def topic_values(self, topic: str) -> List[Any]:
        with self._lock:
            return [r.value for r in self._topics.get(topic, [])]


def resequence_batch(batch: List[BrokerRecord], next_offset: int
                     ) -> List[BrokerRecord]:
    """One log's order over a transport that may reorder or re-deliver: a
    fetched batch sorted by offset, without the records below
    ``next_offset`` or delivered twice within it (a no-op on a clean
    transport, checked in one scan)."""
    if batch and batch[0].offset == next_offset:
        expected = next_offset
        for rec in batch:
            if rec.offset != expected:
                break
            expected += 1
        else:
            return batch
    cleaned: List[BrokerRecord] = []
    last = next_offset - 1
    for rec in sorted(batch, key=lambda r: r.offset):
        if rec.offset > last:
            cleaned.append(rec)
            last = rec.offset
    return cleaned


class KafkaSource:
    """Consumer-group iterator over a topic, from the group's committed
    offset to the topic's end (``FlinkKafkaConsumer``,
    ``StreamingJob.java:473``).

    Yields record values; with ``auto_commit`` it commits every
    ``commit_every`` records after handing them downstream (at-least-once).
    With ``auto_commit=False`` the caller places the commits
    (:meth:`commit_to` and the live ``position``, the next offset to read):
    the driver aligns them with window emission. ``commit_lag`` (with
    ``auto_commit=False``) commits ``position - lag`` after every poll
    batch, bounding a restart's replay on a stream that consumes without
    emitting. ``limit`` caps the records this run hands out (``--limit``).
    """

    def __init__(self, broker, topic: str, group: str,
                 poll_batch: int = 500, commit_every: int = 1,
                 auto_commit: bool = True, limit: Optional[int] = None,
                 commit_lag: Optional[int] = None):
        self.broker = broker
        self.topic = topic
        self.group = group
        self.poll_batch = poll_batch
        self.commit_every = max(1, commit_every)
        self.auto_commit = auto_commit
        self.commit_lag = commit_lag
        self.limit = limit
        #: next offset to read; live while iterating
        self.position = broker.committed(topic, group)

    def commit_to(self, next_offset: int) -> None:
        """Commit the group's resume point (monotone in the broker)."""
        self.broker.commit(self.topic, self.group, next_offset)

    def _polls(self) -> Iterator[List[BrokerRecord]]:
        """Resequenced poll batches from the committed offset, within
        ``limit``, until the topic's end."""
        from spatialflink_tpu_torch.utils import telemetry as _telemetry

        pos = self.position = self.broker.committed(self.topic, self.group)
        handed = 0
        # one ``kafka.fetch`` span per poll with a telemetry session
        tel = _telemetry.active()
        while self.limit is None or handed < self.limit:
            if tel is not None:
                with tel.span("fetch", query="kafka"):
                    batch = self.broker.fetch(self.topic, pos,
                                              self.poll_batch)
            else:
                batch = self.broker.fetch(self.topic, pos, self.poll_batch)
            if not batch:
                return
            cleaned = resequence_batch(batch, pos)
            if not cleaned:
                continue  # all duplicates of delivered records
            if self.limit is not None:
                cleaned = cleaned[:self.limit - handed]
            handed += len(cleaned)
            pos = cleaned[-1].offset + 1
            yield cleaned

    def iter_batches(self) -> Iterator[Tuple[List, List[int]]]:
        """``(values, next_positions)`` per poll, for chunk-aware consumers
        (the commit tap's chunked decode); needs ``auto_commit=False``.
        Control tuples are not checked here: the consumer scans the
        batch."""
        if self.auto_commit:
            raise ValueError("iter_batches requires auto_commit=False "
                             "(the consumer owns commit placement)")
        for cleaned in self._polls():
            self.position = cleaned[-1].offset + 1
            if self.commit_lag is not None:
                self.broker.commit(self.topic, self.group,
                                   max(0, self.position - self.commit_lag))
            yield [r.value for r in cleaned], [r.offset + 1 for r in cleaned]

    def __iter__(self) -> Iterator[Any]:
        uncommitted = 0
        for cleaned in self._polls():
            for rec in cleaned:
                # the position moves before the hand-off: a tap reading it
                # right after the record sees "offset past me"
                self.position = rec.offset + 1
                yield rec.value
                uncommitted += 1
                if self.auto_commit and uncommitted >= self.commit_every:
                    self.commit_to(self.position)
                    uncommitted = 0
            if self.commit_lag is not None and not self.auto_commit:
                self.commit_to(max(0, self.position - self.commit_lag))
        if self.auto_commit and uncommitted:
            self.commit_to(self.position)


class KafkaSink:
    """Producer of records to a topic, each serialized in ``fmt`` when it
    is a spatial object (the reference's per-type output schemas,
    ``Serialization.java``), keyed by its object id."""

    def __init__(self, broker, topic: str, fmt: Optional[str] = None,
                 date_format: Optional[str] = None, delimiter: str = ","):
        self.broker = broker
        self.topic = topic
        self.fmt = fmt
        self.date_format = date_format
        self.delimiter = delimiter

    def _encode(self, record):
        if self.fmt and hasattr(record, "obj_id"):
            return serialize_spatial(record, self.fmt,
                                     delimiter=self.delimiter,
                                     date_format=self.date_format)
        return record

    def emit(self, record) -> None:
        self.broker.produce(self.topic, self._encode(record),
                            key=getattr(record, "obj_id", None))

    def close(self) -> None:
        pass


def _values_equal(a, b) -> bool:
    """Structural equality that tolerates arrays inside results (a heatmap
    window would make ``==`` raise)."""
    import dataclasses

    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        return np.array_equal(a, b)
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        if type(a) is not type(b):
            return False
        return all(_values_equal(getattr(a, f.name), getattr(b, f.name))
                   for f in dataclasses.fields(a))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(
            _values_equal(v, b[k]) for k, v in a.items())
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(
            _values_equal(x, y) for x, y in zip(a, b))
    try:
        return bool(a == b)
    except Exception:
        return False


class IdempotentWindowSink:
    """At-least-once made exactly-once for windowed results within a
    process: results keyed by (window_start, window_end, key) (the
    ``cell`` extra when there is one); a key delivered again is dropped,
    and counted apart in ``duplicates_value_differing`` when its value
    differs (a recomputed window that disagrees: a determinism fault
    upstream)."""

    def __init__(self, inner_sink=None,
                 key_fn: Optional[Callable[[Any], Tuple]] = None):
        self.inner = inner_sink
        self.key_fn = key_fn or self._default_key
        self._delivered: Dict[Tuple, Any] = {}
        self.duplicates_suppressed = 0
        self.duplicates_value_differing = 0

    @staticmethod
    def _default_key(result) -> Tuple:
        cell = (getattr(result, "extras", {}).get("cell")
                if hasattr(result, "extras") else None)
        return (getattr(result, "window_start", None),
                getattr(result, "window_end", None), cell)

    def emit(self, result) -> None:
        key = self.key_fn(result)
        if key not in self._delivered:
            self._delivered[key] = result
            if self.inner is not None:
                self.inner.emit(result)
        else:
            self.duplicates_suppressed += 1
            if not _values_equal(self._delivered[key], result):
                self.duplicates_value_differing += 1

    @property
    def delivered_count(self) -> int:
        return len(self._delivered)

    def snapshot(self) -> Dict[Tuple, Any]:
        return dict(self._delivered)

    def close(self) -> None:
        if self.inner is not None:
            self.inner.close()


def _lwe(ts, slide_ms: int, size_ms: int):
    """The end of the last window holding event time ``ts``."""
    return ts - ts % slide_ms + size_ms


class WindowCommitTap:
    """Window-aligned offset commits for a :class:`KafkaSource` feeding an
    event-time windowed pipeline (the driver's ``--kafka`` mode).

    Between the source and the operator: decodes the raw records into
    chunks and notes, in arrival order, each record's source position and
    the end of the last window holding it (``lwe = ts - ts % slide +
    size``). Windows fire in end order, so a record is reflected in the
    output once the window ending at its ``lwe`` was emitted: on each
    emitted window ``[s, e)`` the longest prefix of noted records with
    ``lwe <= e`` commits (a prefix only, so an early record of a later
    window holds the commits behind it). A crash re-delivers exactly the
    records some unfired window still needed; the window sink suppresses
    the windows emitted again.

    :meth:`chunks` yields the port's chunks: a point stream through
    ``bulk_decode(raws) -> PointChunk`` (one native parse per chunk of
    ``bulk_chunk`` records: an int, or the chunk governor's callback read
    at every take), else record by record through ``parse``
    (points into a columnar chunk interned through :attr:`interner`,
    polygons and linestrings into a geometry chunk, other records dropped
    as off-type after they were noted). Control tuples are checked before
    the parse: the records before one reach the pipeline, then
    :class:`ControlTupleExit` propagates. With a ``checkpointer`` the tap
    notes the position of each chunk's last record as the chunk is handed
    downstream (never at pull time: a checkpoint must not cover records
    still in the decode buffer)."""

    def __init__(self, source: KafkaSource, size_ms: int, slide_ms: int,
                 parse: Callable[[Any], Any], geometry: str = "Point",
                 bulk_decode: Optional[Callable[[List[str]], Any]] = None,
                 bulk_chunk=2048, checkpointer=None, interner=None):
        from spatialflink_tpu_torch.utils import IdInterner

        self.source = source
        self.size_ms = int(size_ms)
        self.slide_ms = max(1, int(slide_ms))
        self.parse = parse
        self.geometry = geometry
        self.bulk_decode = bulk_decode
        #: an int or a zero-argument size callback (the chunk governor's
        #: actuator), read through :attr:`bulk_chunk` at every take, so a
        #: resize lands between chunks
        self._bulk_chunk = bulk_chunk
        #: the stream's id space (the bulk decode's, when there is one)
        self.interner = (getattr(bulk_decode, "interner", None) or interner
                         or IdInterner())
        self.checkpointer = checkpointer
        self._ckpt_key = f"kafka:{source.topic}"
        self._pending: deque = deque()  # (position, lwe), arrival order
        # telemetry gauges (watermark lag = wall clock minus the newest
        # event time; commit backlog = records awaiting a covering window),
        # set once per chunk, only when a session was active when the
        # driver wired the tap
        from spatialflink_tpu_torch.utils import telemetry as _telemetry

        tel = self._tel = _telemetry.active()
        self._lag_gauge = (tel.gauge("kafka.watermark-lag-ms")
                           if tel is not None else None)
        self._backlog_gauge = (tel.gauge("kafka.commit-backlog")
                               if tel is not None else None)

    @property
    def bulk_chunk(self) -> int:
        """The decode chunk now (a callback is resolved afresh)."""
        c = self._bulk_chunk
        return max(1, int(c() if callable(c) else c))

    # ------------------------------ decode ------------------------------ #

    def _objects_chunk(self, objs: List, poss: List[int]):
        """Parsed records -> the stream's chunk (None when nothing of the
        stream's geometry is left), every record noted for the commits."""
        from spatialflink_tpu_torch.models import Point
        from spatialflink_tpu_torch.models.objects import _EdgeGeom
        from spatialflink_tpu_torch.streams.bulk import (GeomChunk,
                                                         PointChunk,
                                                         points_to_parsed)

        for obj, p in zip(objs, poss):
            ts = getattr(obj, "timestamp", None)
            self._pending.append((p, _lwe(int(ts), self.slide_ms,
                                          self.size_ms)
                                  if isinstance(ts, (int, float))
                                  else float("inf")))
        want = Point if self.geometry == "Point" else _EdgeGeom
        kept = [o for o in objs if isinstance(o, want)]
        if len(kept) < len(objs):
            from spatialflink_tpu_torch import driver

            dropped = [o for o in objs if not isinstance(o, want)]
            driver.decode_chunks.off_type_dropped += len(dropped)
            from spatialflink_tpu_torch.utils import metrics

            metrics.REGISTRY.counter("off-type-dropped").inc(len(dropped))
            print(f"warning: dropping off-type "
                  f"{type(dropped[0]).__name__} record(s) from declared "
                  f"{self.geometry} stream (off-type-dropped="
                  f"{driver.decode_chunks.off_type_dropped})",
                  file=sys.stderr)
        if not kept:
            return None
        if self.geometry == "Point":
            return PointChunk(parsed=points_to_parsed(kept, self.interner),
                              cells=np.array([p.cell for p in kept],
                                             np.int32),
                              ingest_ms=int(time.time() * 1000))
        return GeomChunk(kept)

    def _decode(self, raws: List, poss: List[int]):
        """One buffered chunk -> a port chunk: the native point parse when
        it maps one row per record, else the exact per-record parse."""
        chunk = None
        if self.bulk_decode is not None and all(
                isinstance(r, str) and "\n" not in r for r in raws):
            try:
                chunk = self.bulk_decode(raws)
            except ValueError:
                chunk = None
            if chunk is not None and len(chunk) != len(raws):
                chunk = None
        if chunk is None:
            return self._objects_chunk([self.parse(r) for r in raws], poss)
        ts = np.asarray(chunk.ts, np.int64)
        self._pending.extend(zip(poss, _lwe(ts, self.slide_ms,
                                            self.size_ms).tolist()))
        return chunk

    def chunks(self) -> Iterator[Any]:
        """The decoded chunks, one per ``bulk_chunk`` records (the last one
        shorter); a control tuple flushes the records before it, then
        stops the stream."""
        raws: List = []
        poss: List[int] = []

        tel = self._tel

        def flush():
            if not raws:
                return
            t0 = time.perf_counter() if tel is not None else 0.0
            chunk = self._decode(raws, poss)
            if self.checkpointer is not None:
                self.checkpointer.note_position(self._ckpt_key, poss[-1])
            raws.clear()
            poss.clear()
            if tel is not None:
                # one ingest observation per decoded chunk, and the gauges
                tel.observe("ingest", time.perf_counter() - t0)
                self._note_gauges(chunk)
            if chunk is not None and len(chunk):
                yield chunk

        for vals, positions in self.source.iter_batches():
            if all(isinstance(v, str) and '"control"' not in v
                   for v in vals):
                # a poll of plain records: appended in chunk-sized slices
                i = 0
                while i < len(vals):
                    take = max(self.bulk_chunk - len(raws), 1)
                    raws.extend(vals[i:i + take])
                    poss.extend(positions[i:i + take])
                    i += take
                    if len(raws) >= self.bulk_chunk:
                        yield from flush()
                continue
            for raw, p in zip(vals, positions):
                try:
                    check_exit_control_tuple(raw)
                except ControlTupleExit:
                    yield from flush()
                    raise
                raws.append(raw)
                poss.append(p)
                if len(raws) >= self.bulk_chunk:
                    yield from flush()
        yield from flush()

    def _note_gauges(self, chunk) -> None:
        """The watermark lag (now minus the chunk's last event time) and
        the commit backlog, once per chunk."""
        ts = getattr(chunk, "ts", None) if chunk is not None else None
        if ts is not None and len(ts):
            self._lag_gauge.set(time.time() * 1000 - int(ts[-1]))
        self._backlog_gauge.set(len(self._pending))

    # ------------------------------ commits ----------------------------- #

    def on_window_emitted(self, window_end: int) -> None:
        """Commit the prefix of records every one of whose windows ends at
        or before ``window_end`` (call after the result was produced)."""
        pos = None
        while self._pending and self._pending[0][1] <= window_end:
            pos = self._pending.popleft()[0]
        if pos is not None:
            self.source.commit_to(pos)

    def commit_all(self) -> None:
        """A bounded stream drained and flushed: every record consumed is
        reflected in the output; commit the source's full position."""
        self._pending.clear()
        self.source.commit_to(self.source.position)


def _jsonable(v):
    """A JSON projection of a result's extras: arrays to nested lists,
    unknown objects to strings."""
    if isinstance(v, np.ndarray) or hasattr(v, "__array__"):
        return np.asarray(v).tolist()
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, (set, frozenset)):
        return sorted(str(x) for x in v)
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


class KafkaWindowSink:
    """Windowed results to the output topic, exactly once across process
    restarts: the output log is the recovery state.

    A window's records are produced keyed by the window's key
    ``"[job:]start:end:cell"``, then one commit marker (key
    ``__window_commit__:<key>``, value the record count). At start the sink
    reads the markers already in the topic into its delivered set (the
    seed scan), so a window delivered again after a crash is suppressed
    even in a new process. A window cut off in the middle of its
    production has no marker and is produced again whole; a reader that
    follows the markers never sees a duplicate or partial window."""

    MARKER = "__window_commit__:"

    def __init__(self, broker, topic: str, fmt: Optional[str] = None,
                 date_format: Optional[str] = None, delimiter: str = ",",
                 job_id: Optional[str] = None,
                 seed_scan_limit: Optional[int] = None,
                 seed_scan_warn: int = 100_000):
        self.broker = broker
        self.topic = topic
        #: the job fingerprint folded into every key: another job on the
        #: same output topic does not see this one's markers
        self.job_id = job_id
        #: scan at most the topic's last ``seed_scan_limit`` records (None:
        #: all), and warn once past ``seed_scan_warn``
        self.seed_scan_limit = seed_scan_limit
        self.seed_scan_warn = seed_scan_warn
        self._enc = KafkaSink(broker, topic, fmt, date_format, delimiter)
        from spatialflink_tpu_torch.utils import telemetry as _telemetry

        self._tel = _telemetry.active()
        self.delivered = self._seed_from_log()
        self.duplicates_suppressed = 0
        self.windows_produced = 0

    def _seed_from_log(self) -> set:
        """The marker keys already in the topic: a scan of the whole topic
        (a log-compacted output topic keeps it as long as the live window
        count), or of its tail with ``seed_scan_limit``, which accepts that
        a window committed before that tail can be produced again."""
        seen: set = set()
        end = self.broker.end_offset(self.topic)
        off = 0
        if self.seed_scan_limit is not None and end > self.seed_scan_limit:
            off = end - self.seed_scan_limit
            print(f"warning: output topic '{self.topic}' holds {end} "
                  f"records; seeding the dedup set from the last "
                  f"{self.seed_scan_limit} only — windows committed before "
                  f"offset {off} can be re-produced on re-delivery",
                  file=sys.stderr)
        scanned = 0
        warned = False
        while True:
            batch = self.broker.fetch(self.topic, off)
            if not batch:
                from spatialflink_tpu_torch.utils import metrics

                metrics.REGISTRY.counter("sink-seed-scan-records").inc(
                    scanned)
                return seen
            for r in batch:
                if isinstance(r.key, str) and r.key.startswith(self.MARKER):
                    seen.add(r.key[len(self.MARKER):])
                off = max(off, r.offset + 1)
                scanned += 1
            if scanned > self.seed_scan_warn and not warned:
                warned = True
                print(f"warning: dedup seed scan of output topic "
                      f"'{self.topic}' passed {self.seed_scan_warn} records "
                      "and is still going — the topic looks uncompacted; "
                      "run it log-compacted (marker records are keyed) or "
                      "bound the scan with seed_scan_limit",
                      file=sys.stderr)

    def window_key(self, result) -> str:
        cell = result.extras.get("cell") if hasattr(result, "extras") else None
        base = (f"{getattr(result, 'window_start', None)}:"
                f"{getattr(result, 'window_end', None)}:{cell}")
        return f"{self.job_id}:{base}" if self.job_id else base

    def emit(self, result) -> None:
        """Produce one window (or suppress a delivered one). With a
        telemetry session it is a ``kafka.sink`` span, the window's
        downstream ``sink-commit`` budget and, with tracing, its last trace
        note."""
        tel = self._tel
        if tel is None:
            self._emit(result)
            return
        t0 = time.time()
        with tel.span("sink", query="kafka"):
            self._emit(result)
        t1 = time.time()
        if hasattr(result, "window_start"):
            tel.latency.note_downstream("sink-commit", result.window_start,
                                        t0, t1)
            if tel.traces is not None:
                tel.traces.note_any(result.window_start, "sink-commit",
                                    t0, t1)

    def _emit(self, result) -> None:
        wk = self.window_key(result)
        if wk in self.delivered or (
                self.job_id and wk.split(":", 1)[1] in self.delivered):
            # a marker written before job prefixes existed still covers
            # the window
            self.duplicates_suppressed += 1
            return
        recs = result.records
        if "queries" in getattr(result, "extras", {}):
            # a multi-query window: its per-query lists, flattened
            recs = (PointRows.concat(recs) if recs and all(
                isinstance(r, PointRows) for r in recs)
                else [r for per_query in recs for r in per_query])
        vals = None
        sb = getattr(recs, "serialize_batch", None)
        if sb is not None and self._enc.fmt:
            # selected point rows serialize from their columns
            vals = sb(self._enc.fmt, delimiter=self._enc.delimiter,
                      date_format=self._enc.date_format)
        if vals is None:
            enc = self._enc._encode
            vals = [enc(r) for r in recs]
        if vals and type(self.broker) is InMemoryBroker:
            self.broker.produce_many(self.topic, vals, key=wk)
        else:
            for v in vals:
                self.broker.produce(self.topic, v, key=wk)
        n = len(vals)
        extras = {k: v for k, v in getattr(result, "extras", {}).items()
                  if k != "latency_ms"}
        if extras:
            # an aggregate window's payload is its extras (a heatmap, the
            # multi-query metadata): one JSON summary record under the key
            self.broker.produce(self.topic, json.dumps({
                "window": [result.window_start, result.window_end],
                **{k: _jsonable(v) for k, v in extras.items()}}), key=wk)
            n += 1
        self.broker.produce(self.topic, str(n), key=self.MARKER + wk)
        self.delivered.add(wk)
        self.windows_produced += 1

    def close(self) -> None:
        pass


class KafkaLatencySink:
    """Per-record latency in ms to a topic (``HelperClass.LatencySink*``,
    ``HelperClass.java:455-529``): ``now - ingestion time`` (or event
    time)."""

    def __init__(self, broker, topic: str, use_event_time: bool = False):
        self.broker = broker
        self.topic = topic
        self.use_event_time = use_event_time

    def emit(self, record) -> None:
        now = time.time() * 1000
        base = record.timestamp if self.use_event_time else getattr(
            record, "ingestion_time", record.timestamp)
        self.broker.produce(self.topic, now - base,
                            key=getattr(record, "obj_id", None))

    def close(self) -> None:
        pass


class RealKafkaBroker:
    """The broker interface over the kafka-python client API: a real
    cluster in place of :class:`InMemoryBroker`, with the same
    at-least-once contract.

    Every topic is pinned to partition 0 (the shim's one log per topic).
    Offsets commit through the consumer-group API and only move forward.
    An empty fetch means the end of the topic: empty polls while records
    exist past the offset are retried ``fetch_retries`` times, so a cold
    first poll does not pass for the end. The adapter is exercised against
    a fake of the client module (``connect_kafka``'s ``kafka_module``);
    first use against a cluster should check produce, fetch, commit and
    committed on a scratch topic."""

    def __init__(self, kafka_module, bootstrap_servers: str, *,
                 produce_timeout_s: float = 30.0, poll_timeout_ms: int = 500,
                 fetch_retries: int = 20):
        self._kafka = kafka_module
        self.bootstrap = bootstrap_servers
        self.produce_timeout_s = produce_timeout_s
        self.poll_timeout_ms = poll_timeout_ms
        self.fetch_retries = fetch_retries
        self._producer = None
        self._fetch_c = None
        self._group_c: Dict[str, Any] = {}
        self._commit_hwm: Dict[Tuple[str, str], int] = {}

    @staticmethod
    def _to_bytes(v) -> Optional[bytes]:
        if v is None:
            return None
        if isinstance(v, bytes):
            return v
        return str(v).encode("utf-8")

    @staticmethod
    def _to_str(v):
        return (v.decode("utf-8", errors="replace") if isinstance(v, bytes)
                else v)

    def _tp(self, topic: str):
        return self._kafka.TopicPartition(topic, 0)

    def _oam(self, offset: int):
        cls = getattr(self._kafka, "OffsetAndMetadata", None)
        if cls is None:
            cls = self._kafka.structs.OffsetAndMetadata
        try:
            return cls(offset, "")
        except TypeError:  # newer kafka-python adds leader_epoch
            return cls(offset, "", -1)

    def _get_producer(self):
        if self._producer is None:
            self._producer = self._kafka.KafkaProducer(
                bootstrap_servers=self.bootstrap)
        return self._producer

    def _fetch_consumer(self):
        if self._fetch_c is None:
            self._fetch_c = self._kafka.KafkaConsumer(
                bootstrap_servers=self.bootstrap, enable_auto_commit=False)
        return self._fetch_c

    def _group_consumer(self, group: str):
        if group not in self._group_c:
            self._group_c[group] = self._kafka.KafkaConsumer(
                bootstrap_servers=self.bootstrap, group_id=group,
                enable_auto_commit=False)
        return self._group_c[group]

    def produce(self, topic: str, value, key: Optional[str] = None,
                timestamp_ms: Optional[int] = None) -> int:
        fut = self._get_producer().send(
            topic, value=self._to_bytes(value), key=self._to_bytes(key),
            partition=0, timestamp_ms=timestamp_ms)
        # an acknowledged write (a broker error raises, never drops)
        return fut.get(timeout=self.produce_timeout_s).offset

    def fetch(self, topic: str, offset: int, max_records: int = 500
              ) -> List[BrokerRecord]:
        c = self._fetch_consumer()
        tp = self._tp(topic)
        c.assign([tp])
        c.seek(tp, offset)
        out: List[BrokerRecord] = []
        for _ in range(max(1, self.fetch_retries)):
            polled = c.poll(timeout_ms=self.poll_timeout_ms,
                            max_records=max_records)
            for recs in polled.values():
                for r in recs:
                    out.append(BrokerRecord(
                        offset=r.offset, key=self._to_str(r.key),
                        value=self._to_str(r.value),
                        timestamp_ms=getattr(r, "timestamp", 0) or 0))
            if out or offset >= self.end_offset(topic):
                return out
        raise TimeoutError(
            f"kafka fetch: {topic}@{offset} < end_offset but "
            f"{self.fetch_retries} polls returned no records")

    def commit(self, topic: str, group: str, next_offset: int) -> None:
        if next_offset <= self.committed(topic, group):
            return
        self._group_consumer(group).commit(
            {self._tp(topic): self._oam(next_offset)})
        self._commit_hwm[(topic, group)] = next_offset

    def committed(self, topic: str, group: str) -> int:
        hwm = self._commit_hwm.get((topic, group))
        if hwm is not None:
            return hwm
        off = self._group_consumer(group).committed(self._tp(topic))
        hwm = 0 if off is None else int(getattr(off, "offset", off))
        self._commit_hwm[(topic, group)] = hwm
        return hwm

    def end_offset(self, topic: str) -> int:
        c = self._fetch_consumer()
        tp = self._tp(topic)
        return int(c.end_offsets([tp])[tp])

    def close(self) -> None:
        if self._producer is not None:
            self._producer.flush()
            self._producer.close()
        for c in ([self._fetch_c] if self._fetch_c else []) + list(
                self._group_c.values()):
            c.close()


#: process-shared in-memory brokers by ``memory://name`` URL: a producer
#: thread, a test and a driver ``main()`` in one process reach one log, and
#: a ``main()`` run again after a crash finds its committed offsets
_MEMORY_BROKERS: Dict[str, InMemoryBroker] = {}
_MEMORY_BROKERS_LOCK = threading.Lock()


def resolve_broker(bootstrap_servers: str, kafka_module=None):
    """The broker of a bootstrap string: ``memory://<name>`` is the
    process-shared :class:`InMemoryBroker` of that URL (made at first use);
    anything else a real cluster through :func:`connect_kafka`."""
    if bootstrap_servers.startswith("memory://"):
        with _MEMORY_BROKERS_LOCK:
            return _MEMORY_BROKERS.setdefault(bootstrap_servers,
                                              InMemoryBroker())
    return connect_kafka(bootstrap_servers, kafka_module)


def reset_memory_brokers() -> None:
    """Drop every ``memory://`` broker (test isolation)."""
    with _MEMORY_BROKERS_LOCK:
        _MEMORY_BROKERS.clear()


def connect_kafka(bootstrap_servers: str, kafka_module=None
                  ) -> RealKafkaBroker:
    """The real-cluster adapter. ``kafka_module`` is the seam tests fill
    with a fake (KafkaProducer / KafkaConsumer / TopicPartition /
    OffsetAndMetadata); None imports kafka-python, and its absence raises
    RuntimeError."""
    if kafka_module is None:
        try:
            import kafka as kafka_module  # type: ignore
        except ImportError as e:
            raise RuntimeError(
                "connect_kafka requires the kafka-python package, which is "
                "not installed in this environment; use InMemoryBroker for "
                "local pipelines and tests.") from e
    return RealKafkaBroker(kafka_module, bootstrap_servers)
