"""Driver (port of ``spatialflink_tpu.driver`` for the range, kNN and join
queries over point, polygon and linestring streams, and the trajectory
queries over a point stream).

``CASES`` keeps the JAX package's option numbering for the options this
port runs: for each (stream, query) pair of ``_PAIRS``, i = 0..8 (Point,
Polygon and LineString streams, each against Point, Polygon and LineString
queries), range 1 + 5i (windowed) and 2 + 5i (realtime), kNN 51 + 5i
and 52 + 5i, and join 101 + 5i and 102 + 5i; realtime runs micro-batches
of ``realtime_batch_size`` arrivals, emitted only when the selection is
not empty. Also the latency variants 8/9 (range), 58/59 (kNN) and
108/109 (join) over a point stream and a polygon query (query stream),
windowed and realtime, whose results carry each selected record's (each
pair's first record's) ``now - ingestion time`` in
``extras["latency_ms"]`` (empty for kNN's (objID, distance) records). A
join reads its query stream from ``stream2`` (``--input2``), decoded with
``inputStream2`` on its grid; its records are (record, query record)
pairs. ``window.type: COUNT`` turns the windowed
options into sliding count windows (interval and step are record counts).
``query.multiQuery`` (or ``--multi-query``) answers every configured query
object of the option's type in one dispatch per window (trajectory kNN
211/212 included). The trajectory queries (``StreamingJob.java:1163-
1287``): tFilter 201 (realtime) / 202 (windowed) over ``query.trajIDs``,
tRange 203 / 204 against every ``queryPolygons`` entry (naive twin 2030),
tStats 205 / 206, tAggregate 207 / 208 with ``query.aggregateFunction``
(realtime eviction after ``thresholds.trajDeletion``; ``window.type:
COUNT`` gives 208 per-cell count windows), tJoin 209 / 210 against stream
2 (naive twin 2090) and tKNN 211 / 212 from the first query point (naive
twin 2011); ``query.panes`` runs 204, 206 and 208 pane by pane. Option 99
runs all six families over a synthetic stream (``SyntheticPointSource``),
each result tagged with ``extras["family"]``. ``query.panes``
(or ``--panes``) runs the sliding windows of the range and kNN options pane
by pane, each pane evaluated once and each window merged from its panes'
partials (``--pane-merge``, ``query.paneDeviceMerge``: where kNN partials
merge), and a windowed join by pane-pair blocks (a realtime join ignores
it, as in the JAX package). The host-only options: the ser/de pipelines
401-406 ... 901-906 (each record parsed in the option's format and written
again: ``(object, serialized)``), the shapefile inputs 1001-1003
(``--input1`` the ``.shp`` path), and the apps 1010 (cell stay time),
1011 (sensor coverage), 1012 (the two normalized; stream 2 the sensor
polygons) and 2000 (check-in occupancy). ``--bulk``
(:func:`run_option_bulk`) replays a whole file of a windowed range, kNN
or point x point join in one native parse, results as original-record
indices, and falls back to the record path, with a note, where the JAX
driver does; ``--limit`` reads at most that many records of each
stream (``--bulk`` ignores it). ``--queries-file`` serves a dynamic fleet of
point queries (windowed range 1, 16, 31 and kNN 51) from a live
``runtime.queryplane.QueryRegistry``, seeded from the file or the config's
``queryPoints`` (or restored from a checkpoint); each window's per-query
lists go to the queries' routes (``stdout``, ``file:`` or ``kafka:``), and
``--control-topic`` admits, updates and retires queries from a Kafka topic.

``--kafka`` (the reference's topology, ``StreamingJob.java:473,512``)
consumes ``inputStream{1,2}.topicName`` through the broker
``kafkaBootStrapServers`` names (``memory://<name>``: the in-process
broker) and produces to ``outputStream.topicName``: a time-windowed
family through the window-aligned commit tap and the marker-keyed window
sink, the rest through the plain sink, committed when the topic is
drained; ``--input1``/``--input2`` files are produced to the input topics
first (once, across restarts), and ``--kafka --bulk`` drains whole topics
into :func:`run_option_bulk`. ``--checkpoint-dir`` (with ``--resume``,
``--checkpoint-every/-interval/-retain``) checkpoints the windowed range,
kNN, join and trajectory options and realtime range, kNN, tStats and
tAggregate through ``runtime.checkpoint.CheckpointCoordinator``, in the
JAX package's manifest format; a resumed file replay skips the records the
checkpoint reflects and suppresses the windows already printed (the
checkpoint directory's journal). ``--checkpoint`` is the legacy state file
of realtime tStats 205 and tAggregate 207. ``--adaptive-grid [K]``
(``--repartition-interval N``) refines hot cells K x K in epochs of N
decoded records (``runtime.repartition.RepartitionController``) and
prefilters the point-stream range queries' windows on the host against
the leaf masks (``operators.base.SpatialOperator._prefilter``): the same
results, fewer records to the kernels; every other option accepts it and
runs unchanged, the epochs counting all the same, and the layout rides
``--checkpoint-dir`` as the component ``grid``. ``--shard-order`` is
accepted and its value dropped: one card has no shards to place. A control tuple in a stream
stops the run (exit 0); a SIGTERM drains the records read and writes a
final checkpoint. The telemetry flags (``utils.telemetry``): ``--metrics``
prints the registry as one JSON object on stderr at exit;
``--telemetry-dir`` (``--telemetry-interval``) writes JSONL snapshots and
``metrics.prom``; ``--trace-dir`` the per-window Chrome trace;
``--live-stats`` the stderr digest; ``--postmortem-dir`` arms the flight
recorder (bundles on a crash, a strict-recompile abort or SIGUSR1, read by
``python -m spatialflink_tpu_torch.doctor``); ``--strict-recompile``
(``--sentinel-warmup``) exits 3 when a kernel meets a new signature after
the warmup; ``--profile`` writes a ``torch.profiler`` trace. The
operations plane (``runtime.opserver``, ``runtime.health``,
``runtime.control``): ``--status-port`` serves the status server
(``/healthz``, ``/status``, ``/metrics``, ``/events``, ``/trace``,
``/profile/cells``, ``/latency``, ``/partition``, ``/queries`` with POST
and DELETE, ``/tenants``, ``/device``, ``/compile``); ``--slo`` the health
checks behind ``/healthz``, the snapshots' verdict and the recorder's
breach bundle; ``--controller`` the decode-chunk governor, ticked by the
latency plane; ``--latency-class``, ``--tenant-default`` and
``--tenant-quota`` the registry's defaults and admission quotas. Every
other option, and every flag or config feature not ported yet
(``--kafka-follow``, ``--chaos``, ``--retry``, ``--dlq``, ``--devices``,
``--hosts``, ``--fleet*``), is refused with "not yet ported to
spatialflink_tpu_torch" — never silently ignored.

A point stream in CSV/TSV/GeoJSON decodes through the native columnar
parser; a polygon or linestring stream (GeoJSON, WKT, CSV/TSV) is parsed
record by record, as the JAX driver parses it, and a record of another
geometry type is dropped and counted (``decode_chunks.off_type_dropped``).

    python -m spatialflink_tpu_torch.driver --config conf/spatialflink-conf.yml \\
        --option 51 --input1 points.csv --format CSV [--multi-query] \\
        [--panes [--pane-merge auto|device|host]] [--queries-file q.json] \\
        [--input2 queries.csv --format2 CSV] [--bulk] [--limit N] \\
        [--output out.geojson] [--output-format GeoJSON|WKT|CSV|TSV] \\
        [--kafka [--kafka-group G] [--kafka-bootstrap URL]] \\
        [--checkpoint-dir DIR [--resume]] [--adaptive-grid [K]
        [--repartition-interval N]] [--metrics] [--telemetry-dir DIR
        [--telemetry-interval S]] [--trace-dir DIR] [--live-stats]
        [--postmortem-dir DIR] [--strict-recompile [--sentinel-warmup N]]
        [--status-port PORT] [--slo SPEC] [--controller [SPEC]]
        [--latency-class interactive|batch] [--tenant-default T]
        [--tenant-quota T:N[,kernel_ms_s=X]] [--profile DIR]
        [--device cuda|cpu]

stdout carries one line per window as the JAX driver prints it:
``{'window': [start, end], 'count': n}`` plus the result's extras (``k``
for kNN; ``per_query_counts`` and ``queries`` under multiQuery and
``--queries-file``, which adds ``query_ids``), without ``latency_ms``; a join's count is its number of pairs, and ``--output``
writes each pair as a JSON array of its two serialized records. A
host-only option's results (a ser/de pair, a shapefile object, a
check-in tuple) print one per line as they are.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import sys
import time
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional

import numpy as np

from spatialflink_tpu_torch import operators as ops
from spatialflink_tpu_torch.config import Params, StreamConfig
from spatialflink_tpu_torch.device import resolve_device
from spatialflink_tpu_torch.index import UniformGrid
from spatialflink_tpu_torch.operators import (QueryConfiguration, QueryType,
                                              WindowResult)
from spatialflink_tpu_torch.operators.base import NOT_PORTED
from spatialflink_tpu_torch.runtime.watermarks import BoundedOutOfOrderness
from spatialflink_tpu_torch.streams import bulk
from spatialflink_tpu_torch.models import SpatialObject
from spatialflink_tpu_torch.models.objects import _EdgeGeom
from spatialflink_tpu_torch.streams.bulk import GeomChunk, PointChunk
from spatialflink_tpu_torch.streams.formats import (parse_spatial,
                                                    serialize_spatial)
from spatialflink_tpu_torch.streams.sinks import file_lines
from spatialflink_tpu_torch.utils import IdInterner, metrics


@dataclass(frozen=True)
class CaseSpec:
    # range | knn | join | t* (trajectory) | synthetic | deser | shapefile
    # | staytime | checkin
    family: str
    stream: str = "Point"  # geometry type of input stream 1
    query: str = "Point"   # geometry type of the query side
    mode: str = "window"   # window | realtime
    latency: bool = False  # a latency variant
    naive: bool = False    # a naive twin (no cell pruning)
    fmt: Optional[str] = None   # a ser/de case's forced format
    timestamped: bool = False   # a ser/de case writes its timestamps
    delim: Optional[str] = None  # a ser/de case's forced delimiter (TSV)


_PAIRS = [
    ("Point", "Point"), ("Point", "Polygon"), ("Point", "LineString"),
    ("Polygon", "Point"), ("Polygon", "Polygon"), ("Polygon", "LineString"),
    ("LineString", "Point"), ("LineString", "Polygon"),
    ("LineString", "LineString"),
]


def _build_cases() -> dict:
    """The ported options (numbering of ``spatialflink_tpu.driver.CASES``):
    range 1/2 + 5*i, kNN 51/52 + 5*i and join 101/102 + 5*i over the nine
    (stream, query) pairs, the latency variants, the trajectory queries
    201-212 with their naive twins, and the synthetic harness 99."""
    c = {}
    for i, (stream, query) in enumerate(_PAIRS):
        for base, fam in ((1, "range"), (51, "knn"), (101, "join")):
            c[base + 5 * i] = CaseSpec(fam, stream, query, "window")
            c[base + 1 + 5 * i] = CaseSpec(fam, stream, query, "realtime")
    for opt, fam, mode in ((8, "range", "window"), (9, "range", "realtime"),
                           (58, "knn", "window"), (59, "knn", "realtime"),
                           (108, "join", "window"),
                           (109, "join", "realtime")):
        c[opt] = CaseSpec(fam, "Point", "Polygon", mode, latency=True)
    # trajectory queries (StreamingJob.java:1163-1287)
    for base, fam in ((201, "tfilter"), (203, "trange"), (205, "tstats"),
                      (207, "taggregate"), (209, "tjoin"), (211, "tknn")):
        c[base] = CaseSpec(fam, mode="realtime")
        c[base + 1] = CaseSpec(fam, mode="window")
    for opt, fam in ((2030, "trange"), (2090, "tjoin"), (2011, "tknn")):
        c[opt] = CaseSpec(fam, mode="realtime", naive=True)
    c[99] = CaseSpec("synthetic")
    # ser/de conformance pipelines (StreamingJob.java:1289-1545): x01-x05
    # parse and re-serialize Point, Polygon, LineString, GeometryCollection
    # and MultiPoint records; 600 and 900 are the TAB-separated variants;
    # x06 plain CSV/TSV point rows
    types = ("Point", "Polygon", "LineString", "GeometryCollection",
             "MultiPoint")
    for base, fmt, ts in ((400, "GeoJSON", False), (500, "WKT", False),
                          (600, "WKT", False), (700, "GeoJSON", True),
                          (800, "WKT", True), (900, "WKT", True)):
        delim = "\t" if base in (600, 900) else None
        for j, t in enumerate(types, start=1):
            c[base + j] = CaseSpec("deser", t, fmt=fmt, timestamped=ts,
                                   delim=delim)
        c[base + 6] = CaseSpec("deser", "Point", fmt="TSV" if delim else "CSV",
                               timestamped=ts, delim=delim)
    # shapefile batch inputs (StreamingJob.java:1546-1569)
    c[1001] = CaseSpec("shapefile", "Point")
    c[1002] = CaseSpec("shapefile", "Polygon")
    c[1003] = CaseSpec("shapefile", "LineString")
    # the apps (StreamingJob.java:1619-1700): 1010 cell stay time over a
    # point stream, 1011 sensor-range intersection over a polygon stream,
    # 1012 the normalized stay time over both; 2000 check-in occupancy
    c[1010] = CaseSpec("staytime", "Point")
    c[1011] = CaseSpec("staytime", "Polygon")
    c[1012] = CaseSpec("staytime", "Point", "Polygon")
    c[2000] = CaseSpec("checkin")
    return c


_TRAJECTORY = ("tfilter", "trange", "tstats", "taggregate", "tjoin", "tknn")


CASES = _build_cases()


class ChunkedStream:
    """A decoded stream as the window assembler consumes it: :meth:`chunks`
    yields decoded chunks (columnar :class:`PointChunk` s of a point
    stream, :class:`GeomChunk` s of a polygon/linestring stream)."""

    __slots__ = ("_chunks",)

    def __init__(self, chunks: Iterator):
        self._chunks = chunks

    def chunks(self) -> Iterator:
        return self._chunks


def _decode_chunk_env(default: int) -> int:
    """The windowed decode chunk, or ``SPATIALFLINK_DECODE_CHUNK`` when set
    (the JAX driver's knob: small chunks give record-granular checkpoint
    positions on small inputs)."""
    v = os.environ.get("SPATIALFLINK_DECODE_CHUNK")
    return max(1, int(v)) if v else default


def _governed_chunk(dchunk: int, pinned: bool = False):
    """The decode chunk's actuator seam: a per-flush size callback that
    reads the installed chunk governor (``--controller``) at each buffer
    start, so the wiring order does not matter and a governor installed
    mid-run takes effect at the next flush; without one the callback
    returns ``dchunk``. A ``pinned`` size (count windows' step alignment)
    and ``SPATIALFLINK_DECODE_CHUNK`` stay fixed ints."""
    if pinned or os.environ.get("SPATIALFLINK_DECODE_CHUNK"):
        return dchunk
    from spatialflink_tpu_torch.runtime.control import active_governor

    def _resolve() -> int:
        gov = active_governor()
        return gov.chunk() if gov is not None else dchunk
    return _resolve


def _stream_interner(params: Params, side: int, stream) -> IdInterner:
    """The decode interner of stream ``side``: the source's own (the Kafka
    commit tap's) or a new one. Under a checkpoint coordinator it is the
    component ``decode-interner:<side>``, restored in place, so a resumed
    run numbers ids as the uninterrupted run did (kNN ties follow them);
    a manifest without it (the JAX package's) leaves a new interner."""
    interner = getattr(stream, "interner", None) or IdInterner()
    coord = getattr(params, "checkpointer", None)
    if coord is not None:
        coord.register(f"decode-interner:{side}",
                       lambda: ({}, {"ids": interner.to_list()}),
                       lambda _arrays, meta: interner.restore(meta["ids"]))
    return interner


def _decode_chunk(raws: List, cfg: StreamConfig, grid: UniformGrid,
                  interner: IdInterner) -> PointChunk:
    """One chunk of raw records -> a :class:`PointChunk`. A chunk of
    CSV/TSV/GeoJSON lines is one native parser call; it takes the
    per-record parse instead, as the JAX package's ``parse_raws`` does,
    when a line holds an interior newline, when the parser refuses a row
    (a record that is not a point), or when the parse does not give one
    row per line."""
    fmt = cfg.format.lower()
    if fmt in ("csv", "tsv", "geojson") and all(isinstance(r, str)
                                                for r in raws):
        lines = [r[:-1] if r.endswith("\n") else r for r in raws]
        if not any("\n" in r for r in lines):
            data = "\n".join(lines).encode()
            try:
                if fmt == "geojson":
                    parsed = bulk.bulk_parse_geojson(
                        data, interner=interner, **cfg.geojson_kwargs())
                else:
                    parsed = bulk.bulk_parse_csv(
                        data, delimiter="\t" if fmt == "tsv"
                        else cfg.delimiter, schema=cfg.csv_tsv_schema,
                        date_format=cfg.date_format, interner=interner)
            except ValueError:
                parsed = None
            if parsed is not None and len(parsed) == len(raws):
                return PointChunk.build(parsed, grid)
    return PointChunk.build(bulk.parse_points(raws, cfg, interner), grid)


def _off_type_warner(geometry: str):
    """Warns when :attr:`decode_chunks.off_type_dropped` first moves and
    again at each decade (1, 10, 100, ...), with the running count, as the
    JAX driver's ``_off_type_warner`` does."""
    state = {"next": 1}

    def warn(typename: str) -> None:
        c = decode_chunks.off_type_dropped
        if c >= state["next"]:
            print(f"warning: dropping off-type {typename} record(s) from "
                  f"declared {geometry} stream (off-type-dropped={c})",
                  file=sys.stderr)
            while state["next"] <= c:
                state["next"] *= 10
    return warn


def _decode_geoms(raws: List, cfg: StreamConfig, grid: UniformGrid,
                  geometry: str, warn) -> Optional[GeomChunk]:
    """One chunk of a polygon/linestring stream, parsed record by record
    (``parse_spatial``; parsed objects pass through); records without edges
    (points, multi-points, collections) are dropped and counted. None when
    nothing is left."""
    kept = []
    for rec in raws:
        obj = rec if isinstance(rec, SpatialObject) else parse_spatial(
            rec, cfg.format, grid, delimiter=cfg.delimiter,
            schema=cfg.csv_tsv_schema, geometry=geometry,
            **cfg.geojson_kwargs())
        if isinstance(obj, _EdgeGeom):
            kept.append(obj)
        else:
            decode_chunks.off_type_dropped += 1
            metrics.REGISTRY.counter("off-type-dropped").inc()
            warn(type(obj).__name__)
    return GeomChunk(kept) if kept else None


def decode_chunks(records: Iterable, cfg: StreamConfig, grid: UniformGrid,
                  chunk=4096, geometry: str = "Point",
                  interner: Optional[IdInterner] = None) -> Iterator:
    """Raw records (CSV/TSV lines, GeoJSON str/dict, WKT lines, or parsed
    objects) -> decoded chunks of up to ``chunk`` records, cells assigned
    on ``grid``: :class:`PointChunk` s of a point stream, object ids
    interned in one id space (``interner``, or a new one);
    :class:`GeomChunk` s of a ``geometry`` ("Polygon" or "LineString")
    stream, off-type records dropped. A source that decodes on its own
    (``.chunks()``: the Kafka commit tap) passes its chunks through.

    A control tuple (``utils.metrics.check_exit_control_tuple``) stops the
    stream where it stands: the records before it are decoded and handed
    on, then :class:`ControlTupleExit` propagates. A shutdown request
    (SIGTERM) does the same after the record in hand, as
    :class:`GracefulShutdown`.

    ``chunk`` is an int or a zero-argument size callback (the chunk
    governor's actuator, :func:`_governed_chunk`): a callback is read once
    at each buffer start, so a resize lands between chunks, never inside
    one.

    The registry's ``ingest-throughput`` meter marks every record and
    ``off-type-dropped`` counts the dropped ones; with a telemetry session
    each chunk's decode is one ``ingest`` observation and sets the
    ``decode.buffer-depth`` gauge."""
    from spatialflink_tpu_torch.utils import telemetry as _telemetry

    meter = metrics.REGISTRY.meter("ingest-throughput")
    metrics.REGISTRY.counter("off-type-dropped")
    tel = _telemetry.active()
    depth_gauge = (tel.gauge("decode.buffer-depth")
                   if tel is not None else None)
    src_chunks = getattr(records, "chunks", None)
    if src_chunks is not None:
        for ch in src_chunks():
            meter.mark(len(ch))
            if len(ch):
                yield ch
        return
    interner = interner if interner is not None else IdInterner()
    warn = _off_type_warner(geometry)

    def decode(buf):
        if tel is not None:
            t0 = time.perf_counter()
            depth_gauge.set(len(buf))
        if geometry == "Point":
            out = _decode_chunk(buf, cfg, grid, interner)
        else:
            out = _decode_geoms(buf, cfg, grid, geometry, warn)
        if tel is not None:
            # one ingest observation per chunk: the parse cost amortized
            tel.observe("ingest", time.perf_counter() - t0)
        meter.mark(len(buf))
        return out

    stop_requested = metrics.shutdown_requested
    chunk_fn = chunk if callable(chunk) else None
    size = chunk if chunk_fn is None else 1
    buf: List = []
    for rec in records:
        if not isinstance(rec, str) or '"control"' in rec:
            try:
                metrics.check_exit_control_tuple(rec)
            except metrics.ControlTupleExit:
                if buf:
                    out = decode(buf)
                    if out is not None:
                        yield out
                raise
        if chunk_fn is not None and not buf:
            size = max(1, int(chunk_fn()))
        buf.append(rec)
        if len(buf) >= size or stop_requested():
            out = decode(buf)
            if out is not None:
                yield out
            buf = []
            if stop_requested():
                raise metrics.GracefulShutdown(
                    "shutdown requested (SIGTERM): buffered records "
                    "drained")
    if buf:
        out = decode(buf)
        if out is not None:
            yield out


#: records dropped from polygon/linestring streams as off-type, since the
#: process started (the JAX package's ``off-type-dropped`` counter)
decode_chunks.off_type_dropped = 0


def _check_ported(params: Params, spec: CaseSpec) -> None:
    q = params.query
    for on, what in ((q.parallelism > 1, "query.parallelism > 1"),
                     (q.hosts > 1, "query.hosts > 1")):
        if on:
            raise NotImplementedError(f"{what}: {NOT_PORTED}")


def _query_conf(params: Params, spec: CaseSpec) -> QueryConfiguration:
    """Realtime options run micro-batches; ``window.type: COUNT`` takes
    interval and step as raw record counts (the reference hands the same
    values to ``countWindow`` unscaled); otherwise time windows."""
    size_ms, step_ms = params.window_ms()
    if spec.mode == "realtime":
        qt = QueryType.RealTime
    elif params.window.type == "COUNT":
        qt = QueryType.CountBased
        size_ms = int(params.window.interval_s)
        step_ms = int(params.window.step_s)
    else:
        qt = QueryType.WindowBased
    return QueryConfiguration(
        query_type=qt,
        window_size_ms=size_ms,
        slide_ms=step_ms,
        allowed_lateness_ms=params.query.allowed_lateness_s * 1000,
        approximate=params.query.approximate,
        panes=params.query.panes,
        pane_device_merge=params.query.pane_device_merge,
        k=params.query.k,
        checkpointer=getattr(params, "checkpointer", None),
        # --adaptive-grid: the run's AdaptiveGrid, whose leaf masks drive
        # the point-stream range operators' prefilter
        adaptive_grid=getattr(params, "adaptive_grid", None),
    )


def _query_objects(params: Params, grid: UniformGrid, kind: str) -> list:
    """Every configured query object of ``kind``; raises when there is
    none."""
    getter, name = {
        "Point": (params.query_point_objects, "queryPoints"),
        "Polygon": (params.query_polygon_objects, "queryPolygons"),
        "LineString": (params.query_linestring_objects, "queryLineStrings"),
    }[kind]
    objs = getter(grid)
    if not objs:
        raise ValueError(f"query.{name} is empty")
    return objs


def _run_multi_case(params: Params, spec: CaseSpec, op, s1,
                    u_grid: UniformGrid, radius: float) -> Iterator:
    """``query.multiQuery``: answer ALL configured query objects in one
    dispatch per window via ``run_multi`` (without the flag only the first
    query object runs, as the reference does)."""
    if spec.latency:
        raise ValueError(
            "multiQuery does not combine with the latency variants "
            "(per-record latency assumes single-query record lists)")
    qs = _query_objects(params, u_grid, spec.query)
    if spec.family == "range":
        return op.run_multi(s1, qs, radius)
    return op.run_multi(s1, qs, radius, params.query.k)


def _with_latency(results: Iterator[WindowResult]
                  ) -> Iterator[WindowResult]:
    """Annotate each result with its records' latency in ms, ``now -
    ingestion time`` (the reference ships the same to a Kafka topic,
    ``HelperClass.java:455-529``); a record's ingestion time is its decode
    chunk's stamp, and a join pair's is its first record's. kNN records
    are (objID, distance) pairs with no ingestion time, so their list is
    empty. With a telemetry session the values also feed the
    ``record-latency-ms`` histogram."""
    from spatialflink_tpu_torch.utils import telemetry as _telemetry

    tel = _telemetry.active()
    hist = tel.histogram("record-latency-ms") if tel is not None else None
    for r in results:
        now = int(time.time() * 1000)
        cols = getattr(r.records, "columns", None)
        first = getattr(r.records, "first_ingest", None)
        ingest = (cols()[5] if cols is not None else
                  first() if first is not None else None)
        lats = [] if ingest is None else (now - ingest[ingest > 0]).tolist()
        if hist is not None:
            for v in lats:
                hist.record(v)
        r.extras["latency_ms"] = lats
        yield r


def run_option(params: Params, stream1: Iterable,
               stream2: Optional[Iterable] = None, *, device="cuda"
               ) -> Iterator[WindowResult]:
    """Wire and run the pipeline of ``params.query.option`` over
    ``stream1`` (and, for a join, the query stream ``stream2``; raw
    records or parsed objects) on ``device``; returns the window-result
    iterator."""
    opt = params.query.option
    spec = CASES.get(opt)
    if spec is None:
        raise NotImplementedError(
            f"queryOption {opt}: {NOT_PORTED} (ported: "
            f"{', '.join(map(str, sorted(CASES)))})")
    _check_ported(params, spec)
    if params.query.multi_query and spec.family not in ("range", "knn",
                                                        "tknn"):
        raise ValueError(
            f"multiQuery is not supported for queryOption {opt} "
            f"({spec.family}); supported: all nine range and kNN pairs, "
            "plus trajectory kNN (211/212)")
    u_grid, q_grid = params.grids()
    if spec.family in ("deser", "shapefile", "staytime", "checkin"):
        return _run_host_case(params, spec, _query_conf(params, spec), u_grid,
                              stream1, stream2, device)
    if spec.family in _TRAJECTORY:
        return _run_trajectory(params, spec, _query_conf(params, spec),
                               u_grid, q_grid, stream1, stream2, device)
    if spec.family == "synthetic":
        return _run_synthetic(params, _query_conf(params, spec), u_grid,
                              device)
    fam = {"range": "Range", "knn": "KNN", "join": "Join"}[spec.family]
    cls = getattr(ops, f"{spec.stream}{spec.query}{fam}Query")
    conf = _query_conf(params, spec)
    if spec.family == "join":
        op = cls(conf, u_grid, q_grid, device=device)
        if stream2 is None:
            raise ValueError(f"queryOption {opt} (join) needs stream2")
    else:
        op = cls(conf, u_grid, device=device)
    # decode chunks: a realtime chunk is one micro-batch, a count window's
    # at most one slide (pinned: fires stay step-aligned), otherwise 4,096
    # records; the chunk governor, when installed, sizes the first and the
    # last per flush (the micro-batcher cuts every realtime_batch_size
    # records whatever the chunk)
    if conf.query_type is QueryType.RealTime:
        chunk = _governed_chunk(max(1, conf.realtime_batch_size))
    elif conf.query_type is QueryType.CountBased:
        chunk = _governed_chunk(max(1, min(4096, conf.slide_ms)),
                                pinned=True)
    else:
        chunk = _governed_chunk(_decode_chunk_env(4096))
    s1 = ChunkedStream(decode_chunks(
        stream1, params.input1, u_grid, chunk, geometry=spec.stream,
        interner=_stream_interner(params, 1, stream1)))
    radius = params.query.radius
    if spec.family == "join":
        s2 = ChunkedStream(decode_chunks(
            stream2, params.input2, q_grid, chunk, geometry=spec.query,
            interner=_stream_interner(params, 2, stream2)))
        out = op.run(s1, s2, radius)
        return _with_latency(out) if spec.latency else out
    registry = getattr(params, "query_registry", None)
    if registry is not None:
        # the dynamic plane: the live registry, not the config, says what
        # runs (changes land at window boundaries)
        if spec.family == "knn":
            return op.run_dynamic(s1, registry, radius, params.query.k)
        return op.run_dynamic(s1, registry, radius)
    if params.query.multi_query:
        return _run_multi_case(params, spec, op, s1, u_grid, radius)
    q = _query_objects(params, u_grid, spec.query)[0]
    if spec.family == "knn":
        out = op.run(s1, q, radius, params.query.k)
    else:
        out = op.run(s1, q, radius)
    return _with_latency(out) if spec.latency else out


def _read_src(src) -> Optional[bytes]:
    """A bulk input as bytes: a file path, or a zero-argument reader (the
    ``--kafka --bulk`` topic drain, called only once the case and format
    gates passed); a reader's None means it cannot take the bulk path."""
    if callable(src):
        return src()
    with open(src, "rb") as f:
        return f.read()


def _bulk_parse_stream(cfg: StreamConfig, path,
                       allowed_lateness_s: int):
    """One point stream's whole file in one native parse, late records
    dropped as the record path drops them (``bulk_keep_mask``); None,
    with a note, when the file cannot take the bulk path (a record of
    another geometry type in a declared point stream)."""
    fmt = cfg.format.lower()
    if fmt not in ("csv", "tsv", "geojson"):
        return None
    data = _read_src(path)
    if data is None:
        return None
    try:
        if fmt in ("csv", "tsv"):
            parsed = bulk.bulk_parse_csv(
                data, delimiter="\t" if fmt == "tsv" else cfg.delimiter,
                schema=cfg.csv_tsv_schema, date_format=cfg.date_format)
        else:
            parsed = bulk.bulk_parse_geojson(data, **cfg.geojson_kwargs())
    except ValueError as e:
        print(f"# --bulk: point stream not bulk-ingestible ({e}); "
              "using the record path", file=sys.stderr)
        return None
    keep = BoundedOutOfOrderness.bulk_keep_mask(parsed.ts,
                                                allowed_lateness_s * 1000)
    if not keep.all():
        parsed = dataclasses.replace(
            parsed, x=parsed.x[keep], y=parsed.y[keep], ts=parsed.ts[keep],
            obj_id=parsed.obj_id[keep])
    return parsed


def _bulk_parse_geom_stream(params: Params, path: str):
    """Stream 1's whole WKT or GeoJSON polygon/linestring file in one
    native parse, late records dropped; None, with a note, when it holds a
    geometry the bulk path does not take (a point or a collection)."""
    cfg = params.input1
    wkt = cfg.format.lower() == "wkt"
    kw = (dict(delimiter=cfg.delimiter, date_format=cfg.date_format) if wkt
          else cfg.geojson_kwargs())
    data = _read_src(path)
    if data is None:
        return None
    try:
        parsed = (bulk.bulk_parse_wkt(data, **kw) if wkt
                  else bulk.bulk_parse_geojson_geoms(data, **kw))
    except ValueError as e:
        print(f"# --bulk: geometry file not bulk-ingestible ({e}); "
              "using the record path", file=sys.stderr)
        return None
    keep = BoundedOutOfOrderness.bulk_keep_mask(
        parsed.ts, params.query.allowed_lateness_s * 1000)
    if not keep.all():
        parsed = parsed.subset(np.nonzero(keep)[0])
    return parsed


def run_option_bulk(params: Params, input_path: str,
                    input_path2: Optional[str] = None, *, device="cuda"
                    ) -> Optional[Iterator[WindowResult]]:
    """The whole-file replay of ``--bulk`` (the JAX driver's
    ``run_option_bulk``): windowed range and kNN over a CSV/TSV/GeoJSON
    point file or a WKT/GeoJSON polygon or linestring file (multiQuery
    too), and the windowed point x point join over two point files; one
    native parse per file, the windows assembled at once, the kernels on
    ``device``. Results are original-record index lists (kNN: (objID,
    distance) pairs; joins: index pairs). None where the case or format
    takes the record path (realtime, count windows, the latency variants,
    other families and formats, a file that is not bulk-ingestible)."""
    spec = CASES.get(params.query.option)
    if spec is None or spec.mode != "window" or spec.latency:
        return None
    if params.window.type == "COUNT":
        return None
    if spec.family not in ("range", "knn", "join"):
        return None
    _check_ported(params, spec)
    fam = {"range": "Range", "knn": "KNN", "join": "Join"}[spec.family]
    cls = getattr(ops, f"{spec.stream}{spec.query}{fam}Query")
    radius, k = params.query.radius, params.query.k
    geom_stream = spec.stream in ("Polygon", "LineString")
    lateness = params.query.allowed_lateness_s
    if params.query.multi_query:
        if spec.family == "join":
            return None
        u_grid, _ = params.grids()
        # checked before the parse, as the record path does
        qs = _query_objects(params, u_grid, spec.query)
        if geom_stream:
            if params.input1.format.lower() not in ("wkt", "geojson"):
                return None
            parsed = _bulk_parse_geom_stream(params, input_path)
        else:
            parsed = _bulk_parse_stream(params.input1, input_path, lateness)
        if parsed is None:
            return None
        op = cls(_query_conf(params, spec), u_grid, device=device)
        if spec.family == "range":
            return op.run_multi_bulk(parsed, qs, radius)
        return op.run_multi_bulk(parsed, qs, radius, k)
    if geom_stream:
        if (spec.family == "join"
                or params.input1.format.lower() not in ("wkt", "geojson")):
            return None
        parsed = _bulk_parse_geom_stream(params, input_path)
    else:
        if spec.family == "join":
            if spec.query != "Point":
                return None
            # both sides' formats before any parse
            if (input_path2 is None or params.input2.format.lower()
                    not in ("csv", "tsv", "geojson")):
                return None
        parsed = _bulk_parse_stream(params.input1, input_path, lateness)
    if parsed is None:
        return None
    u_grid, _ = params.grids()
    conf = _query_conf(params, spec)
    if spec.family == "join":
        parsed2 = _bulk_parse_stream(params.input2, input_path2, lateness)
        if parsed2 is None:
            return None
        return cls(conf, u_grid, u_grid, device=device).run_bulk(
            parsed, parsed2, radius)
    q = _query_objects(params, u_grid, spec.query)[0]
    op = cls(conf, u_grid, device=device)
    if spec.family == "range":
        return op.run_bulk(parsed, q, radius)
    return op.run_bulk(parsed, q, radius, k)


def _run_host_case(params: Params, spec: CaseSpec, conf, u_grid, stream1,
                   stream2, device) -> Iterator:
    """The host-only options (the JAX driver's ``run_option`` branches):
    the ser/de pipelines, the shapefile inputs (``stream1`` a ``.shp`` path
    or paths) and the apps. None of them launches a kernel."""
    if spec.family == "deser":
        return _run_deser(params, spec, u_grid, stream1)
    if spec.family == "shapefile":
        from spatialflink_tpu_torch.streams.shapefile import read_shapefile

        paths = ([stream1] if isinstance(stream1, (str, bytes))
                 else list(stream1))
        return iter([obj for p in paths for obj in read_shapefile(p, u_grid)])
    if spec.family == "checkin":
        from spatialflink_tpu_torch.apps import CheckIn

        # raw DEIM CSV lines (eventID,deviceID,userID,ts,x,y) parse in the
        # app; parsed Points pass through
        return CheckIn(conf, device=device).run(stream1)
    from spatialflink_tpu_torch.apps import StayTime

    app = StayTime(conf, u_grid, device=device)
    traj_ids = set(params.query.traj_ids) or None
    if spec.query == "Polygon":  # 1012: point stream + polygon stream
        if stream2 is None:
            raise ValueError("queryOption 1012 needs a polygon stream2")
        s1 = ChunkedStream(decode_chunks(stream1, params.input1, u_grid))
        # both sides in the app's grid (the reference passes one uGrid,
        # StreamingJob.java:1667); query.trajIDs names trajectories, so
        # the sensor side is never filtered by it
        s2 = ChunkedStream(decode_chunks(stream2, params.input2, u_grid,
                                         geometry="Polygon"))
        return app.normalized_cell_stay_time(
            s1, s2, traj_ids_points=traj_ids, traj_ids_sensors=None)
    s1 = ChunkedStream(decode_chunks(stream1, params.input1, u_grid,
                                     geometry=spec.stream))
    if spec.stream == "Polygon":  # 1011: sensor-range intersection
        return app.cell_sensor_range_intersection(s1, traj_ids)
    return app.cell_stay_time(s1, traj_ids)


def _run_deser(params: Params, spec: CaseSpec, grid, stream1) -> Iterator:
    """Each record parsed in the case's format and written again, as
    ``(object, serialized)`` (the reference's parse -> print -> produce
    conformance path, ``StreamingJob.java:1289-1545``)."""
    fmt = spec.fmt
    delim = spec.delim or ("\t" if fmt == "TSV"
                           else params.input1.delimiter or ",")
    for rec in stream1:
        obj = rec if isinstance(rec, SpatialObject) else parse_spatial(
            rec, fmt, grid, delimiter=delim,
            schema=params.input1.csv_tsv_schema,
            date_format=params.input1.date_format)
        yield obj, serialize_spatial(
            obj, fmt, delimiter=delim,
            date_format=params.input1.date_format if spec.timestamped
            else None)


def _run_trajectory(params: Params, spec: CaseSpec, conf, u_grid, q_grid,
                    stream1, stream2, device) -> Iterator[WindowResult]:
    """The trajectory options: stream 1 decoded in chunks of a micro-batch
    (realtime) or 4,096 records, the operator of the family on ``device``
    (the JAX driver's ``_run_trajectory``)."""
    chunk = _governed_chunk(conf.realtime_batch_size
                            if spec.mode == "realtime" else 4096)
    s1 = ChunkedStream(decode_chunks(
        stream1, params.input1, u_grid, chunk,
        interner=_stream_interner(params, 1, stream1)))
    q = params.query
    if spec.family == "tfilter":
        return ops.PointTFilterQuery(conf, u_grid, device=device).run(
            s1, set(q.traj_ids))
    if spec.family == "trange":
        polys = params.query_polygon_objects(u_grid)
        op = ops.PointPolygonTRangeQuery(conf, u_grid, device=device)
        return op.run_naive(s1, polys) if spec.naive else op.run(s1, polys)
    # the legacy single-file --checkpoint of realtime tStats / tAggregate
    ckpt = dict(checkpoint_path=getattr(params, "checkpoint_path", None),
                checkpoint_every=getattr(params, "checkpoint_every", 16),
                checkpoint_job=getattr(params, "checkpoint_job", None))
    if spec.family == "tstats":
        return ops.PointTStatsQuery(conf, u_grid, device=device).run(
            s1, set(q.traj_ids) or None, **ckpt)
    if spec.family == "taggregate":
        return ops.PointTAggregateQuery(conf, u_grid, device=device).run(
            s1, q.aggregate_function,
            traj_deletion_threshold_ms=q.traj_deletion_threshold_s * 1000,
            **ckpt)
    if spec.family == "tjoin":
        if stream2 is None:
            raise ValueError("trajectory join needs stream2")
        s2 = ChunkedStream(decode_chunks(
            stream2, params.input2, q_grid, chunk,
            interner=_stream_interner(params, 2, stream2)))
        op = ops.PointPointTJoinQuery(conf, u_grid, q_grid, device=device)
        run = op.run_naive if spec.naive else op.run
        return run(s1, s2, q.radius)
    op = ops.PointPointTKNNQuery(conf, u_grid, device=device)
    if q.multi_query:
        if spec.naive:
            raise ValueError(
                "multiQuery does not combine with the naive-twin tKnn "
                "(the oracle exists to check the pruned single path)")
        return op.run_multi(s1, _query_objects(params, u_grid, "Point"),
                            q.radius, q.k)
    qp = _query_objects(params, u_grid, "Point")[0]
    run = op.run_naive if spec.naive else op.run
    return run(s1, qp, q.radius, q.k)


def _run_synthetic(params: Params, conf, grid, device
                   ) -> Iterator[WindowResult]:
    """queryOption 99: all six trajectory families over deterministic
    synthetic trajectories (16 of 8 steps, seed 7), as the reference's
    harness sketched them against ``env.fromCollection``
    (``StreamingJob.java:1571-1618``); each result is tagged with its
    family in ``extras["family"]`` (the JAX driver's ``_run_synthetic``)."""
    from spatialflink_tpu_torch.models import Polygon
    from spatialflink_tpu_torch.streams.sources import (
        SyntheticPointSource, generate_query_polygons)

    def src():
        return SyntheticPointSource(grid, num_trajectories=16, steps=8,
                                    seed=7)

    def tagged(family, it):
        for r in it:
            r.extras.setdefault("family", family)
            yield r

    first = list(src())
    traj_ids = {p.obj_id for p in first[:4]}
    qp = first[0]
    # a query polygon over the middle of the grid (it has matches) and
    # cell-sized tiles (generate_query_polygons): the polygon set tRange
    # takes
    cx = (grid.min_x + grid.max_x) / 2
    cy = (grid.min_y + grid.max_y) / 2
    dx = (grid.max_x - grid.min_x) / 4
    dy = (grid.max_y - grid.min_y) / 4
    qpoly = Polygon.create(
        [[(cx - dx, cy - dy), (cx + dx, cy - dy), (cx + dx, cy + dy),
          (cx - dx, cy + dy)]], grid)
    qpolys = [qpoly] + generate_query_polygons(8, grid)
    kw = dict(device=device)
    yield from tagged("tfilter", ops.PointTFilterQuery(conf, grid, **kw).run(
        src(), traj_ids))
    yield from tagged("trange", ops.PointPolygonTRangeQuery(
        conf, grid, **kw).run(src(), qpolys))
    yield from tagged("tstats", ops.PointTStatsQuery(conf, grid, **kw).run(
        src()))
    yield from tagged("taggregate", ops.PointTAggregateQuery(
        conf, grid, **kw).run(src(), params.query.aggregate_function))
    # radius 0 means unset in the config; tJoin's and tKnn's radius tests
    # emit nothing at 0, so the harness takes half a degree instead
    radius = params.query.radius if params.query.radius > 0 else 0.5
    yield from tagged("tjoin", ops.PointPointTJoinQuery(
        conf, grid, grid, **kw).run(src(), src(), radius))
    yield from tagged("tknn", ops.PointPointTKNNQuery(conf, grid, **kw).run(
        src(), qp, radius, params.query.k))


def _dynamic_error(params: Params, spec: CaseSpec) -> Optional[str]:
    """Why ``--queries-file`` cannot serve this case (the JAX driver's
    eligibility checks and messages), or None."""
    if (spec.family not in ("range", "knn") or spec.query != "Point"
            or (spec.family == "knn" and spec.stream != "Point")):
        return ("--queries-file/--control-topic (the dynamic "
                "standing-query plane) serve point-query fleets: "
                "windowed range over any stream type, and Point/Point "
                f"kNN — not queryOption {params.query.option} "
                f"({spec.family}, {spec.stream}x{spec.query})")
    if spec.mode != "window" or params.window.type == "COUNT":
        return ("the dynamic standing-query plane runs event-time "
                "windowed cases only (the fleet changes at window "
                "boundaries)")
    if spec.latency:
        return ("the dynamic standing-query plane does not combine "
                "with the latency variants (per-record latency "
                "assumes single-query record lists)")
    if params.query.multi_query:
        return ("--multi-query is subsumed by the query registry "
                "(the live fleet IS the multi-query set); drop the "
                "flag")
    return None


def _seed_registry(params: Params, spec: CaseSpec, path: Optional[str],
                   registry=None):
    """The fleet of ``--queries-file``: the file's specs (none without a
    file), else the config's ``queryPoints`` (ids q0, q1, ...), admitted
    into ``registry`` (or a new one) and applied before the first window.
    Raises ValueError (or OSError) with the JAX driver's
    ``--queries-file:`` messages."""
    from spatialflink_tpu_torch.runtime.queryplane import (QueryRegistry,
                                                           QuerySpec,
                                                           QuerySpecError,
                                                           load_queries_file)

    if registry is None:
        registry = QueryRegistry(spec.family, radius=params.query.radius,
                                 k=params.query.k)
    lclass = registry.default_latency_class
    seeds = []
    try:
        if path:
            seeds = load_queries_file(
                path, spec.family, default_latency_class=lclass,
                default_tenant=registry.default_tenant)
    except (OSError, ValueError) as e:
        raise ValueError(f"--queries-file: {e}") from e
    if not seeds and params.query.query_points:
        # the config's queryPoints: the run's latency class, the default
        # tenant (as the JAX driver seeds them)
        seeds = [QuerySpec(id=f"q{i}", family=spec.family, x=x, y=y,
                           latency_class=lclass)
                 for i, (x, y) in enumerate(params.query.query_points)]
    try:
        for s in seeds:
            registry.admit(s)
    except QuerySpecError as e:
        raise ValueError(f"--queries-file: {e}") from e
    registry.apply()  # seeds serve from the first window
    return registry


def _limited(lines: Iterator[str], limit: Optional[int]) -> Iterator[str]:
    """The first ``limit`` records of a replay (``--limit``; all of them
    when None, none at 0)."""
    return lines if limit is None else itertools.islice(lines, limit)


def _emit(result, sink) -> None:
    if not isinstance(result, WindowResult):  # ser/de, shapefile, check-in
        sink.emit(result)
        return
    if "queries" in result.extras:
        # multi-query windows: records is a list of Q per-query lists
        counts = {"count": sum(len(r) for r in result.records),
                  "per_query_counts": [len(r) for r in result.records]}
    else:
        counts = {"count": len(result.records)}
    sink.emit({"window": [result.window_start, result.window_end],
               **counts, **{k: v for k, v in result.extras.items()
                            if k != "latency_ms"}})


# ------------------------------------------------------------------------ #
# checkpoints and the Kafka topology


#: the (family, mode) pairs whose drive loops register all their
#: cross-record state with the checkpoint coordinator and barrier between
#: processing units (the JAX driver's lists); a checkpoint that missed live
#: state would lose records on resume, so the others are refused
_CKPT_WINDOW_FAMILIES = ("range", "knn", "join", "tfilter", "trange",
                         "tstats", "taggregate")
_CKPT_REALTIME_FAMILIES = ("range", "knn", "tstats", "taggregate")


def _checkpoint_dir_unsupported(params: Params,
                                spec: CaseSpec) -> Optional[str]:
    """None when ``--checkpoint-dir`` covers the case; else why not (the
    driver warns and runs without the coordinator)."""
    if spec.naive:
        return "naive-twin oracles keep the plain path"
    if spec.mode == "window":
        if params.window.type == "COUNT":
            return ("count windows buffer by arrival order outside the "
                    "checkpointable assemblers")
        if spec.family not in _CKPT_WINDOW_FAMILIES:
            return (f"windowed {spec.family} has no registered "
                    "checkpoint state")
        return None
    if spec.family not in _CKPT_REALTIME_FAMILIES:
        return (f"realtime {spec.family} keeps cross-batch state outside "
                "the checkpointable participants")
    return None


def _kafka_bulk_decode(cfg: StreamConfig, grid: UniformGrid):
    """The chunked native decode of a broker-fed point stream
    (CSV/TSV/GeoJSON): raw records -> a :class:`PointChunk` in one parser
    call, ids interned through ``decode.interner``; None for another
    format (the commit tap then parses record by record). A rejected row
    raises ValueError, and the tap takes the per-record parse."""
    fmt = cfg.format.lower()
    if fmt not in ("csv", "tsv", "geojson"):
        return None
    interner = IdInterner()

    def decode(raws: List[str]) -> PointChunk:
        data = "\n".join(raws).encode()
        if fmt == "geojson":
            parsed = bulk.bulk_parse_geojson(data, interner=interner,
                                             **cfg.geojson_kwargs())
        else:
            parsed = bulk.bulk_parse_csv(
                data, delimiter="\t" if fmt == "tsv" else cfg.delimiter,
                schema=cfg.csv_tsv_schema, date_format=cfg.date_format,
                interner=interner)
        return PointChunk.build(parsed, grid)

    decode.interner = interner
    return decode


def _parse_fn(cfg: StreamConfig, grid: UniformGrid, geometry: str):
    """The per-record parse of the decode, as a callable (the commit tap
    parses before the pipeline, to read event times)."""
    def parse(rec):
        if isinstance(rec, SpatialObject):
            return rec
        return parse_spatial(rec, cfg.format, grid, delimiter=cfg.delimiter,
                             schema=cfg.csv_tsv_schema, geometry=geometry,
                             **cfg.geojson_kwargs())
    return parse


def _preproduce(broker, topic: str, path: str, limit: Optional[int]) -> None:
    """Produce the file to the topic exactly once across restarts: records
    already in the topic count as the file's prefix (the topic is fed by
    this file alone), so the same command run again after a crash, even
    one inside the produce, resumes at the first missing record."""
    have = broker.end_offset(topic)
    lim = None if limit is None else max(0, limit - have)
    n = 0
    for line in _limited(itertools.islice(file_lines(path), have, None),
                         lim):
        broker.produce(topic, line)
        n += 1
    if have and n:
        print(f"# topic '{topic}' already held {have} records (interrupted "
              f"produce?); resumed {path} from record {have} (+{n})",
              file=sys.stderr)
    elif have:
        print(f"# topic '{topic}' already holds {have} records; NOT "
              f"re-producing {path} (restart detected — consumption resumes "
              "from the group's committed offset)", file=sys.stderr)
    else:
        print(f"# produced {n} records from {path} -> topic '{topic}'",
              file=sys.stderr)


#: the families whose time-windowed pipelines run the shared event-time
#: assemblers: window-aligned offset commits and the marker-keyed sink
#: (the apps and ser/de commit only when the topic is drained)
_KAFKA_WINDOWED_FAMILIES = ("range", "knn", "join", "tfilter", "trange",
                            "tstats", "taggregate", "tjoin", "tknn")


@dataclass
class _KafkaWiring:
    """The broker-backed I/O of a ``--kafka`` run: the sources (behind
    their commit taps), the marker-keyed window sink, the plain record
    sink and the latency topic (``StreamingJob.java:473,512``,
    ``HelperClass.java:455-529``)."""

    broker: object
    stream1: Iterable
    stream2: Optional[Iterable]
    sources: List
    taps: List
    win_sink: Optional[object]
    plain_sink: object
    latency_topic: str
    group: str
    #: realtime range / kNN: every emitted result commits the position
    #: minus this lag (a record further behind the read head than
    #: pipeline_depth + 1 micro-batches is in an emitted batch), bounding
    #: a restart's replay
    commit_lag: Optional[int] = None
    #: the ``--kafka --bulk`` drain's (topic, next offset) pairs, which
    #: :meth:`finish` commits (the sources were never iterated)
    bulk_offsets: Optional[List] = None

    def emit(self, result) -> None:
        """Produce one result, then advance the window-aligned commits
        (produce before commit: at-least-once)."""
        suppressed = False
        if isinstance(result, WindowResult) and self.win_sink is not None:
            before = self.win_sink.duplicates_suppressed
            self.win_sink.emit(result)
            suppressed = self.win_sink.duplicates_suppressed > before
            for tap in self.taps:
                tap.on_window_emitted(result.window_end)
        elif isinstance(result, WindowResult):
            for rec in result.flat_records():
                self.plain_sink.emit(rec)
        elif (isinstance(result, tuple) and len(result) == 2
                and isinstance(result[0], SpatialObject)):
            self.plain_sink.emit(result[0])  # a ser/de (object, text) pair
        else:
            self.plain_sink.emit(result)
        lats = (result.extras.get("latency_ms")
                if isinstance(result, WindowResult) else None)
        if lats and not suppressed:
            for v in lats:
                self.broker.produce(self.latency_topic, v)
        if self.commit_lag is not None:
            for src in self.sources:
                src.commit_to(max(0, src.position - self.commit_lag))

    def finish(self) -> None:
        """The bounded input drained and flushed: every consumed record is
        reflected in the output, so the full positions commit (not after
        a control-tuple stop or a crash: the window-aligned commits
        stand)."""
        if self.bulk_offsets is not None:
            for topic, off in self.bulk_offsets:
                self.broker.commit(topic, self.group, off)
            return
        tapped = {id(t.source) for t in self.taps}
        for tap in self.taps:
            tap.commit_all()
        for src in self.sources:
            if id(src) not in tapped:
                src.commit_to(src.position)

    def summary(self) -> str:
        parts = []
        if self.win_sink is not None:
            parts.append(f"{self.win_sink.windows_produced} windows produced"
                         f" (+{self.win_sink.duplicates_suppressed} "
                         "re-delivered suppressed)")
        parts.append("committed " + ", ".join(
            f"{s.topic}@{s.broker.committed(s.topic, s.group)}"
            for s in self.sources))
        return "# kafka: " + "; ".join(parts)


def _topic_reader(kafka: _KafkaWiring, topic: str, limit: Optional[int],
                  offsets_out: List):
    """A lazy reader of one topic for :func:`run_option_bulk`: the group's
    committed offset to the end (within ``limit``) as newline-joined
    bytes, the range noted in ``offsets_out`` for the commit after the
    run; None (the record path) when a record cannot take the bulk path
    (not a string, a newline inside, a control tuple)."""
    from spatialflink_tpu_torch.streams.kafka import resequence_batch

    def drain() -> Optional[bytes]:
        b = kafka.broker
        off = b.committed(topic, kafka.group)
        end = b.end_offset(topic)
        if limit is not None:
            end = min(end, off + limit)
        vals: List[str] = []
        while off < end:
            batch = b.fetch(topic, off, min(65536, end - off))
            if not batch:
                break
            for r in resequence_batch(batch, off):
                v = r.value
                if not isinstance(v, str) or "\n" in v or '"control"' in v:
                    print(f"# --kafka --bulk: topic '{topic}' not "
                          "bulk-drainable (non-string/multiline/control "
                          "records); using the streaming path",
                          file=sys.stderr)
                    return None
                vals.append(v)
                off = r.offset + 1
        offsets_out.append((topic, off))
        return "\n".join(vals).encode()

    return drain


def _wire_kafka(params: Params, spec: CaseSpec, args, skip1: int
                ) -> _KafkaWiring:
    """The ``--kafka`` topology: the input files (if given) produced to the
    input topics, a resumed run's group sought to the checkpointed
    offsets, one source per input topic behind a commit tap (time-windowed
    families) or a checkpoint tap (realtime, under a coordinator), the
    marker-keyed window sink (time-windowed) and the plain sink."""
    from spatialflink_tpu_torch.runtime.checkpoint import CheckpointTap
    from spatialflink_tpu_torch.streams.kafka import (KafkaSink, KafkaSource,
                                                      KafkaWindowSink,
                                                      WindowCommitTap,
                                                      resolve_broker)

    bootstrap = args.kafka_bootstrap or params.kafka_bootstrap_servers
    group = args.kafka_group
    t1, t2 = params.input1.topic_name, params.input2.topic_name
    windowed = (spec.mode == "window" and params.window.type != "COUNT"
                and spec.family in _KAFKA_WINDOWED_FAMILIES)
    commit_lag = None
    if spec.mode == "realtime" and spec.family in ("range", "knn"):
        qc = _query_conf(params, spec)
        commit_lag = (max(1, qc.pipeline_depth) + 1) * qc.realtime_batch_size
    broker = resolve_broker(bootstrap)
    if args.input1:
        _preproduce(broker, t1, args.input1, args.limit)
    if args.input2:
        _preproduce(broker, t2, args.input2, args.limit)
    # the legacy checkpoint's skip, as an offset commit (monotone: an
    # older checkpoint never rewinds the group)
    if skip1:
        broker.commit(t1, group, skip1)
    coord = getattr(params, "checkpointer", None)
    if coord is not None and coord.restored:
        depth = 0
        for topic in dict.fromkeys([t1, t2]):
            pos = coord.position(f"kafka:{topic}", 0)
            if pos:
                broker.commit(topic, group, pos)
                depth += max(0, broker.end_offset(topic) - pos)
        print(f"# resume: consumer group sought to checkpointed offsets; "
              f"{depth} records past the checkpoint to (re)process",
              file=sys.stderr)
        from spatialflink_tpu_torch.utils import telemetry as _telemetry

        tel = _telemetry.active()
        if tel is not None:
            tel.gauge("recovery.replay-depth").set(depth)
    u_grid, q_grid = params.grids()
    size_ms, step_ms = params.window_ms()
    geom1 = spec.stream if spec.family in ("range", "knn", "join") \
        else "Point"
    geom2 = spec.query if spec.family == "join" else "Point"
    two_stream = (spec.family in ("join", "tjoin")
                  or (spec.family == "staytime" and spec.query == "Polygon"))
    src1 = KafkaSource(broker, t1, group, auto_commit=False,
                       limit=args.limit, commit_lag=commit_lag)
    sources = [src1]
    src2 = None
    if two_stream:
        src2 = KafkaSource(broker, t2, group, auto_commit=False,
                           limit=args.limit, commit_lag=commit_lag)
        sources.append(src2)
    # the chunk governor, when installed, sizes the tap's chunks per flush
    chunk = _governed_chunk(_decode_chunk_env(2048))
    taps: List = []
    stream1: Iterable = src1
    stream2: Optional[Iterable] = src2
    if windowed:
        sides = [(src1, params.input1, u_grid, geom1)]
        if src2 is not None:
            sides.append((src2, params.input2, q_grid, geom2))
        for src, cfg, grid, geom in sides:
            taps.append(WindowCommitTap(
                src, size_ms, step_ms, parse=_parse_fn(cfg, grid, geom),
                geometry=geom,
                bulk_decode=(_kafka_bulk_decode(cfg, grid)
                             if geom == "Point" else None),
                bulk_chunk=chunk, checkpointer=coord))
        stream1 = taps[0]
        stream2 = taps[1] if len(taps) > 1 else None
    elif coord is not None:
        # realtime: a pass-through tap notes the live source position at
        # each record hand-off, for the checkpoints
        stream1 = CheckpointTap(src1, coord, f"kafka:{t1}",
                                position_fn=lambda: src1.position)
        if src2 is not None:
            stream2 = CheckpointTap(src2, coord, f"kafka:{t2}",
                                    position_fn=lambda: src2.position)
    sink_kw = dict(fmt=args.output_format,
                   date_format=params.input1.date_format,
                   delimiter=params.output.delimiter)
    out = params.output.topic_name
    win_sink = (KafkaWindowSink(broker, out,
                                job_id=params.job_fingerprint(group),
                                seed_scan_limit=args.seed_scan_limit,
                                **sink_kw) if windowed else None)
    return _KafkaWiring(
        broker=broker, stream1=stream1, stream2=stream2, sources=sources,
        taps=taps, win_sink=win_sink,
        plain_sink=KafkaSink(broker, out, **sink_kw),
        latency_topic=out + "-latency", group=group, commit_lag=commit_lag)


# ------------------------------------------------------------------------ #
# CLI


def _make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="spatialflink-tpu-torch",
        description="spatial stream query driver on PyTorch/CUDA over "
                    "point, polygon and linestring streams: range options "
                    "1-42, kNN options 51-92 and join options 101-142 "
                    "(1 + 5i / 51 + 5i / 101 + 5i windowed, 2 + 5i / "
                    "52 + 5i / 102 + 5i realtime), latency variants 8, 9 "
                    "(range), 58, 59 (kNN) and 108, 109 (join); the "
                    "trajectory queries 201-212 (odd realtime, even "
                    "windowed: tFilter, tRange, tStats, tAggregate, tJoin, "
                    "tKNN; naive twins 2030, 2090, 2011) and the synthetic "
                    "harness 99; the ser/de options 401-906, the "
                    "shapefile inputs 1001-1003 and the apps 1010-1012 "
                    "and 2000; window.type TIME or COUNT (COUNT not for "
                    "joins); files or Kafka topics in, stdout, a file or "
                    "a Kafka topic out; coordinated checkpoints")
    ap.add_argument("--config", required=True, help="YAML config path")
    ap.add_argument("--input1", help="newline-delimited input file for "
                                     "stream 1")
    ap.add_argument("--input2", help="newline-delimited input file for "
                                     "stream 2 (a join's query stream)")
    ap.add_argument("--option", type=int, default=None,
                    help="override query.option")
    ap.add_argument("--format", default=None,
                    help="override inputStream1.format (CSV/TSV/GeoJSON)")
    ap.add_argument("--format2", default=None,
                    help="override inputStream2.format")
    ap.add_argument("--multi-query", action="store_true",
                    help="answer every configured query object of the "
                         "option's type in one dispatch per window (same as "
                         "query.multiQuery)")
    ap.add_argument("--output", default=None,
                    help="also write every result record to this file, one "
                         "per line, serialized in --output-format")
    ap.add_argument("--output-format", default="GeoJSON",
                    choices=["GeoJSON", "WKT", "CSV", "TSV"],
                    help="serialization for --output and the Kafka output "
                         "topic (spatial records; non-spatial result tuples "
                         "are written as JSON lines)")
    ap.add_argument("--panes", action="store_true",
                    help="pane-incremental sliding windows (same as "
                         "query.panes): each slide-aligned pane is "
                         "evaluated once and a window merges its panes' "
                         "partials (a join: its pane-pair blocks); "
                         "identical results (range, kNN and windowed "
                         "joins; tumbling windows bypass it)")
    ap.add_argument("--pane-merge", choices=["auto", "device", "host"],
                    default=None,
                    help="where --panes kNN partials merge: 'device' (one "
                         "K3 launch per window over the partials on the "
                         "card), 'host', or 'auto' (default: device on "
                         "cuda, host on cpu)")
    ap.add_argument("--queries-file", metavar="PATH", default=None,
                    help="serve a dynamic fleet of point queries from a "
                         "JSON file of query specs ([{'id', 'x', 'y', "
                         "optional 'radius'/'k'/'route'/'slo'}, ...] or "
                         "{'queries': [...]}; the config's queryPoints "
                         "when it holds none), padded to power-of-two "
                         "buckets on the queries' axis, each query's "
                         "windows to its route (stdout, file:<path> or "
                         "kafka:<topic>): windowed range over any stream "
                         "type, and Point/Point kNN")
    ap.add_argument("--control-topic", metavar="TOPIC", default=None,
                    help="admit, update and retire standing queries from "
                         "this Kafka topic ({'action': 'admit'|'update'|"
                         "'retire', ...} JSON records), drained at window "
                         "boundaries (needs --kafka)")
    ap.add_argument("--limit", type=int, default=None,
                    help="max records to read per stream (from a Kafka "
                         "group's resume point; a resumed file replay "
                         "covers the rest of the original range)")
    ap.add_argument("--bulk", action="store_true",
                    help="whole-file (or, with --kafka, whole-topic) replay "
                         "of a windowed range, kNN or point x point join "
                         "over CSV/TSV/GeoJSON points (and WKT/GeoJSON "
                         "polygon or linestring streams for range and kNN): "
                         "one native parse, the windows assembled at once; "
                         "results are original-record indices. Other cases "
                         "and formats take the record path, and --bulk "
                         "ignores --limit on files")
    ap.add_argument("--kafka", action="store_true",
                    help="consume inputStream{1,2}.topicName and produce "
                         "results to outputStream.topicName through the "
                         "broker kafkaBootStrapServers names "
                         "('memory://<name>': the in-process broker; "
                         "anything else a real cluster via kafka-python); "
                         "--input1/--input2 files, when given, are produced "
                         "to the input topics first")
    ap.add_argument("--kafka-group", default="spatialflink",
                    help="consumer group id (a restart resumes from the "
                         "group's committed offsets)")
    ap.add_argument("--kafka-bootstrap", default=None,
                    help="override kafkaBootStrapServers from the config")
    ap.add_argument("--seed-scan-limit", type=int, default=None,
                    metavar="N",
                    help="bound the output topic's dedup seed scan to its "
                         "last N records (windows committed before them "
                         "can be produced again on re-delivery)")
    ap.add_argument("--checkpoint", default=None,
                    help="state checkpoint file of realtime tStats (205) "
                         "and tAggregate (207): saved periodically, "
                         "restored at start")
    ap.add_argument("--checkpoint-every", type=int, default=16,
                    help="micro-batches between --checkpoint saves; with "
                         "--checkpoint-dir, processing units (windows / "
                         "micro-batches) between coordinated checkpoints")
    ap.add_argument("--checkpoint-dir", metavar="DIR", default=None,
                    help="coordinated checkpoints: source positions, "
                         "watermarks, open window / pane buffers, pane "
                         "partials and trajectory state in one atomic "
                         "checksummed manifest under DIR (the newest "
                         "--checkpoint-retain kept, a corrupt newest one "
                         "skipped); --resume seeks the sources to the "
                         "checkpointed positions and suppresses windows "
                         "already emitted (the Kafka sink's markers, or a "
                         "journal in DIR): exactly-once windowed output. "
                         "Windowed range/kNN/join/trajectory, realtime "
                         "range/kNN/tStats/tAggregate; not --bulk")
    ap.add_argument("--resume", action="store_true",
                    help="restore the newest valid checkpoint of "
                         "--checkpoint-dir first (one written by another "
                         "job or layout is refused)")
    ap.add_argument("--checkpoint-interval", type=float, default=None,
                    metavar="SECONDS",
                    help="also checkpoint when this much wall time passed "
                         "since the last one")
    ap.add_argument("--checkpoint-retain", type=int, default=3,
                    help="checkpoint manifests kept in --checkpoint-dir")
    ap.add_argument("--adaptive-grid", nargs="?", const=4, type=int,
                    default=None, metavar="K", dest="adaptive_grid",
                    help="skew-adaptive grid: refine hot cells KxK (default "
                         "K=4) and coarsen cold neighborhoods, with "
                         "epoch-based split/merge decisions driven by the "
                         "decoded cells. Records keep their base cells and "
                         "the kernels are unchanged; the refined GN∪CN "
                         "leaf masks select a window's records on the host "
                         "before the kernel, so exact-mode results are the "
                         "uniform grid's and the gain is the smaller batch "
                         "on skewed streams (point-stream range queries; "
                         "the layout rides coordinated checkpoints)")
    ap.add_argument("--repartition-interval", type=int, default=50_000,
                    metavar="N",
                    help="records per repartition epoch for "
                         "--adaptive-grid (default 50000): each epoch "
                         "re-evaluates split/merge thresholds with "
                         "hysteresis (split at 5%% epoch share, merge "
                         "back below 1.25%% for 2 consecutive epochs)")
    ap.add_argument("--shard-order", choices=["arrival", "cell"],
                    default="arrival",
                    help="mesh shard placement for distributed window "
                         "batches ('cell' co-locates whole grid cells per "
                         "shard); one card has no shards, so both give "
                         "the same run")
    ap.add_argument("--metrics", action="store_true",
                    help="print a sorted-JSON metrics snapshot (counters, "
                         "meters, degradation digest) to stderr at exit")
    ap.add_argument("--telemetry-dir", metavar="DIR", default=None,
                    help="enable structured telemetry: per-stage spans "
                         "(ingest/window/kernel/merge/sink), latency "
                         "histograms, watermark-lag/backlog/grid-skew "
                         "gauges, the device block and the degradation "
                         "counters, emitted as JSONL snapshots to "
                         "DIR/telemetry.jsonl (one immediately, one per "
                         "--telemetry-interval, one at exit) plus the "
                         "Prometheus text dump DIR/metrics.prom, rewritten "
                         "at each snapshot. Off by default — the record "
                         "loop runs uninstrumented")
    ap.add_argument("--telemetry-interval", type=float, default=5.0,
                    metavar="SECONDS",
                    help="seconds between periodic telemetry snapshots "
                         "(default 5.0); also the --live-stats digest "
                         "cadence")
    ap.add_argument("--trace-dir", metavar="DIR", default=None,
                    help="record per-window TRACE LINEAGE (first-record "
                         "ingest, assembly, pane seals, kernel dispatch, "
                         "merge/readback, emit, sink, Kafka sink commit — "
                         "stable trace ids derived from (query, "
                         "window_start), bounded ring of the last 256 "
                         "windows) and export it at exit as Chrome "
                         "trace-event JSON to DIR/trace.json — load it in "
                         "Perfetto (ui.perfetto.dev) or chrome://tracing. "
                         "Activates a telemetry session")
    ap.add_argument("--live-stats", action="store_true",
                    help="print a one-line pipeline digest (throughput, "
                         "windows, latency p99, watermark lag, backlog, "
                         "checkpoint age, device, degradation) to stderr "
                         "every --telemetry-interval seconds; activates a "
                         "telemetry session")
    ap.add_argument("--postmortem-dir", metavar="DIR", default=None,
                    help="arm the flight recorder: a bounded ring of run "
                         "lifecycle notes that dumps a post-mortem bundle "
                         "directory (status snapshot, event ring, compile "
                         "registry, recent window traces, device memory, "
                         "config fingerprint) to DIR on crash, "
                         "strict-recompile abort or SIGUSR1 — read it with "
                         "'python -m spatialflink_tpu_torch.doctor "
                         "summarize/diff'. Activates a telemetry session")
    ap.add_argument("--strict-recompile", action="store_true",
                    help="abort the run (exit 3, post-mortem bundle if "
                         "--postmortem-dir) when a kernel entry point meets "
                         "a new signature (padded shapes, dtypes, static "
                         "arguments) or a kernel library is built or loaded "
                         "AFTER the declared warmup. Observational without "
                         "this flag: post-warmup compiles still count "
                         "('device-recompiles', 'recompile' events)")
    ap.add_argument("--sentinel-warmup", type=int, default=1,
                    metavar="WINDOWS",
                    help="recompile-sentinel warmup: compiles stop being "
                         "expected after this many emitted windows "
                         "(default 1). Streams whose batch sizes keep "
                         "growing into fresh padding buckets late in the "
                         "run may need a larger value before "
                         "--strict-recompile is safe")
    ap.add_argument("--status-port", type=int, default=None, metavar="PORT",
                    help="serve a live in-run status plane on "
                         "127.0.0.1:PORT (0 = ephemeral, bound port "
                         "printed): GET /healthz (SLO verdict, 200/503), "
                         "/status (full JSON snapshot), /metrics (live "
                         "Prometheus text), /events, /trace, /profile/"
                         "cells, /latency, /partition, /queries (GET, "
                         "POST; /queries/<id> GET, DELETE), /tenants, "
                         "/device, /compile. Snapshots are built per "
                         "request only; without a telemetry session the "
                         "record loop is unchanged and the plane serves "
                         "the always-on registry counters")
    ap.add_argument("--slo", metavar="SPEC", default=None,
                    help="health/SLO thresholds as comma-joined key=value "
                         "pairs, e.g. 'watermark_lag_ms=5000,"
                         "p99_window_ms=250,commit_backlog=10000,"
                         "checkpoint_age_s=60,recompiles=0,"
                         "device_mem_bytes=8e9'. Drives /healthz (503 on "
                         "breach), stamps a 'health' verdict into every "
                         "telemetry snapshot and digest line, counts "
                         "breach transitions in the slo-breaches counter, "
                         "and emits slo-breach/slo-recovered (and "
                         "watermark-stall) lifecycle events")
    ap.add_argument("--controller", metavar="SPEC", nargs="?", const="",
                    default=None,
                    help="closed-loop decode-chunk governor: tick on the "
                         "telemetry-reporter cadence, read the live stage "
                         "budget, and resize the decode chunk one "
                         "power-of-two bucket at a time between flushes — "
                         "shrink when queue/buffer wait dominates and the "
                         "record→emit p99 breaches, grow when dispatch-"
                         "bound or idle; no kernel signature changes. SPEC "
                         "tunes the policy as comma key=value pairs over "
                         "target_p99_ms/min_chunk/max_chunk/"
                         "interactive_max_chunk/fast_lane_depth/"
                         "confirm_ticks/cooldown_ticks/shed_after_stalls/"
                         "unshed_after_clean/idle_headroom (bare "
                         "--controller = defaults). Needs a telemetry "
                         "session for the tick source; live state in the "
                         "controller block of GET /latency and the stderr "
                         "digest")
    ap.add_argument("--latency-class", choices=["interactive", "batch"],
                    default="batch", dest="latency_class",
                    help="latency class for this run's standing queries "
                         "(default batch; also the default class for "
                         "--queries-file/--control-topic/POST admissions "
                         "that omit 'latency_class'). While any "
                         "interactive query serves, the --controller fast "
                         "lane caps the decode chunk at "
                         "interactive_max_chunk and bounds the pipeline "
                         "queue depth to fast_lane_depth")
    ap.add_argument("--tenant-default", metavar="NAME", default="default",
                    dest="tenant_default",
                    help="tenant charged for queries that omit 'tenant' "
                         "(and for dispatch cost no standing query claims). "
                         "Per-tenant attributed kernel-ms/bytes, records, "
                         "windows, SLO/shed/quota counters and the "
                         "fairness summary serve at GET /tenants (+ "
                         "/tenants/<id>, tenant=\"T\" Prometheus labels)")
    ap.add_argument("--tenant-quota", metavar="SPEC", action="append",
                    default=None, dest="tenant_quota",
                    help="admission quota per tenant as "
                         "'T:max_active[,kernel_ms_s=X]' (repeatable, or "
                         "';'-separated). max_active caps the tenant's "
                         "held query slots (pending+active+draining+shed); "
                         "kernel_ms_s caps its recent attributed kernel-ms "
                         "per second. A breach answers POST /queries with "
                         "429 quota-exceeded and creates NO entry — unlike "
                         "backpressure shedding, which parks the spec and "
                         "admits it when pressure clears")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="capture a torch.profiler trace of the run (CPU "
                         "and CUDA activity) to DIR/trace.json (Chrome "
                         "trace format) with per-operator dispatch/"
                         "readback ranges — the reference's Flink web UI "
                         "observability as a trace (StreamingJob.java:"
                         "70-72)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "PyTorch versions)")
    return ap


def _legacy_checkpoint(ap, args, params: Params, spec) -> None:
    """``--checkpoint``: the realtime tStats / tAggregate state file. The
    job fingerprint rides it; an existing file of another job, or an
    unreadable one, is refused before anything runs."""
    from spatialflink_tpu_torch.runtime.checkpoint import (
        CheckpointMismatch, check_job_fingerprint)
    from spatialflink_tpu_torch.runtime.state import (CheckpointCorrupt,
                                                      checkpoint_meta)

    params.checkpoint_path = args.checkpoint
    params.checkpoint_every = args.checkpoint_every
    params.checkpoint_job = params.job_fingerprint(args.kafka_group)
    if spec and not (spec.family in ("tstats", "taggregate")
                     and spec.mode == "realtime"):
        print("--checkpoint only applies to stateful realtime queries "
              "(tStats 205 / tAggregate 207); ignored for this case",
              file=sys.stderr)
        params.checkpoint_path = None
    elif os.path.exists(args.checkpoint):
        try:
            check_job_fingerprint(
                checkpoint_meta(args.checkpoint).get("job"),
                params.checkpoint_job, args.checkpoint)
        except CheckpointCorrupt as e:
            ap.error(f"--checkpoint: {e} (delete the file, or restore "
                     "a retained copy, to start over)")
        except CheckpointMismatch as e:
            ap.error(str(e))


def _coordinator(ap, args, params: Params, spec: CaseSpec,
                 dynamic: bool) -> None:
    """``--checkpoint-dir``: the run's coordinator on ``params`` (loaded
    with ``--resume``), or a note when the case is not covered. Its layout
    tag binds it to the execution knobs and the exact source its positions
    index."""
    from spatialflink_tpu_torch.runtime.checkpoint import (
        CheckpointCoordinator, CheckpointMismatch)

    if args.checkpoint:
        ap.error("--checkpoint-dir and --checkpoint are mutually "
                 "exclusive (the directory coordinator subsumes the "
                 "single-file tStats/tAggregate checkpoint)")
    if args.bulk:
        ap.error("--checkpoint-dir does not compose with --bulk "
                 "(bulk is a whole-replay; coordinated checkpoints "
                 "apply to the record path)")
    reason = _checkpoint_dir_unsupported(params, spec)
    if reason:
        print(f"--checkpoint-dir ignored: {reason}", file=sys.stderr)
        return
    if args.kafka:
        src_id = ("kafka:" + (args.kafka_bootstrap
                              or params.kafka_bootstrap_servers)
                  + f"/{params.input1.topic_name}"
                  + f",{params.input2.topic_name}")
    else:
        src_id = f"file:{args.input1},{args.input2}"
    coord = CheckpointCoordinator(
        args.checkpoint_dir, every_batches=args.checkpoint_every,
        every_seconds=args.checkpoint_interval,
        retain=args.checkpoint_retain,
        job=params.job_fingerprint(args.kafka_group),
        layout=(f"{spec.family}:{spec.mode}"
                f":panes={int(bool(params.query.panes))}"
                f":multi={int(bool(params.query.multi_query))}"
                f":dyn={int(dynamic)}:{src_id}"),
        device=args.device)
    if args.resume:
        try:
            restored = coord.load()
        except CheckpointMismatch as e:
            ap.error(str(e))
        if restored:
            print(f"# resuming from checkpoint seq {coord.seq} "
                  f"(source positions: {coord.positions() or '{}'})",
                  file=sys.stderr)
        else:
            print("# --resume: no valid checkpoint in "
                  f"{args.checkpoint_dir}; starting fresh", file=sys.stderr)
    params.checkpointer = coord


def _adaptive_grid(ap, args, params: Params) -> None:
    """``--adaptive-grid``: the run's AdaptiveGrid and its repartition
    controller on ``params`` (registered with the checkpoint coordinator,
    which restores a checkpointed layout here), or a note under
    ``--bulk``, whose batches are built before any window."""
    from spatialflink_tpu_torch.index import AdaptiveGrid
    from spatialflink_tpu_torch.runtime.repartition import (
        RepartitionController)

    if args.bulk:
        print("--adaptive-grid ignored with --bulk (whole-replay "
              "batches bypass the window-time prefilter); the default "
              "batched path supports it", file=sys.stderr)
        return
    try:
        agrid = AdaptiveGrid(params.grids()[0], refine=args.adaptive_grid)
    except ValueError as e:
        ap.error(f"--adaptive-grid: {e}")
    ctl = RepartitionController(agrid,
                                interval_records=args.repartition_interval)
    coord = getattr(params, "checkpointer", None)
    if coord is not None:
        ctl.register_checkpoint(coord)
    # attributes, not Params fields: they stay out of the job fingerprint
    params.adaptive_grid = agrid
    params.repartitioner = ctl
    print(f"# adaptive grid: hot cells split "
          f"{args.adaptive_grid}x{args.adaptive_grid}, repartition "
          f"epoch every {args.repartition_interval} records",
          file=sys.stderr)


def _dynamic_plane(args, params: Params, spec: CaseSpec,
                   tenant_quotas: Optional[dict] = None) -> Optional[str]:
    """``--queries-file`` / ``--control-topic``: the run's registry on
    ``params``, restored from the checkpoint's ``queries`` component or
    seeded from the file (or the config's queryPoints); else why the case
    cannot have one."""
    from spatialflink_tpu_torch.runtime.queryplane import QueryRegistry

    why = _dynamic_error(params, spec)
    if why is None and args.control_topic and not args.kafka:
        why = ("--control-topic consumes admissions from the broker and "
               "needs --kafka")
    if why is None and args.bulk:
        why = ("the dynamic standing-query plane does not compose "
               "with --bulk (a whole-replay has no admission "
               "boundaries)")
    if why is not None:
        return why
    if params.query.panes:
        print("note: --panes is bypassed on the dynamic standing-query "
              "path (pane partials are fleet-shaped; a fleet change "
              "would serve stale partials) — full-window evaluation",
              file=sys.stderr)
    coord = getattr(params, "checkpointer", None)
    registry = QueryRegistry(spec.family, radius=params.query.radius,
                             k=params.query.k,
                             default_latency_class=args.latency_class,
                             default_tenant=args.tenant_default,
                             tenant_quotas=tenant_quotas)
    if coord is not None and registry.register_checkpoint(coord):
        print(f"# resume: restored standing-query fleet (version "
              f"{registry.fleet_version}, "
              f"{len(registry.active_entries())} live)", file=sys.stderr)
    else:
        try:
            registry = _seed_registry(params, spec, args.queries_file,
                                      registry)
        except (ValueError, NotImplementedError) as e:
            return str(e)
        if not args.kafka:
            kafka_routes = [e.id for e in registry.active_entries()
                            if e.spec.route.startswith("kafka:")]
            if kafka_routes:
                return (f"queries {kafka_routes} route 'kafka:' topics "
                        "and need --kafka")
    params.query_registry = registry
    surfaces = ["POST/DELETE /queries (--status-port)"]
    if args.control_topic:
        surfaces.append(f"control topic '{args.control_topic}'")
    print(f"# query plane: dynamic {spec.family} fleet, "
          f"{len(registry.active_entries())} live "
          f"(admission via {' + '.join(surfaces)})", file=sys.stderr)
    return None


def main(argv: Optional[List[str]] = None) -> int:
    ap = _make_parser()
    args, rest = ap.parse_known_args(argv)
    flags = [a.split("=", 1)[0] for a in rest if a.startswith("-")]
    if rest:
        # --kafka-follow, --chaos, --retry, --dlq and every other flag of
        # the JAX driver that has no port yet
        print(f"{' '.join(flags or rest)}: {NOT_PORTED}", file=sys.stderr)
        return 2

    params = Params.from_yaml(args.config)
    if args.option is not None:
        params.query.option = args.option
    if args.multi_query:
        params.query.multi_query = True
    if args.panes:
        params.query.panes = True
    if args.pane_merge is not None and args.pane_merge != "auto":
        params.query.pane_device_merge = args.pane_merge == "device"
    if args.bulk:
        print("note: --bulk is deprecated — the batched columnar path is "
              "now the default for every mode; the flag keeps only its "
              "whole-replay semantics (see README)", file=sys.stderr)
    if args.format is not None:
        params = dataclasses.replace(
            params, input1=dataclasses.replace(params.input1,
                                               format=args.format))
    if args.format2 is not None:
        params = dataclasses.replace(
            params, input2=dataclasses.replace(params.input2,
                                               format=args.format2))
    spec = CASES.get(params.query.option)
    if args.checkpoint:
        _legacy_checkpoint(ap, args, params, spec)
    dynamic = bool(args.queries_file or args.control_topic)
    if args.resume and not args.checkpoint_dir:
        ap.error("--resume requires --checkpoint-dir")
    if args.checkpoint_dir and spec is not None:
        _coordinator(ap, args, params, spec, dynamic)
    if args.adaptive_grid is not None:
        _adaptive_grid(ap, args, params)
    # tenant quotas parse up front: a malformed spec is a flag error, not
    # a surprise at the first admission
    tenant_quotas = {}
    if args.tenant_quota:
        from spatialflink_tpu_torch.utils.accounting import (
            parse_tenant_quotas)

        try:
            tenant_quotas = parse_tenant_quotas(";".join(args.tenant_quota))
        except ValueError as e:
            ap.error(f"--tenant-quota: {e}")
    if not args.kafka and args.seed_scan_limit is not None:
        ap.error("--seed-scan-limit bounds the output topic's dedup scan "
                 "and needs --kafka")
    if args.kafka and spec is not None and spec.family in ("shapefile",
                                                           "synthetic"):
        ap.error(f"--kafka does not apply to the {spec.family} cases "
                 "(no input topic)")
    if not args.input1 and not args.kafka:
        print("--input1 is required", file=sys.stderr)
        return 2
    if spec is not None and spec.family in ("join", "tjoin") \
            and not args.input2 and not args.kafka:
        print(f"queryOption {params.query.option} ({spec.family}) needs "
              "--input2", file=sys.stderr)
        return 2
    if dynamic and spec is not None:
        why = _dynamic_plane(args, params, spec, tenant_quotas)
        if why is not None:
            print(f"error: {why}", file=sys.stderr)
            return 2
    # a resumed legacy checkpoint: the file replay skips the records its
    # state reflects (a Kafka group is sought instead), and --limit keeps
    # bounding the original record range
    skip1 = 0
    if getattr(params, "checkpoint_path", None):
        from spatialflink_tpu_torch.runtime.state import checkpoint_consumed

        skip1 = checkpoint_consumed(args.checkpoint)
        if skip1:
            print(f"# resuming from checkpoint: skipping {skip1} "
                  "already-consumed records", file=sys.stderr)
    limit1 = args.limit
    if skip1 and limit1 is not None:
        limit1 = max(0, limit1 - skip1)
    health = None
    if args.slo is not None:
        from spatialflink_tpu_torch.runtime.health import HealthEvaluator

        try:
            health = HealthEvaluator.from_spec(args.slo)
        except ValueError as e:
            ap.error(str(e))
        if (args.status_port is None and not args.telemetry_dir
                and not args.live_stats):
            print("warning: --slo has no consumer without --status-port, "
                  "--telemetry-dir, or --live-stats (nothing evaluates "
                  "the thresholds)", file=sys.stderr)
    if args.controller is not None:
        from spatialflink_tpu_torch.runtime.control import (ChunkGovernor,
                                                            GovernorPolicy)

        try:
            policy = GovernorPolicy.from_spec(args.controller)
        except ValueError as e:
            ap.error(str(e))
        # an attribute, not a Params field: it stays out of the job
        # fingerprint
        params.chunk_governor = ChunkGovernor(policy=policy)
        if not (args.telemetry_dir or args.live_stats or args.trace_dir
                or args.postmortem_dir):
            print("warning: --controller has no tick source without a "
                  "telemetry session (--telemetry-dir/--live-stats/"
                  "--trace-dir/--postmortem-dir): the latency plane's "
                  "bucket close drives the control law, so the chunk "
                  "stays at its seed", file=sys.stderr)
    if (args.telemetry_dir or args.live_stats or args.trace_dir
            or args.postmortem_dir):
        from spatialflink_tpu_torch.utils.telemetry import telemetry_session

        # the session wraps the Kafka wiring too (taps and sinks take
        # their gauges at construction); --live-stats, --trace-dir and
        # --postmortem-dir without --telemetry-dir run a session with no
        # reporter
        with telemetry_session(args.telemetry_dir or None,
                               args.telemetry_interval, health=health,
                               trace_dir=args.trace_dir,
                               device=args.device):
            if args.telemetry_dir:
                print(f"# telemetry: JSONL snapshots every "
                      f"{args.telemetry_interval:g}s -> "
                      f"{os.path.join(args.telemetry_dir, 'telemetry.jsonl')}",
                      file=sys.stderr)
            if args.trace_dir:
                print("# tracing: per-window lineage -> "
                      f"{os.path.join(args.trace_dir, 'trace.json')} "
                      "(Chrome trace-event JSON; open in Perfetto)",
                      file=sys.stderr)
            return _run_cli(ap, args, params, spec, skip1, limit1, health)
    return _run_cli(ap, args, params, spec, skip1, limit1, health)


def _file_streams(args, params: Params, spec, skip1: int,
                  limit1: Optional[int]):
    """The streams of a file replay: under a coordinator each behind a
    checkpoint tap that counts records from the checkpointed position
    (``file:1`` / ``file:2``, skipped on resume, ``--limit`` bounding the
    original range)."""
    from spatialflink_tpu_torch.runtime.checkpoint import CheckpointTap

    coord = getattr(params, "checkpointer", None)
    if spec is not None and spec.family == "shapefile":
        return args.input1, None  # the reader takes the .shp path

    def replay(path: str, key: str, skip: int, limit: Optional[int]):
        if coord is not None:
            skip = coord.position(key, 0)
            limit = None if args.limit is None else max(0, args.limit - skip)
            if skip:
                print(f"# resume: skipping {skip} already-reflected records "
                      f"of --input{key[-1]}", file=sys.stderr)
        lines = _limited(itertools.islice(file_lines(path), skip, None),
                         limit)
        return (lines if coord is None
                else CheckpointTap(lines, coord, key, base=skip))

    stream1 = replay(args.input1, "file:1", skip1, limit1)
    stream2 = (replay(args.input2, "file:2", 0, args.limit) if args.input2
               else None)
    return stream1, stream2


def _run_cli(ap, args, params: Params, spec, skip1: int,
             limit1: Optional[int], health=None) -> int:
    """The run after validation: wire the transport, run the pipeline,
    drain its results into the sinks, print the summaries."""
    import contextlib
    import signal
    import threading

    from spatialflink_tpu_torch.runtime.checkpoint import EmittedWindowJournal
    from spatialflink_tpu_torch.streams.sinks import FileSink, StdoutSink
    from spatialflink_tpu_torch.utils import telemetry as _telemetry

    coord = getattr(params, "checkpointer", None)
    tel = _telemetry.active()
    if tel is not None:
        # the ledger's catch-all tenant follows the flag; a resume
        # restores the cumulative attribution (component 'tenants')
        tel.tenants.default_tenant = args.tenant_default or "default"
        if coord is not None:
            tel.tenants.register_checkpoint(coord)
    kafka = None
    try:
        resolve_device(args.device)
        if args.kafka:
            if spec is None:
                raise NotImplementedError(
                    f"queryOption {params.query.option}: {NOT_PORTED}")
            kafka = _wire_kafka(params, spec, args, skip1)
            stream1, stream2 = kafka.stream1, kafka.stream2
        else:
            stream1, stream2 = _file_streams(args, params, spec, skip1,
                                             limit1)
        results = None
        if args.bulk and kafka is not None:
            offs: List = []
            results = run_option_bulk(
                params,
                _topic_reader(kafka, params.input1.topic_name, args.limit,
                              offs),
                _topic_reader(kafka, params.input2.topic_name, args.limit,
                              offs), device=args.device)
            if results is None:
                print("# --kafka --bulk not applicable to this case/format/"
                      "topic content; using the streaming path",
                      file=sys.stderr)
            else:
                kafka.bulk_offsets = offs
        elif args.bulk:
            results = run_option_bulk(params, args.input1, args.input2,
                                      device=args.device)
            if results is None:
                print("--bulk not applicable to this case/format; "
                      "using the record path", file=sys.stderr)
            elif args.limit is not None:
                print("--bulk ignores --limit (whole-file replay)",
                      file=sys.stderr)
        if results is None:
            results = run_option(params, stream1, stream2,
                                 device=args.device)
    except (NotImplementedError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    registry = getattr(params, "query_registry", None)
    router = None
    if registry is not None:
        from spatialflink_tpu_torch.runtime.queryplane import (
            ControlTopicConsumer, QueryRouter)

        if args.control_topic and kafka is not None:
            registry.attach_control(ControlTopicConsumer(
                kafka.broker, args.control_topic, args.kafka_group))
        router = QueryRouter(registry, broker=kafka.broker
                             if kafka is not None else None)
    sink = StdoutSink()
    out_sink = None
    if args.output:
        out_sink = FileSink(args.output, args.output_format,
                            delimiter=params.output.delimiter,
                            date_format=params.input1.date_format)
    journal = None
    if coord is not None and kafka is None and spec.mode == "window":
        # stdout / --output have no log of their own: a journal of the
        # emitted windows in the checkpoint directory suppresses what a
        # resumed run would print again (a run that did not resume starts
        # a new one)
        journal = EmittedWindowJournal(
            coord.dir, fresh=not (args.resume and coord.restored))
    stack = contextlib.ExitStack()
    if threading.current_thread() is threading.main_thread():
        # SIGTERM drains: the decode stops at the next record, the records
        # read reach the pipeline, and a final checkpoint is written
        metrics.clear_shutdown()
        prev = signal.signal(signal.SIGTERM,
                             lambda signum, frame: metrics.request_shutdown())
        stack.callback(signal.signal, signal.SIGTERM, prev)
    from spatialflink_tpu_torch.utils import deviceplane

    # the recompile sentinel: warmup re-opens for this run; after
    # --sentinel-warmup emitted windows every new kernel signature or
    # library is a 'recompile' event and count, and an abort under
    # --strict-recompile; end_run on the stack, so a later run in the
    # process starts cold
    sentinel = deviceplane.registry()
    sentinel.begin_run(strict=args.strict_recompile)
    stack.callback(sentinel.end_run)
    recorder = None
    if args.postmortem_dir:
        recorder = deviceplane.FlightRecorder(
            args.postmortem_dir,
            config={
                "job_fingerprint": params.job_fingerprint(),
                "option": params.query.option,
                "family": spec.family if spec is not None else None,
                "mode": spec.mode if spec is not None else None,
                "backend": deviceplane.backend_provenance(
                    device=args.device),
                "flags": {
                    "kafka": bool(args.kafka),
                    "chaos": False,
                    "panes": bool(args.panes),
                    "strict_recompile": args.strict_recompile,
                    "sentinel_warmup": args.sentinel_warmup,
                    "slo": args.slo,
                },
            })
        recorder.install_signal()
        if health is not None:
            recorder.attach_health(health)
        stack.callback(recorder.close)
        recorder.note("run-start", option=params.query.option,
                      family=spec.family if spec is not None else None)
        print(f"# flight recorder armed: post-mortem bundles -> "
              f"{args.postmortem_dir} (crash / SLO breach / SIGUSR1; "
              "read with python -m spatialflink_tpu_torch.doctor)",
              file=sys.stderr)
    repartitioner = getattr(params, "repartitioner", None)
    if repartitioner is not None:
        # the decode's cell assignments feed the epochs from here on; the
        # chain is restored on every exit, so an in-process run never
        # leaks it
        repartitioner.install()
        stack.callback(repartitioner.uninstall)
    governor = getattr(params, "chunk_governor", None)
    if governor is not None:
        # the decode reads the governor per flush (_governed_chunk), so
        # installing it here, uninstalled on every exit, is safe whatever
        # the wiring order; a checkpointed run carries its state as the
        # component 'controller'
        governor.install()
        stack.callback(governor.uninstall)
        if coord is not None:
            governor.register_checkpoint(coord)
        pol = governor.policy
        print(f"# controller: decode-chunk governor on "
              f"(seed {governor.chunk()}, bounds "
              f"[{pol.min_chunk}, {pol.max_chunk}], target p99 "
              f"{pol.target_p99_ms:g}ms; live state at GET /latency)",
              file=sys.stderr)
    if registry is not None:
        # installed before the server starts: POST/DELETE/GET /queries
        # find it through queryplane.active_registry()
        registry.install()
        stack.callback(registry.uninstall)
    if args.profile:
        stack.enter_context(metrics.profile_to(args.profile,
                                               device=args.device))
        print(f"# profiling to {os.path.join(args.profile, 'trace.json')} "
              "(Chrome trace; open in Perfetto)", file=sys.stderr)
    tel = _telemetry.active()
    if args.status_port is not None:
        from spatialflink_tpu_torch.runtime.opserver import OpServer

        # reads the active session (or the registry alone) per request;
        # closed by the stack on every exit path (a control-tuple stop, a
        # crash), so the port never outlives the run; a failed bind raises
        opserver = OpServer(port=args.status_port, health=health).start()
        stack.callback(opserver.close)
        print(f"# status server: {opserver.url} "
              "(/healthz /status /metrics /events)", file=sys.stderr)
    if args.live_stats:
        from spatialflink_tpu_torch.runtime.opserver import LiveStats

        live = LiveStats(interval_s=args.telemetry_interval,
                         health=health).start()
        stack.callback(live.close)
    # per-window pipeline latency: the wall clock from asking the pipeline
    # for its next result to receiving it
    win_hist = (tel.histogram("window-latency-ms")
                if tel is not None else None)

    def emit_result(result) -> None:
        _emit(result, sink)
        if kafka is not None:
            kafka.emit(result)
        if router is not None and isinstance(result, WindowResult) \
                and "query_ids" in result.extras:
            # per-query demux: the SLO verdict always, one JSON document
            # per (window, query) on file: / kafka: routes
            router.route(result)
        if out_sink is not None:
            if isinstance(result, WindowResult):
                for rec in result.flat_records():
                    out_sink.emit(rec)
            elif (isinstance(result, tuple) and len(result) == 2
                    and isinstance(result[0], SpatialObject)):
                out_sink.emit(result[0])  # a ser/de pair's record
            else:
                out_sink.emit(result)

    n = 0
    stopped = graceful = strict_abort = False
    it = iter(results)
    try:
        while True:
            t0 = time.perf_counter() if tel is not None else 0.0
            try:
                result = next(it)
            except StopIteration:
                break
            if win_hist is not None:
                win_hist.record((time.perf_counter() - t0) * 1e3)
            if (journal is not None and isinstance(result, WindowResult)
                    and journal.seen(result)):
                continue  # emitted by the run before the crash
            if tel is not None:
                s0 = time.time()
                with tel.span("sink"):
                    emit_result(result)
                s1 = time.time()
                if isinstance(result, WindowResult):
                    # the driver's emission, by window_start: the latency
                    # plane's downstream "sink" stage and the trace note
                    tel.latency.note_downstream(
                        "sink", result.window_start, s0, s1)
                    if tel.traces is not None:
                        tel.traces.note_any(result.window_start, "sink",
                                            s0, s1)
            else:
                emit_result(result)
            if journal is not None and isinstance(result, WindowResult):
                journal.record(result)
            n += 1
            if (not sentinel.warm and isinstance(result, WindowResult)
                    and n >= args.sentinel_warmup):
                # declared warmup done: any later compile is an event
                sentinel.mark_warm(
                    f"{n} window(s) emitted (--sentinel-warmup "
                    f"{args.sentinel_warmup})")
            if recorder is not None and isinstance(result, WindowResult):
                recorder.note("window", start=result.window_start,
                              records=len(result.records))
    except metrics.ControlTupleExit as e:
        # the remote stop (HelperClass.checkExitControlTuple) ends the run
        # gracefully, exit code 0
        stopped = True
        graceful = isinstance(e, metrics.GracefulShutdown)
    except deviceplane.RecompileError as e:
        # --strict-recompile: the zero-recompile contract was violated;
        # the moment is captured and the run exits 3
        if recorder is not None:
            recorder.dump("strict-recompile", error=e)
        print(f"# STRICT-RECOMPILE ABORT: {e}", file=sys.stderr)
        strict_abort = True
    except BaseException as e:
        # any other crash: the post-mortem bundle, then the error as it was
        if recorder is not None:
            recorder.dump("crash", error=e)
        raise
    finally:
        stack.close()  # the profiler's trace is written before the summary
        sink.close()
        if out_sink is not None:
            out_sink.close()
        if router is not None:
            router.close()
        if journal is not None:
            journal.close()
    if graceful and coord is not None:
        # the decode drained its buffer into the pipeline before the stop:
        # the state and positions cover every record read
        path = coord.commit()
        print(f"# graceful shutdown: final checkpoint seq {coord.seq} "
              f"({path})", file=sys.stderr)
    if kafka is not None:
        if not stopped:
            kafka.finish()
        print(kafka.summary(), file=sys.stderr)
    print(f"# emitted {n} results"
          + (" (control-tuple stop)" if stopped else ""), file=sys.stderr)
    if journal is not None and journal.suppressed:
        print(f"# resume: suppressed {journal.suppressed} window(s) the "
              f"crashed run already emitted (journal {journal.path})",
              file=sys.stderr)
    if out_sink is not None:
        print(f"# wrote {out_sink.records_written} records to {args.output} "
              f"({args.output_format})", file=sys.stderr)
    if args.metrics:
        import json

        # one sorted-JSON object on stderr, with the degradation digest
        print(json.dumps({"metrics": metrics.REGISTRY.snapshot(),
                          "degradation": metrics.degradation_snapshot()},
                         sort_keys=True), file=sys.stderr)
    return 3 if strict_abort else 0


if __name__ == "__main__":
    raise SystemExit(main())
