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
``queryPoints``; each window's per-query lists go to the queries' routes.
Every other option, and every flag or config feature not ported yet, is
refused with "not yet ported to spatialflink_tpu_torch" — never silently
ignored.

A point stream in CSV/TSV/GeoJSON decodes through the native columnar
parser; a polygon or linestring stream (GeoJSON, WKT, CSV/TSV) is parsed
record by record, as the JAX driver parses it, and a record of another
geometry type is dropped and counted (``decode_chunks.off_type_dropped``).

    python -m spatialflink_tpu_torch.driver --config conf/spatialflink-conf.yml \\
        --option 51 --input1 points.csv --format CSV [--multi-query] \\
        [--panes [--pane-merge auto|device|host]] [--queries-file q.json] \\
        [--input2 queries.csv --format2 CSV] [--bulk] [--limit N] \\
        [--output out.geojson] [--output-format GeoJSON|WKT|CSV|TSV] \\
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
from spatialflink_tpu_torch.utils import IdInterner


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
            warn(type(obj).__name__)
    return GeomChunk(kept) if kept else None


def decode_chunks(records: Iterable, cfg: StreamConfig, grid: UniformGrid,
                  chunk: int = 4096, geometry: str = "Point") -> Iterator:
    """Raw records (CSV/TSV lines, GeoJSON str/dict, WKT lines, or parsed
    objects) -> decoded chunks of up to ``chunk`` records, cells assigned
    on ``grid``: :class:`PointChunk` s of a point stream, object ids
    interned in one id space; :class:`GeomChunk` s of a ``geometry``
    ("Polygon" or "LineString") stream, off-type records dropped."""
    interner = IdInterner()
    warn = _off_type_warner(geometry)

    def decode(buf):
        if geometry == "Point":
            return _decode_chunk(buf, cfg, grid, interner)
        return _decode_geoms(buf, cfg, grid, geometry, warn)

    buf: List = []
    for rec in records:
        buf.append(rec)
        if len(buf) >= chunk:
            out = decode(buf)
            if out is not None:
                yield out
            buf = []
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
    empty."""
    for r in results:
        now = int(time.time() * 1000)
        cols = getattr(r.records, "columns", None)
        first = getattr(r.records, "first_ingest", None)
        ingest = (cols()[5] if cols is not None else
                  first() if first is not None else None)
        lats = [] if ingest is None else (now - ingest[ingest > 0]).tolist()
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
    # at most one slide, otherwise 4,096 records
    if conf.query_type is QueryType.RealTime:
        chunk = conf.realtime_batch_size
    elif conf.query_type is QueryType.CountBased:
        chunk = max(1, min(4096, conf.slide_ms))
    else:
        chunk = 4096
    s1 = ChunkedStream(decode_chunks(stream1, params.input1, u_grid, chunk,
                                     geometry=spec.stream))
    radius = params.query.radius
    if spec.family == "join":
        s2 = ChunkedStream(decode_chunks(stream2, params.input2, q_grid,
                                         chunk, geometry=spec.query))
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


def _bulk_parse_stream(cfg: StreamConfig, path: str,
                       allowed_lateness_s: int):
    """One point stream's whole file in one native parse, late records
    dropped as the record path drops them (``bulk_keep_mask``); None,
    with a note, when the file cannot take the bulk path (a record of
    another geometry type in a declared point stream)."""
    fmt = cfg.format.lower()
    if fmt not in ("csv", "tsv", "geojson"):
        return None
    with open(path, "rb") as f:
        data = f.read()
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
    with open(path, "rb") as f:
        data = f.read()
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
    chunk = (conf.realtime_batch_size if spec.mode == "realtime" else 4096)
    s1 = ChunkedStream(decode_chunks(stream1, params.input1, u_grid, chunk))
    q = params.query
    if spec.family == "tfilter":
        return ops.PointTFilterQuery(conf, u_grid, device=device).run(
            s1, set(q.traj_ids))
    if spec.family == "trange":
        polys = params.query_polygon_objects(u_grid)
        op = ops.PointPolygonTRangeQuery(conf, u_grid, device=device)
        return op.run_naive(s1, polys) if spec.naive else op.run(s1, polys)
    if spec.family == "tstats":
        return ops.PointTStatsQuery(conf, u_grid, device=device).run(
            s1, set(q.traj_ids) or None)
    if spec.family == "taggregate":
        return ops.PointTAggregateQuery(conf, u_grid, device=device).run(
            s1, q.aggregate_function,
            traj_deletion_threshold_ms=q.traj_deletion_threshold_s * 1000)
    if spec.family == "tjoin":
        if stream2 is None:
            raise ValueError("trajectory join needs stream2")
        s2 = ChunkedStream(decode_chunks(stream2, params.input2, q_grid,
                                         chunk))
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


def _seed_registry(params: Params, spec: CaseSpec, path: str):
    """The fleet of ``--queries-file``: the file's specs, else the
    config's ``queryPoints`` (ids q0, q1, ...), admitted and applied
    before the first window. Raises ValueError (or OSError) with the
    JAX driver's ``--queries-file:`` messages."""
    from spatialflink_tpu_torch.runtime.queryplane import (QueryRegistry,
                                                           QuerySpec,
                                                           QuerySpecError,
                                                           load_queries_file)

    registry = QueryRegistry(spec.family, radius=params.query.radius,
                             k=params.query.k)
    try:
        seeds = load_queries_file(path, spec.family)
    except (OSError, ValueError) as e:
        raise ValueError(f"--queries-file: {e}") from e
    if not seeds and params.query.query_points:
        seeds = [QuerySpec(id=f"q{i}", family=spec.family, x=x, y=y)
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


def main(argv: Optional[List[str]] = None) -> int:
    from spatialflink_tpu_torch.streams.sinks import (FileSink, StdoutSink,
                                                      file_lines)

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
                    "joins)")
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
                    help="serialization for --output (spatial records; "
                         "non-spatial result tuples are written as JSON "
                         "lines)")
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
                         "windows to its route (stdout or file:<path>): "
                         "windowed range over any stream type, and "
                         "Point/Point kNN")
    ap.add_argument("--limit", type=int, default=None,
                    help="max records to read per stream")
    ap.add_argument("--bulk", action="store_true",
                    help="whole-file replay of a windowed range, kNN or "
                         "point x point join over CSV/TSV/GeoJSON points "
                         "(and WKT/GeoJSON polygon or linestring streams "
                         "for range and kNN): one native parse of the "
                         "file, the windows assembled at once; results are "
                         "original-record indices. Other cases and formats "
                         "take the record path, and --bulk ignores --limit")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the kernels' plain "
                         "PyTorch versions)")
    args, rest = ap.parse_known_args(argv)
    flags = [a.split("=", 1)[0] for a in rest if a.startswith("-")]
    if rest:
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
    if not args.input1:
        print("--input1 is required", file=sys.stderr)
        return 2
    spec = CASES.get(params.query.option)
    if spec is not None and spec.family in ("join", "tjoin") \
            and not args.input2:
        print(f"queryOption {params.query.option} ({spec.family}) needs "
              "--input2", file=sys.stderr)
        return 2
    router = None
    if args.queries_file and spec is not None:
        from spatialflink_tpu_torch.runtime.queryplane import QueryRouter

        why = _dynamic_error(params, spec)
        if why is not None:
            print(f"error: {why}", file=sys.stderr)
            return 2
        if params.query.panes:
            print("note: --panes is bypassed on the dynamic standing-query "
                  "path (pane partials are fleet-shaped; a fleet change "
                  "would serve stale partials) — full-window evaluation",
                  file=sys.stderr)
        try:
            registry = _seed_registry(params, spec, args.queries_file)
        except (ValueError, NotImplementedError) as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        params.query_registry = registry
        router = QueryRouter(registry)
        print(f"# query plane: dynamic {spec.family} fleet, "
              f"{len(registry.active_entries())} live", file=sys.stderr)
    if spec is not None and spec.family == "shapefile":
        stream1 = args.input1  # the reader takes the .shp path
    else:
        stream1 = _limited(file_lines(args.input1), args.limit)
    stream2 = (_limited(file_lines(args.input2), args.limit) if args.input2
               else None)
    try:
        resolve_device(args.device)
        results = None
        if args.bulk:
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

    sink = StdoutSink()
    out_sink = None
    if args.output:
        out_sink = FileSink(args.output, args.output_format,
                            delimiter=params.output.delimiter,
                            date_format=params.input1.date_format)
    n = 0
    try:
        for result in results:
            _emit(result, sink)
            if router is not None and "query_ids" in result.extras:
                # per-query demux: the SLO verdict always, and one JSON
                # line per (window, query) on a file: route
                router.route(result)
            if out_sink is not None:
                if isinstance(result, WindowResult):
                    for rec in result.flat_records():
                        out_sink.emit(rec)
                elif (isinstance(result, tuple) and len(result) == 2
                        and isinstance(result[0], SpatialObject)):
                    # a ser/de result: the parsed record goes out
                    out_sink.emit(result[0])
                else:
                    out_sink.emit(result)
            n += 1
    finally:
        sink.close()
        if out_sink is not None:
            out_sink.close()
        if router is not None:
            router.close()
    print(f"# emitted {n} results", file=sys.stderr)
    if out_sink is not None:
        print(f"# wrote {out_sink.records_written} records to {args.output} "
              f"({args.output_format})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
