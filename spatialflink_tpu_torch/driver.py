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
merge); a join refuses it. ``--queries-file`` serves a dynamic fleet of
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
        [--input2 queries.csv --format2 CSV] \\
        [--output out.geojson] [--output-format GeoJSON|WKT|CSV|TSV] \\
        [--device cuda|cpu]

stdout carries one line per window as the JAX driver prints it:
``{'window': [start, end], 'count': n}`` plus the result's extras (``k``
for kNN; ``per_query_counts`` and ``queries`` under multiQuery and
``--queries-file``, which adds ``query_ids``), without ``latency_ms``; a join's count is its number of pairs, and ``--output``
writes each pair as a JSON array of its two serialized records.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional

from spatialflink_tpu_torch import operators as ops
from spatialflink_tpu_torch.config import Params, StreamConfig
from spatialflink_tpu_torch.device import resolve_device
from spatialflink_tpu_torch.index import UniformGrid
from spatialflink_tpu_torch.operators import (QueryConfiguration, QueryType,
                                              WindowResult)
from spatialflink_tpu_torch.operators.base import NOT_PORTED
from spatialflink_tpu_torch.streams import bulk
from spatialflink_tpu_torch.models import SpatialObject
from spatialflink_tpu_torch.models.objects import _EdgeGeom
from spatialflink_tpu_torch.streams.bulk import GeomChunk, PointChunk
from spatialflink_tpu_torch.streams.formats import parse_spatial
from spatialflink_tpu_torch.utils import IdInterner


@dataclass(frozen=True)
class CaseSpec:
    family: str            # range | knn | join | t* (trajectory) | synthetic
    stream: str = "Point"  # geometry type of input stream 1
    query: str = "Point"   # geometry type of the query side
    mode: str = "window"   # window | realtime
    latency: bool = False  # a latency variant
    naive: bool = False    # a naive twin (no cell pruning)


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
    for on, what in ((q.panes and spec.family == "join",
                      f"query.panes for a join (queryOption {q.option})"),
                     (q.parallelism > 1, "query.parallelism > 1"),
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


def _emit(result: WindowResult, sink) -> None:
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
                    "harness 99; window.type TIME or COUNT (COUNT not for "
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
                         "partials; identical results (range and kNN; "
                         "tumbling windows bypass it)")
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
    if args.panes and spec is not None and spec.family == "join":
        print(f"--panes: {NOT_PORTED} for a join (queryOption "
              f"{params.query.option})", file=sys.stderr)
        return 2
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
    try:
        resolve_device(args.device)
        results = run_option(params, file_lines(args.input1),
                             file_lines(args.input2) if args.input2
                             else None, device=args.device)
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
                for rec in result.flat_records():
                    out_sink.emit(rec)
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
