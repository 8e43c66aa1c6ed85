"""Driver (port of ``spatialflink_tpu.driver`` for the range and kNN
queries over point, polygon and linestring streams).

``CASES`` keeps the JAX package's option numbering for the options this
port runs: for each (stream, query) pair of ``_PAIRS``, i = 0..8 (Point,
Polygon and LineString streams, each against Point, Polygon and LineString
queries), range 1 + 5i (windowed) and 2 + 5i (realtime), and kNN 51 + 5i
and 52 + 5i; realtime runs micro-batches of ``realtime_batch_size``
arrivals, emitted only when the selection is not empty. Also the latency
variants 8/9 (range) and 58/59 (kNN) over a point stream and a polygon
query, windowed and realtime, whose results carry each selected record's
``now - ingestion time`` in ``extras["latency_ms"]`` (empty for kNN's
(objID, distance) records). ``window.type: COUNT`` turns the windowed
options into sliding count windows (interval and step are record counts).
``query.multiQuery`` (or ``--multi-query``) answers every configured query
object of the option's type in one dispatch per window. Every other
option, and every flag or config feature not ported yet, is refused with
"not yet ported to spatialflink_tpu_torch" — never silently ignored.

A point stream in CSV/TSV/GeoJSON decodes through the native columnar
parser; a polygon or linestring stream (GeoJSON, WKT, CSV/TSV) is parsed
record by record, as the JAX driver parses it, and a record of another
geometry type is dropped and counted (``decode_chunks.off_type_dropped``).

    python -m spatialflink_tpu_torch.driver --config conf/spatialflink-conf.yml \\
        --option 51 --input1 points.csv --format CSV [--multi-query] \\
        [--output out.geojson] [--output-format GeoJSON|WKT|CSV|TSV] \\
        [--device cuda|cpu]

stdout carries one line per window as the JAX driver prints it:
``{'window': [start, end], 'count': n}`` plus the result's extras (``k``
for kNN; ``per_query_counts`` and ``queries`` under multiQuery), without
``latency_ms``.
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
    family: str            # range | knn
    stream: str = "Point"  # geometry type of input stream 1
    query: str = "Point"   # geometry type of the query side
    mode: str = "window"   # window | realtime
    latency: bool = False  # a latency variant


_PAIRS = [
    ("Point", "Point"), ("Point", "Polygon"), ("Point", "LineString"),
    ("Polygon", "Point"), ("Polygon", "Polygon"), ("Polygon", "LineString"),
    ("LineString", "Point"), ("LineString", "Polygon"),
    ("LineString", "LineString"),
]


def _build_cases() -> dict:
    """The ported options (numbering of ``spatialflink_tpu.driver.CASES``):
    range 1/2 + 5*i and kNN 51/52 + 5*i over the nine (stream, query)
    pairs, and the latency variants."""
    c = {}
    for i, (stream, query) in enumerate(_PAIRS):
        for base, fam in ((1, "range"), (51, "knn")):
            c[base + 5 * i] = CaseSpec(fam, stream, query, "window")
            c[base + 1 + 5 * i] = CaseSpec(fam, stream, query, "realtime")
    for opt, fam, mode in ((8, "range", "window"), (9, "range", "realtime"),
                           (58, "knn", "window"), (59, "knn", "realtime")):
        c[opt] = CaseSpec(fam, "Point", "Polygon", mode, latency=True)
    return c


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


def _check_ported(params: Params) -> None:
    q = params.query
    for on, what in ((q.panes, "query.panes"),
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
    chunk's stamp. kNN records are (objID, distance) pairs with no
    ingestion time, so their list is empty."""
    for r in results:
        now = int(time.time() * 1000)
        cols = getattr(r.records, "columns", None)
        lats = []
        if cols is not None:
            ingest = cols()[5]
            lats = (now - ingest[ingest > 0]).tolist()
        r.extras["latency_ms"] = lats
        yield r


def run_option(params: Params, stream1: Iterable, *, device="cuda"
               ) -> Iterator[WindowResult]:
    """Wire and run the pipeline of ``params.query.option`` over
    ``stream1`` (raw records or parsed objects) on ``device``; returns the
    window-result iterator."""
    opt = params.query.option
    spec = CASES.get(opt)
    if spec is None:
        raise NotImplementedError(
            f"queryOption {opt}: {NOT_PORTED} (ported: "
            f"{', '.join(map(str, sorted(CASES)))})")
    _check_ported(params)
    u_grid, _ = params.grids()
    fam = {"range": "Range", "knn": "KNN"}[spec.family]
    cls = getattr(ops, f"{spec.stream}{spec.query}{fam}Query")
    conf = _query_conf(params, spec)
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
    if params.query.multi_query:
        return _run_multi_case(params, spec, op, s1, u_grid, radius)
    q = _query_objects(params, u_grid, spec.query)[0]
    if spec.family == "knn":
        out = op.run(s1, q, radius, params.query.k)
    else:
        out = op.run(s1, q, radius)
    return _with_latency(out) if spec.latency else out


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
                    "1-42 and kNN options 51-92 (1 + 5i / 51 + 5i "
                    "windowed, 2 + 5i / 52 + 5i realtime), latency "
                    "variants 8, 9 (range) and 58, 59 (kNN); window.type "
                    "TIME or COUNT")
    ap.add_argument("--config", required=True, help="YAML config path")
    ap.add_argument("--input1", help="newline-delimited input file for "
                                     "stream 1")
    ap.add_argument("--option", type=int, default=None,
                    help="override query.option")
    ap.add_argument("--format", default=None,
                    help="override inputStream1.format (CSV/TSV/GeoJSON)")
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
    if args.format is not None:
        params = dataclasses.replace(
            params, input1=dataclasses.replace(params.input1,
                                               format=args.format))
    if not args.input1:
        print("--input1 is required", file=sys.stderr)
        return 2
    try:
        resolve_device(args.device)
        results = run_option(params, file_lines(args.input1),
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
            if out_sink is not None:
                for rec in result.flat_records():
                    out_sink.emit(rec)
            n += 1
    finally:
        sink.close()
        if out_sink is not None:
            out_sink.close()
    print(f"# emitted {n} results", file=sys.stderr)
    if out_sink is not None:
        print(f"# wrote {out_sink.records_written} records to {args.output} "
              f"({args.output_format})", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
