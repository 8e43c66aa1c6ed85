"""Columnar ingestion (port of ``spatialflink_tpu.streams.bulk``): a chunk
of records -> structure of arrays, and the lazy per-window record views
built on it; the chunk of a polygon/linestring stream (:class:`GeomChunk`,
parsed objects) with its window view (:class:`GeomRecords`). Both chunk
kinds give the window assemblers a ``ts`` column, a length and
``view(segs)``. And bulk replay (``--bulk``): a whole file parsed in one
native call (:func:`bulk_parse_csv`, :func:`bulk_parse_geojson`,
:func:`bulk_parse_wkt`, :func:`bulk_parse_geojson_geoms`), its windows
assembled at once (:func:`bulk_window_batches`,
:func:`bulk_pane_window_batches`, :func:`bulk_geom_window_batches`, the
geometry batch built columnar by :func:`geoms_to_edge_batch`), read by the
operators through :class:`BulkStream` / :class:`BulkWindow`.

:func:`bulk_parse_csv` and :func:`bulk_parse_geojson` parse a block of
lines in one call of the native ingest (``native/ingest.cpp``, the JAX
package's point parsers copied), with the JAX package's contract: the
accepted rows' object ids are interned in ascending FNV-1a 64 hash order,
and the rows the native parser rejects (date-string timestamps, GeoJSON
ids that are not plain strings or numbers) are reparsed one by one and
interned after them, in line order. kNN breaks distance ties by interned
id, so this order is part of the result.

:func:`bulk_parse_csv_plain` is the line-splitting parser the port used
before it had the native ingest: its plain version, which the tests hold
the native parse against; nothing on the main path calls it.
"""

from __future__ import annotations

import ctypes
import sys
import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spatialflink_tpu_torch.index import UniformGrid
from spatialflink_tpu_torch import native
from spatialflink_tpu_torch.models import EdgeGeomBatch, Point, PointBatch
from spatialflink_tpu_torch.models.batches import GEOM_DTYPES, to_device
from spatialflink_tpu_torch.streams import formats
from spatialflink_tpu_torch.utils import IdInterner, bucket_size, pad_to


@dataclass
class ParsedPoints:
    """Structure-of-arrays parse result (record order preserved)."""

    x: np.ndarray       # (N,) f64
    y: np.ndarray       # (N,) f64
    ts: np.ndarray      # (N,) i64 epoch millis
    obj_id: np.ndarray  # (N,) i32 interned ids
    interner: IdInterner

    def __len__(self) -> int:
        return self.x.shape[0]


_FNV_OFFSET = np.uint64(1469598103934665603)
_FNV_PRIME = np.uint64(1099511628211)


def fnv1a64(strings: Sequence[str]) -> np.ndarray:
    """(n,) uint64 FNV-1a 64 hash of each string's UTF-8 bytes (the id hash
    of the JAX package's native ingest, ``native/ingest.cpp`` fnv1a)."""
    raw = [s.encode() for s in strings]
    n = len(raw)
    h = np.full(n, _FNV_OFFSET, np.uint64)
    width = max((len(b) for b in raw), default=0)
    if not width:
        return h
    data = np.array(raw, dtype=f"S{width}").view(np.uint8).reshape(n, width)
    lens = np.fromiter((len(b) for b in raw), np.int64, count=n)
    with np.errstate(over="ignore"):
        for j in range(width):
            step = (h ^ data[:, j].astype(np.uint64)) * _FNV_PRIME
            h = np.where(lens > j, step, h)
    return h


def _intern(ids: Sequence[str], interner: IdInterner) -> np.ndarray:
    """Interned int32 ids, one dict lookup per DISTINCT id string; new ids
    are interned in ascending :func:`fnv1a64` order."""
    uniq, inv = np.unique(np.asarray(ids, dtype=object), return_inverse=True)
    order = np.argsort(fnv1a64(uniq), kind="stable")
    table = np.empty(len(uniq), np.int32)
    table[order] = np.fromiter((interner.intern(s) for s in uniq[order]),
                               np.int32, count=len(uniq))
    return table[inv.reshape(-1)]


def _intern_in_order(ids: Sequence[str], interner: IdInterner) -> np.ndarray:
    """Interned int32 ids, new ids in order of first appearance."""
    return np.fromiter((interner.intern(s) for s in ids), np.int32,
                       count=len(ids))


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _intern_hashes(data: bytes, oid_hash, oid_start, oid_len,
                   interner: IdInterner, normalize) -> np.ndarray:
    """Interned ids of the accepted rows: one string per distinct hash,
    interned in ascending hash order (``normalize`` applies the id
    normalization the native hash was taken over)."""
    uniq, first, inv = np.unique(oid_hash, return_index=True,
                                 return_inverse=True)
    ids = np.empty(uniq.shape[0], np.int32)
    for u, j in enumerate(first.tolist()):
        s = data[oid_start[j]:oid_start[j] + oid_len[j]].decode("utf-8",
                                                                "replace")
        ids[u] = interner.intern(normalize(s))
    return ids[inv.reshape(-1)]


# CSV ids: parse_csv removes every '"' and trims whitespace; GeoJSON ids:
# the native span is already the decoded value
def _norm_csv(s: str) -> str:
    return s.replace('"', "").strip()


def _norm_raw(s: str) -> str:
    return s


def _nonblank_lines(data: bytes) -> List[bytes]:
    """The native parser's blank-line rule (a line is blank iff it holds
    only spaces, tabs and carriage returns), so reject indices align."""
    return [ln for ln in data.split(b"\n") if ln.strip(b" \t\r")]


def _merge_rejects(accepted: Tuple[np.ndarray, ...],
                   reparsed: List[Tuple[int, Point]],
                   interner: IdInterner) -> ParsedPoints:
    """The accepted rows' columns and the reparsed rows merged back into
    line order; the reparsed rows' ids are interned after the accepted
    ones, in line order."""
    x, y, ts, oid = accepted
    if not reparsed:
        return ParsedPoints(x=x.copy(), y=y.copy(), ts=ts.copy(), obj_id=oid,
                            interner=interner)
    total = x.shape[0] + len(reparsed)
    keep = np.ones(total, bool)
    keep[[line for line, _ in reparsed]] = False
    cols = [np.empty(total, a.dtype) for a in (x, y, ts, oid)]
    for out, a in zip(cols, (x, y, ts, oid)):
        out[keep] = a
    for line, p in reparsed:
        cols[0][line], cols[1][line], cols[2][line] = p.x, p.y, p.timestamp
        cols[3][line] = interner.intern(p.obj_id)
    return ParsedPoints(*cols, interner=interner)


def _native_parse(fn, data: bytes, args, interner: IdInterner, normalize,
                  reparse) -> ParsedPoints:
    """One call of a native point parser over ``data``, then the rejected
    lines through ``reparse(line) -> Point``."""
    cap = data.count(b"\n") + 1
    out = [np.empty(cap, t) for t in (np.float64, np.float64, np.int64,
                                      np.uint64, np.int64, np.int32,
                                      np.int64)]
    ctypes_of = (ctypes.c_double, ctypes.c_double, ctypes.c_int64,
                 ctypes.c_uint64, ctypes.c_int64, ctypes.c_int32,
                 ctypes.c_int64)
    nrej = ctypes.c_long(0)
    n = fn(data + b"\0", len(data), *args,
           *(_ptr(a, t) for a, t in zip(out, ctypes_of)), ctypes.byref(nrej))
    xs, ys, ts, oh, ostart, olen, rej = out
    oid = _intern_hashes(data, oh[:n], ostart[:n], olen[:n], interner,
                         normalize)
    reparsed = []
    if nrej.value:
        lines = _nonblank_lines(data)
        for i in rej[:nrej.value].tolist():
            ln = lines[i].decode("utf-8", "replace")
            p = reparse(ln)
            if not isinstance(p, Point):
                raise ValueError("bulk point ingestion got a non-Point "
                                 f"record: {ln[:120]!r}")
            reparsed.append((i, p))
    return _merge_rejects((xs[:n], ys[:n], ts[:n], oid), reparsed, interner)


def bulk_parse_csv(data: bytes, *, delimiter: str = ",",
                   schema: Sequence = (0, 1, 2, 3),
                   date_format: Optional[str] = formats.DEFAULT_DATE_FORMAT,
                   interner: Optional[IdInterner] = None) -> ParsedPoints:
    """Parse a newline-separated CSV/TSV block of points in one native
    call (``schema`` = column indices of [oID, timestamp, x, y], None =
    absent), with the per-line semantics of :func:`formats.parse_csv`.
    Blank lines are skipped."""
    interner = interner if interner is not None else IdInterner()
    bulk_parse_csv.calls += 1
    schema = (list(schema) + [None] * 4)[:4]
    oi, ti, xi, yi = (-1 if c is None else int(c) for c in schema)
    return _native_parse(
        native.lib().sf_parse_points_csv, data,
        (delimiter.encode()[:1] or b",", oi, ti, xi, yi), interner,
        _norm_csv, lambda ln: formats.parse_csv(
            ln, delimiter=delimiter, schema=schema, date_format=date_format))


def bulk_parse_geojson(data: bytes, *, property_obj_id: str = "oID",
                       property_timestamp: str = "timestamp",
                       date_format: Optional[str] = None,
                       interner: Optional[IdInterner] = None
                       ) -> ParsedPoints:
    """Parse a newline-separated block of GeoJSON Point features in one
    native call; a record of another geometry type raises ValueError."""
    interner = interner if interner is not None else IdInterner()
    bulk_parse_geojson.calls += 1
    kw = dict(property_obj_id=property_obj_id,
              property_timestamp=property_timestamp, date_format=date_format)
    return _native_parse(
        native.lib().sf_parse_points_geojson, data,
        (property_obj_id.encode(), property_timestamp.encode()), interner,
        _norm_raw, lambda ln: formats.parse_geojson(ln, **kw))


#: native parser calls since the process started (a run's count is the
#: difference; chip_smoke.py reads it)
bulk_parse_csv.calls = 0
bulk_parse_geojson.calls = 0


def bulk_parse_csv_plain(lines: Sequence[str], *, delimiter: str = ",",
                   schema: Sequence = (0, 1, 2, 3),
                   date_format: Optional[str] = formats.DEFAULT_DATE_FORMAT,
                   interner: Optional[IdInterner] = None) -> ParsedPoints:
    """Plain version of :func:`bulk_parse_csv` over a list of lines: the
    fields split in Python, the numeric columns converted by numpy, ids
    interned in the native parser's order."""
    interner = interner if interner is not None else IdInterner()
    text = "\n".join(lines)
    if '"' in text or " " in text or "\r" in text or (
            delimiter != "\t" and "\t" in text):
        split = formats.csv_splitter(delimiter)
        rows = [split(ln.replace('"', "").strip()) for ln in lines]
    else:  # plain rows: str.split gives the same fields
        rows = [ln.split(delimiter) for ln in lines]
    oi, ti, xi, yi = (list(schema) + [None] * 4)[:4]
    n = len(rows)
    x = np.array([r[xi] for r in rows], dtype=np.float64)
    y = np.array([r[yi] for r in rows], dtype=np.float64)
    ids = [r[oi] for r in rows] if oi is not None else [""] * n
    numeric = None  # every timestamp is an integer
    if ti is None:
        ts = np.zeros(n, np.int64)
    else:
        tcol = [r[ti] for r in rows]
        try:
            ts = np.array(tcol, dtype=np.int64)
        except ValueError:  # date strings: the exact per-field parse
            ts = np.array([formats.parse_timestamp(t, date_format)
                           for t in tcol], dtype=np.int64)
            numeric = np.array([t.isascii() and t.isdigit() for t in tcol],
                               bool)
    if numeric is None:
        oid = _intern(ids, interner)
    else:  # the JAX native parser's accepted rows first, then the rest
        oid = np.empty(n, np.int32)
        acc, rej = np.nonzero(numeric)[0], np.nonzero(~numeric)[0]
        oid[acc] = _intern([ids[i] for i in acc], interner)
        oid[rej] = _intern_in_order([ids[i] for i in rej], interner)
    return ParsedPoints(x=x, y=y, ts=ts, obj_id=oid, interner=interner)


def points_to_parsed(points: Sequence[Point],
                     interner: IdInterner) -> ParsedPoints:
    """Point objects as columns; new ids interned in order of
    appearance."""
    return ParsedPoints(
        x=np.array([p.x for p in points], np.float64),
        y=np.array([p.y for p in points], np.float64),
        ts=np.array([p.timestamp for p in points], np.int64),
        obj_id=_intern_in_order([p.obj_id for p in points], interner),
        interner=interner)


@dataclass
class PointChunk:
    """One decoded chunk: the columnar parse plus its cell assignment;
    ``ingest_ms`` is the wall clock it was decoded at. ``leaf_cache`` is
    the adaptive grid's ``(version, leaf ids)`` of the chunk, assigned once
    per layout by the prefilter (``SpatialOperator._chunk_leaves``)."""

    parsed: ParsedPoints
    cells: np.ndarray  # (N,) i32, -1 = outside grid
    ingest_ms: int = 0
    leaf_cache: Optional[Tuple[int, np.ndarray]] = field(
        default=None, repr=False, compare=False)

    def __len__(self) -> int:
        return len(self.parsed)

    @property
    def ts(self) -> np.ndarray:
        """(N,) i64 event times (the window assemblers' column)."""
        return self.parsed.ts

    @staticmethod
    def view(segs) -> "LazyRecords":
        """The records of ``(chunk, idx)`` slices of point chunks."""
        return LazyRecords(segs)

    @staticmethod
    def build(parsed: ParsedPoints, grid: UniformGrid) -> "PointChunk":
        cells = np.asarray(grid.assign_cell(parsed.x, parsed.y)[0], np.int32)
        return PointChunk(parsed=parsed, cells=cells,
                          ingest_ms=int(time.time() * 1000))


class LazyRecords:
    """A window's records as ``(PointChunk, idx)`` slices of decoded chunks:
    the device batch builds straight from the slices, and Point objects
    materialize only for records a consumer reads."""

    __slots__ = ("_segs", "_len", "interner")

    def __init__(self, segs):
        self._segs = list(segs)
        self._len = sum(int(idx.size) for _, idx in self._segs)
        self.interner = self._segs[0][0].parsed.interner if self._segs \
            else None

    def __len__(self) -> int:
        return self._len

    def columns(self):
        """Concatenated (x, y, ts, obj_id, cell, ingest_ms) arrays."""
        cols = [[], [], [], [], [], []]
        for chunk, idx in self._segs:
            p = chunk.parsed
            for out, a in zip(cols, (p.x, p.y, p.ts, p.obj_id, chunk.cells)):
                out.append(a[idx])
            cols[5].append(np.full(idx.size, chunk.ingest_ms, np.int64))
        return tuple(np.concatenate(c) for c in cols)

    def ts(self) -> np.ndarray:
        """(N,) int64 event times in window order."""
        if not self._segs:
            return np.zeros(0, np.int64)
        return np.concatenate([c.parsed.ts[idx] for c, idx in self._segs])

    def point_batch(self, ts_base: int, device: torch.device,
                    compact: bool = False
                    ) -> Tuple[PointBatch, Optional[np.ndarray]]:
        """The window's device batch (cells were assigned per chunk) and
        None; with ``compact``, the batch's obj_id is each record's index
        among the window's distinct interned ids, returned beside it
        (ascending, so ascending local id is ascending interned id)."""
        x, y, ts, oid, cell, _ = self.columns()
        ids = None
        if compact:
            ids, local = np.unique(oid, return_inverse=True)
            oid = local.reshape(-1)
        return PointBatch.from_arrays(x, y, device=device, obj_id=oid, ts=ts,
                                      ts_base=ts_base, cell=cell), ids

    def take(self, idx) -> "PointRows":
        """The records at window positions ``idx``."""
        return self.take_many([idx])[0]

    def take_many(self, idx_lists) -> List["PointRows"]:
        """The records at each of several position lists (one per query of
        a multi-query window), concatenating the window's columns once."""
        cols = self.columns()
        return [PointRows(tuple(a[np.asarray(idx, np.int64)] for a in cols),
                          self.interner) for idx in idx_lists]


class PointRows:
    """Selected records as columnar arrays; iterating materializes
    :class:`Point` objects (cached)."""

    __slots__ = ("_cols", "interner", "_mat")

    def __init__(self, cols, interner):
        self._cols = cols  # (x, y, ts, obj_id, cell, ingest_ms)
        self.interner = interner
        self._mat = None

    def __len__(self) -> int:
        return int(self._cols[0].shape[0])

    def columns(self):
        """The (x, y, ts, obj_id, cell, ingest_ms) arrays."""
        return self._cols

    def take(self, idx) -> "PointRows":
        """The rows at positions ``idx`` (an index or a bool mask array)."""
        idx = np.asarray(idx)
        return PointRows(tuple(a[idx] for a in self._cols), self.interner)

    @staticmethod
    def concat(parts: Sequence["PointRows"]) -> "PointRows":
        """The rows of ``parts`` in order, as one :class:`PointRows`."""
        return PointRows(tuple(np.concatenate([p._cols[i] for p in parts])
                               for i in range(6)), parts[0].interner)

    def _materialize(self) -> List[Point]:
        if self._mat is None:
            fx, fy, ft, fo, fc, fi = self._cols
            lk = self.interner.lookup if self.interner is not None else str
            self._mat = [
                Point(obj_id=lk(int(o)), timestamp=int(t), x=float(x),
                      y=float(y), cell=int(c), ingestion_time=int(g))
                for o, t, x, y, c, g in zip(fo, ft, fx, fy, fc, fi)]
        return self._mat

    def __iter__(self):
        return iter(self._materialize())

    def __repr__(self):
        return f"PointRows({len(self)} records)"

    def serialize_batch(self, fmt, *, delimiter: str = ",",
                        date_format=None) -> Optional[List[str]]:
        """The rows serialized straight from the columns, byte for byte
        what ``formats.serialize_geojson`` writes for each Point (ids
        quoted once per distinct object, timestamps formatted once per
        second); None for another format (the caller serializes the
        materialized records)."""
        if not fmt or fmt.lower() != "geojson":
            return None
        import json

        fx, fy, ft, fo, _, _ = self._cols
        lk = self.interner.lookup
        tmpl = ('{"geometry": {"type": "Point", "coordinates": [%r, %r]}, '
                '"properties": {"oID": %s, "timestamp": %s}, '
                '"type": "Feature"}')
        safe = formats._JSON_SAFE_RE.match

        def quote(s):
            return '"%s"' % s if safe(s) else json.dumps(s)

        def per_unique(keys, text):
            """``text(first row of a key)`` once per distinct key, spread
            over the rows as a list."""
            uniq, first, inv = np.unique(keys, return_index=True,
                                         return_inverse=True)
            vals = np.array([text(int(i)) for i in first] + [""],
                            dtype=object)[:-1]
            return vals[inv.reshape(-1)].tolist()

        if not len(fo):
            return []
        qid = per_unique(fo, lambda i: quote(lk(int(fo[i]))))
        if date_format and "%f" not in date_format:
            # formatted once per second (the format has no sub-second
            # token)
            tsj = per_unique(ft // 1000, lambda i: quote(
                formats.format_timestamp(int(ft[i]), date_format)))
        elif date_format:
            tsj = [quote(formats.format_timestamp(t, date_format))
                   for t in ft.tolist()]
        else:
            tsj = ft.tolist()
        return [tmpl % row for row in zip(fx.tolist(), fy.tolist(), qid,
                                          tsj)]


class GeomChunk:
    """One decoded chunk of a polygon/linestring stream: the parsed
    geometry objects (cells assigned at parse) and their event times."""

    __slots__ = ("records", "ts", "ingest_ms")

    def __init__(self, records: Sequence):
        self.records = list(records)
        self.ts = np.array([r.timestamp for r in self.records], np.int64)
        self.ingest_ms = int(time.time() * 1000)

    def __len__(self) -> int:
        return len(self.records)

    @staticmethod
    def view(segs) -> "GeomRecords":
        """The records of ``(chunk, idx)`` slices of geometry chunks."""
        return GeomRecords(segs)


class GeomRecords:
    """A window's geometries as ``(GeomChunk, idx)`` slices: the same chunk
    protocol as :class:`LazyRecords`, over objects. The device batch
    interns ids through the caller's (the operator's) interner, as the JAX
    package's ``_geom_batch`` does."""

    __slots__ = ("_segs", "_len")

    def __init__(self, segs):
        self._segs = list(segs)
        self._len = sum(int(idx.size) for _, idx in self._segs)

    def __len__(self) -> int:
        return self._len

    def ts(self) -> np.ndarray:
        """(G,) int64 event times in window order."""
        if not self._segs:
            return np.zeros(0, np.int64)
        return np.concatenate([c.ts[idx] for c, idx in self._segs])

    def records(self) -> list:
        """The window's geometry objects in window order."""
        return [chunk.records[i] for chunk, idx in self._segs
                for i in idx.tolist()]

    def take(self, idx) -> list:
        """The geometries at window positions ``idx``."""
        return self.take_many([idx])[0]

    def take_many(self, idx_lists) -> List[list]:
        """The geometries at each of several position lists (one per query
        of a multi-query window)."""
        recs = self.records()
        return [[recs[i] for i in np.asarray(idx, np.int64).tolist()]
                for idx in idx_lists]

    def geom_batch(self, ts_base: int, device: torch.device,
                   interner: IdInterner, compact: bool = False
                   ) -> Tuple[EdgeGeomBatch, Optional[np.ndarray]]:
        """The window's :class:`EdgeGeomBatch` (ids interned in window order
        through ``interner``) and None; with ``compact``, its obj_id is each
        record's index among the window's distinct interned ids, returned
        beside it (ascending, so ascending local id is ascending interned
        id)."""
        recs = self.records()
        oid = np.fromiter((interner.intern(r.obj_id) for r in recs),
                          np.int32, count=len(recs))
        ids = None
        if compact:
            ids, local = np.unique(oid, return_inverse=True)
            oid = local.reshape(-1).astype(np.int32)
        return EdgeGeomBatch.from_objects(recs, device=device, obj_id=oid,
                                          ts_base=ts_base), ids


class PairRecords:
    """A join window's pairs as positions into its two sides' records
    (:class:`LazyRecords` or :class:`GeomRecords`): parts ``(records_a,
    records_b, a_idx, b_idx)``, read in order. Iterating materializes
    ``(record_a, record_b)`` tuples (cached), as the JAX package's join
    emits them; ``len`` and :meth:`first_ingest` need no objects."""

    __slots__ = ("_parts", "_mat")

    def __init__(self, parts=()):
        self._parts = [p for p in parts if len(p[2])]
        self._mat = None

    def __len__(self) -> int:
        return sum(int(p[2].size) for p in self._parts)

    def __add__(self, other: "PairRecords") -> "PairRecords":
        return PairRecords(self._parts + other._parts)

    def first_ingest(self) -> np.ndarray:
        """(P,) int64 ingestion wall clock of each pair's first record (its
        decode chunk's stamp for a point, the object's own for a geometry;
        0 where there is none)."""
        out = []
        for recs_a, _, ai, _ in self._parts:
            cols = getattr(recs_a, "columns", None)
            if cols is not None:
                out.append(cols()[5][ai])
            else:
                out.append(np.array([
                    int(getattr(r, "ingestion_time", 0) or 0)
                    for r in recs_a.take(ai)], np.int64))
        return np.concatenate(out) if out else np.zeros(0, np.int64)

    def _materialize(self) -> list:
        if self._mat is None:
            self._mat = [pair for recs_a, recs_b, ai, bi in self._parts
                         for pair in zip(recs_a.take(ai), recs_b.take(bi))]
        return self._mat

    def __iter__(self):
        return iter(self._materialize())

    def __repr__(self):
        return f"PairRecords({len(self)} pairs)"


def parse_points(items: Sequence, cfg, interner: IdInterner) -> ParsedPoints:
    """One decode chunk record by record (the path of a chunk the native
    parsers do not take: GeoJSON dicts, Point objects, lines with interior
    newlines, a chunk holding a record of another geometry type). A
    GeoJSON record of another geometry type is dropped with a warning (an
    off-type record in a declared point stream); ids are interned in order
    of appearance."""
    fmt = cfg.format.lower()
    pts = []
    for r in items:
        if isinstance(r, Point):
            pts.append(r)
        elif fmt == "geojson":
            obj = formats.parse_geojson(r, **cfg.geojson_kwargs())
            if isinstance(obj, Point):
                pts.append(obj)
            else:
                print(f"warning: dropping off-type {type(obj).__name__} "
                      "record from declared Point stream", file=sys.stderr)
        elif fmt in ("csv", "tsv"):
            pts.append(formats.parse_csv(
                r, delimiter="\t" if fmt == "tsv" else cfg.delimiter,
                schema=cfg.csv_tsv_schema, date_format=cfg.date_format))
        else:
            raise ValueError(f"input format {cfg.format!r}: not yet ported "
                             "to spatialflink_tpu_torch (point streams in "
                             "CSV, TSV or GeoJSON)")
    return points_to_parsed(pts, interner)


# ------------------------------------------------------------------------ #
# bulk replay: a whole file parsed at once, its windows assembled at once


def _cells_of(parsed: ParsedPoints, grid) -> np.ndarray:
    """Each record's cell on ``grid`` (once per record, not per window)."""
    if grid is None:
        return np.full(len(parsed), -1, np.int32)
    return np.asarray(grid.assign_cell(parsed.x, parsed.y)[0], np.int32)


def _point_batch_at(parsed: ParsedPoints, idx, cells, ts_base: int,
                    device) -> PointBatch:
    return PointBatch.from_arrays(parsed.x[idx], parsed.y[idx],
                                  device=device, obj_id=parsed.obj_id[idx],
                                  ts=parsed.ts[idx], ts_base=ts_base,
                                  cell=cells[idx])


def bulk_window_batches(parsed: ParsedPoints, spec, grid=None, *,
                        device: torch.device):
    """The windows of a bulk-parsed point stream, assembled at once
    (``WindowSpec.assign_bulk``): ``(start, end, idx, PointBatch)`` in
    window order, ``idx`` the window's original-record indices in record
    order, the batch built from the parse's columns on ``device``; no
    per-record object anywhere."""
    if not len(parsed):
        return
    win, rec = spec.assign_bulk(parsed.ts)
    if not len(win):
        return
    cells = _cells_of(parsed, grid)
    bounds = np.flatnonzero(np.r_[True, win[1:] != win[:-1], True])
    for lo, hi in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        start = int(win[lo])
        idx = rec[lo:hi]
        yield (start, start + spec.size_ms, idx,
               _point_batch_at(parsed, idx, cells, start, device))


def bulk_pane_window_batches(parsed: ParsedPoints, spec, grid=None, *,
                             device: torch.device):
    """The pane twin of :func:`bulk_window_batches` (``--panes``): each
    record lands in one slide-aligned pane, whose batch is built once, when
    a window first needs it, and dropped once no later window covers it;
    windows come as ``(start, end, [(pane_start, (idx, batch)), ...])``
    over the window set ``assign_bulk`` gives. Needs
    ``spec.pane_decomposable()``."""
    if not len(parsed):
        return
    size, slide = spec.size_ms, spec.slide_ms
    ts = np.asarray(parsed.ts, np.int64)
    pane = ts - ts % slide
    order = np.argsort(pane, kind="stable")  # record order within a pane
    pane_s = pane[order]
    cells = _cells_of(parsed, grid)
    bounds = np.flatnonzero(np.r_[True, pane_s[1:] != pane_s[:-1], True])
    slices = {int(pane_s[lo]): order[lo:hi]
              for lo, hi in zip(bounds[:-1].tolist(), bounds[1:].tolist())}
    built: dict = {}
    starts = sorted({s for p in slices
                     for s in range(p - size + slide, p + slide, slide)})
    for s in starts:
        panes = []
        for p in range(s, s + size, slide):
            idx = slices.get(p)
            if idx is None:
                continue
            if p not in built:
                built[p] = _point_batch_at(parsed, idx, cells, p, device)
            panes.append((p, (idx, built[p])))
        for dead in [p for p in built if p < s + slide]:
            del built[dead]
        yield s, s + size, panes


def bulk_parse_file(path: str, fmt: str, **kw) -> ParsedPoints:
    """Bulk-parse a whole replay file of points (CSV, TSV or GeoJSON)."""
    with open(path, "rb") as f:
        data = f.read()
    f = fmt.lower()
    if f in ("csv", "tsv"):
        if f == "tsv":
            kw.setdefault("delimiter", "\t")
        return bulk_parse_csv(data, **kw)
    if f == "geojson":
        return bulk_parse_geojson(data, **kw)
    raise ValueError(f"bulk ingestion supports csv/tsv/geojson, not {fmt!r}")


@dataclass
class ParsedGeoms:
    """Structure of arrays of a bulk polygon/linestring parse, ragged and
    flattened: geometry g owns rings ``ring_off[g] : ring_off[g] +
    ring_cnt[g]``, ring r owns the raw vertices ``ring_voff[r] :
    ring_voff[r] + ring_size[r]`` of (``vx``, ``vy``). Lines the native
    parser rejects (multi-geometries, date-string timestamps, malformed
    text) are parsed per record and flattened into the same arrays, in
    line order."""

    ts: np.ndarray         # (N,) i64 epoch millis
    obj_id: np.ndarray     # (N,) i32 interned
    is_areal: np.ndarray   # (N,) bool
    bbox: np.ndarray       # (N, 4) f64
    ring_off: np.ndarray   # (N,) i64
    ring_cnt: np.ndarray   # (N,) i32
    ring_voff: np.ndarray  # (R,) i64
    ring_size: np.ndarray  # (R,) i32
    vx: np.ndarray         # (V,) f64
    vy: np.ndarray         # (V,) f64
    interner: IdInterner
    #: (N,) bool: a multi-part geometry of a rejected line, whose rings are
    #: already in its object's order (None: no such record)
    multi: Optional[np.ndarray] = None

    def __len__(self) -> int:
        return self.ts.shape[0]

    def subset(self, idx: np.ndarray) -> "ParsedGeoms":
        """The geometries at ``idx``, ring and vertex offsets re-based."""
        idx = np.asarray(idx)
        rcnt = self.ring_cnt[idx]
        rrep = np.repeat(np.arange(idx.size), rcnt)
        cum = np.concatenate([[0], np.cumsum(rcnt)])
        rpos = np.arange(int(cum[-1])) - np.repeat(cum[:-1], rcnt)
        rings = self.ring_off[idx][rrep] + rpos
        sizes = self.ring_size[rings].astype(np.int64)
        vrep = np.repeat(np.arange(rings.size), sizes)
        vcum = np.concatenate([[0], np.cumsum(sizes)])
        vpos = np.arange(int(vcum[-1])) - np.repeat(vcum[:-1], sizes)
        verts = self.ring_voff[rings][vrep] + vpos
        return ParsedGeoms(
            ts=self.ts[idx], obj_id=self.obj_id[idx],
            is_areal=self.is_areal[idx], bbox=self.bbox[idx],
            ring_off=cum[:-1].astype(np.int64), ring_cnt=rcnt,
            ring_voff=vcum[:-1].astype(np.int64),
            ring_size=sizes.astype(np.int32),
            vx=self.vx[verts], vy=self.vy[verts], interner=self.interner,
            multi=None if self.multi is None else self.multi[idx])


def _object_rings(obj) -> Tuple[List[np.ndarray], bool]:
    """A parsed geometry's rings as coordinate arrays, and whether it is
    areal: how a rejected line's object flattens into :class:`ParsedGeoms`
    (a multi-geometry gives all its parts' rings, the edges
    ``EdgeGeomBatch.from_objects`` takes from ``edge_array``)."""
    from spatialflink_tpu_torch.models import objects as O

    if isinstance(obj, O.MultiPolygon):
        return [np.asarray(r, np.float64) for p in obj.polygons
                for r in p.rings], True
    if isinstance(obj, O.Polygon):
        return [np.asarray(r, np.float64) for r in obj.rings], True
    if isinstance(obj, O.MultiLineString):
        return [np.asarray(ln.coords_list, np.float64)
                for ln in obj.lines], False
    if isinstance(obj, O.LineString):
        return [np.asarray(obj.coords_list, np.float64)], False
    raise ValueError(
        f"bulk WKT geometry ingestion got {type(obj).__name__}; use "
        "streams.formats.parse_spatial for mixed-geometry streams")


def bulk_parse_wkt(data: bytes, *, delimiter: str = ",",
                   date_format: Optional[str] = formats.DEFAULT_DATE_FORMAT,
                   interner: Optional[IdInterner] = None) -> ParsedGeoms:
    """Parse a newline-separated block of WKT polygon/linestring records
    (optional ``oid<delim>ts<delim>`` fields before the geometry) in one
    native call: the block form of ``parse_spatial(..., "WKT")``
    (``Deserialization.java:516-628``). Ids are interned as the point
    parsers intern them; rejected lines parse per record."""
    interner = interner if interner is not None else IdInterner()
    bulk_parse_wkt.calls += 1

    def parse_line(ln):
        return formats.parse_spatial(ln, "WKT", None, delimiter=delimiter,
                                     date_format=date_format)

    lib = native.lib()
    return _native_geoms_parse(
        data, lambda buf, *arrs: lib.sf_parse_wkt_geoms(
            buf, len(data), delimiter.encode()[:1] or b",", *arrs),
        parse_line, interner, _norm_csv, max(1, data.count(b"(")),
        data.count(b",") + max(1, data.count(b"(")) + 2)


def bulk_parse_geojson_geoms(data: bytes, *, property_obj_id: str = "oID",
                             property_timestamp: str = "timestamp",
                             date_format: Optional[str] = None,
                             interner: Optional[IdInterner] = None
                             ) -> ParsedGeoms:
    """Parse a newline-separated block of GeoJSON Polygon/LineString
    features in one native call: the block form of ``parse_spatial(...,
    "GeoJSON")`` (``Deserialization.java:236-334``); points, multi-
    geometries, collections, escaped strings and date-string timestamps
    parse per record, so it accepts what the record path accepts."""
    interner = interner if interner is not None else IdInterner()
    bulk_parse_geojson_geoms.calls += 1
    kw = dict(property_obj_id=property_obj_id,
              property_timestamp=property_timestamp, date_format=date_format)

    def parse_line(ln):
        return formats.parse_spatial(ln, "GeoJSON", None, **kw)

    lib = native.lib()
    capr = max(1, data.count(b"["))  # every level opens one '['
    return _native_geoms_parse(
        data, lambda buf, *arrs: lib.sf_parse_geojson_geoms(
            buf, len(data), property_obj_id.encode(),
            property_timestamp.encode(), *arrs),
        parse_line, interner, _norm_raw, capr, capr + 2)


#: native geometry parser calls since the process started
bulk_parse_wkt.calls = 0
bulk_parse_geojson_geoms.calls = 0


def _native_geoms_parse(data: bytes, invoke, parse_line, interner, norm,
                        capr: int, capv: int) -> ParsedGeoms:
    """The buffers and the assembly shared by the two native geometry
    parsers (one output contract): ``invoke(buf, *outputs)`` calls the
    symbol with its leading arguments; rejected lines go through
    ``parse_line``."""
    cap = data.count(b"\n") + 1
    ts = np.empty(cap, np.int64)
    oh = np.empty(cap, np.uint64)
    ostart = np.empty(cap, np.int64)
    olen = np.empty(cap, np.int32)
    ispoly = np.empty(cap, np.int8)
    roff = np.empty(cap, np.int64)
    rcnt = np.empty(cap, np.int32)
    bbox = np.empty((cap, 4), np.float64)
    rvoff = np.empty(capr, np.int64)
    rsize = np.empty(capr, np.int32)
    vx = np.empty(capv, np.float64)
    vy = np.empty(capv, np.float64)
    rej = np.empty(cap, np.int64)
    nrej = ctypes.c_long(0)
    n = invoke(
        data + b"\0",
        _ptr(ts, ctypes.c_int64), _ptr(oh, ctypes.c_uint64),
        _ptr(ostart, ctypes.c_int64), _ptr(olen, ctypes.c_int32),
        _ptr(ispoly, ctypes.c_int8), _ptr(roff, ctypes.c_int64),
        _ptr(rcnt, ctypes.c_int32), _ptr(bbox, ctypes.c_double),
        _ptr(rvoff, ctypes.c_int64), _ptr(rsize, ctypes.c_int32),
        _ptr(vx, ctypes.c_double), _ptr(vy, ctypes.c_double),
        _ptr(rej, ctypes.c_int64), ctypes.byref(nrej))
    oid = _intern_hashes(data, oh[:n], ostart[:n], olen[:n], interner, norm)
    n_rings = int(rcnt[:n].sum())
    n_verts = int(rsize[:n_rings].sum()) if n_rings else 0
    accepted = ParsedGeoms(
        ts=ts[:n].copy(), obj_id=oid, is_areal=ispoly[:n].astype(bool),
        bbox=bbox[:n].copy(), ring_off=roff[:n].copy(),
        ring_cnt=rcnt[:n].copy(), ring_voff=rvoff[:n_rings].copy(),
        ring_size=rsize[:n_rings].copy(), vx=vx[:n_verts].copy(),
        vy=vy[:n_verts].copy(), interner=interner)
    if not nrej.value:
        return accepted
    lines = _nonblank_lines(data)
    reparsed = [(i, parse_line(lines[i].decode("utf-8", "replace")))
                for i in rej[:nrej.value].tolist()]
    return _merge_geom_rejects(accepted, reparsed, interner)


def _merge_geom_rejects(accepted: ParsedGeoms, reparsed, interner
                        ) -> ParsedGeoms:
    """The per-record parses of the rejected lines flattened into the
    layout and put back in line order among the accepted records; their
    ids are interned after the accepted ones, in line order. Python loops
    touch only the rejected objects; the line-order permutation is a
    :meth:`ParsedGeoms.subset`."""
    from spatialflink_tpu_torch.models import objects as O

    n_acc = len(accepted)
    m = len(reparsed)
    rings: List[np.ndarray] = []
    r_cnt = np.empty(m, np.int32)
    r_ts = np.empty(m, np.int64)
    r_oid = np.empty(m, np.int32)
    r_areal = np.empty(m, bool)
    r_bbox = np.empty((m, 4), np.float64)
    r_multi = np.array([isinstance(obj, (O.MultiPolygon, O.MultiLineString))
                        for _, obj in reparsed], bool)
    for j, (_line, obj) in enumerate(reparsed):
        rl, areal = _object_rings(obj)
        rings.extend(rl)
        r_cnt[j] = len(rl)
        r_ts[j] = obj.timestamp
        r_oid[j] = interner.intern(obj.obj_id)
        r_areal[j] = areal
        r_bbox[j] = np.asarray(obj.bbox, np.float64)
    r_size = np.array([r.shape[0] for r in rings], np.int32)
    coords = (np.concatenate(rings, axis=0) if rings
              else np.empty((0, 2)))
    n_rings, n_verts = accepted.ring_size.shape[0], accepted.vx.shape[0]
    combined = ParsedGeoms(
        ts=np.concatenate([accepted.ts, r_ts]),
        obj_id=np.concatenate([accepted.obj_id, r_oid]),
        is_areal=np.concatenate([accepted.is_areal, r_areal]),
        bbox=np.concatenate([accepted.bbox.reshape(n_acc, 4), r_bbox]),
        ring_off=np.concatenate([accepted.ring_off, n_rings + np.concatenate(
            [[0], np.cumsum(r_cnt)])[:-1].astype(np.int64)]),
        ring_cnt=np.concatenate([accepted.ring_cnt, r_cnt]),
        ring_voff=np.concatenate([accepted.ring_voff, n_verts +
                                  np.concatenate([[0], np.cumsum(r_size)])
                                  [:-1].astype(np.int64)]),
        ring_size=np.concatenate([accepted.ring_size, r_size]),
        vx=np.concatenate([accepted.vx, coords[:, 0]]),
        vy=np.concatenate([accepted.vy, coords[:, 1]]),
        interner=interner, multi=np.concatenate([
            np.zeros(n_acc, bool) if accepted.multi is None
            else accepted.multi, r_multi]))
    # accepted rows take the lines not rejected, in order
    total = n_acc + m
    line_of = np.empty(total, np.int64)
    rej_lines = np.array([line for line, _ in reparsed], np.int64)
    is_rej = np.zeros(total, bool)
    is_rej[rej_lines] = True
    line_of[:n_acc] = np.nonzero(~is_rej)[0]
    line_of[n_acc:] = rej_lines
    return combined.subset(np.argsort(line_of, kind="stable"))


def _ring_order(parsed: ParsedGeoms) -> np.ndarray:
    """The rings in the order of the objects the record path builds: a
    polygon's rings by area, largest first, ties in text order
    (``Polygon.create``); a multi-part geometry's as they are."""
    from spatialflink_tpu_torch.models.objects import (_close_ring,
                                                        _ring_area)

    order = np.arange(parsed.ring_size.shape[0])
    several = parsed.is_areal & (parsed.ring_cnt > 1)
    if parsed.multi is not None:
        several &= ~parsed.multi
    for g in np.nonzero(several)[0].tolist():
        lo, cnt = int(parsed.ring_off[g]), int(parsed.ring_cnt[g])
        areas = []
        for r in range(lo, lo + cnt):
            v0 = int(parsed.ring_voff[r])
            v1 = v0 + int(parsed.ring_size[r])
            areas.append(_ring_area(_close_ring(zip(
                parsed.vx[v0:v1].tolist(), parsed.vy[v0:v1].tolist()))))
        order[lo:lo + cnt] = lo + np.array(
            sorted(range(cnt), key=areas.__getitem__, reverse=True))
    return order


def geoms_to_edge_batch(parsed: ParsedGeoms, grid=None, *,
                        device: torch.device, ts_base: int = 0,
                        pad: Optional[int] = None,
                        edge_pad: Optional[int] = None,
                        cell_pad: Optional[int] = None) -> EdgeGeomBatch:
    """A :class:`ParsedGeoms` as an :class:`EdgeGeomBatch` on ``device``,
    built with numpy over the flattened arrays, field for field the batch
    ``EdgeGeomBatch.from_objects`` builds from the parsed objects: a
    polygon ring closed by one more edge when its first and last raw
    vertices differ, a linestring an open chain, the edges of each
    geometry's rings in its object's ring order (:func:`_ring_order`; the
    JAX package keeps the text's order, which gives the same distances
    and parities); the cells those the bbox overlaps on
    ``grid``, ascending, with the bbox centre's cell (else the least) as
    the representative; the same paddings."""
    n = len(parsed)
    if n == 0:
        return EdgeGeomBatch.from_objects([], device=device, ts_base=ts_base,
                                          pad=pad)
    ring = _ring_order(parsed)
    sizes = parsed.ring_size[ring].astype(np.int64)
    voff = parsed.ring_voff[ring]
    n_rings = sizes.shape[0]
    ring_geom = np.repeat(np.arange(n), parsed.ring_cnt)
    if n_rings:
        closure = parsed.is_areal[ring_geom] & (
            (parsed.vx[voff] != parsed.vx[voff + sizes - 1])
            | (parsed.vy[voff] != parsed.vy[voff + sizes - 1]))
        e_r = sizes - 1 + closure
        eoff = np.concatenate([[0], np.cumsum(e_r)])
        base_cnt = sizes - 1
        brep = np.repeat(np.arange(n_rings), base_cnt)
        bcum = np.concatenate([[0], np.cumsum(base_cnt)])
        bpos = np.arange(int(bcum[-1])) - np.repeat(bcum[:-1], base_cnt)
        src = voff[brep] + bpos
        e_flat = np.empty((int(eoff[-1]), 4), np.float32)
        dest = eoff[brep] + bpos
        e_flat[dest, 0] = parsed.vx[src]
        e_flat[dest, 1] = parsed.vy[src]
        e_flat[dest, 2] = parsed.vx[src + 1]
        e_flat[dest, 3] = parsed.vy[src + 1]
        cr = np.nonzero(closure)[0]
        cdest = eoff[cr] + sizes[cr] - 1
        last = voff[cr] + sizes[cr] - 1
        e_flat[cdest, 0] = parsed.vx[last]
        e_flat[cdest, 1] = parsed.vy[last]
        e_flat[cdest, 2] = parsed.vx[voff[cr]]
        e_flat[cdest, 3] = parsed.vy[voff[cr]]
        ge = np.bincount(ring_geom, weights=e_r, minlength=n).astype(np.int64)
    else:
        e_flat = np.empty((0, 4), np.float32)
        ge = np.zeros(n, np.int64)
    E = (bucket_size(max(int(ge.max()), 1), 8) if edge_pad is None
         else edge_pad)
    edges = np.zeros((n, E, 4), np.float32)
    emask = np.zeros((n, E), bool)
    if n_rings:
        goff = np.concatenate([[0], np.cumsum(ge)])
        edge_geom = np.repeat(np.arange(n), ge)
        pos = np.arange(int(goff[-1])) - np.repeat(goff[:-1], ge)
        edges[edge_geom, pos] = e_flat
        emask[edge_geom, pos] = True
    cell_rep = np.full(n, -1, np.int32)
    if grid is not None:
        ix1, iy1 = grid.cell_indices(parsed.bbox[:, 0], parsed.bbox[:, 1])
        ix2, iy2 = grid.cell_indices(parsed.bbox[:, 2], parsed.bbox[:, 3])
        inside = (ix2 >= 0) & (iy2 >= 0) & (ix1 < grid.n) & (iy1 < grid.n)
        ix1c, iy1c = np.clip(ix1, 0, grid.n - 1), np.clip(iy1, 0, grid.n - 1)
        ix2c, iy2c = np.clip(ix2, 0, grid.n - 1), np.clip(iy2, 0, grid.n - 1)
        nx = np.where(inside, ix2c - ix1c + 1, 0)
        ny = np.where(inside, iy2c - iy1c + 1, 0)
        counts = nx * ny
        C = (bucket_size(max(int(counts.max()), 1), 8) if cell_pad is None
             else cell_pad)
        cells = np.full((n, C), -1, np.int32)
        cmask = np.zeros((n, C), bool)
        total = int(counts.sum())
        if total:
            grep = np.repeat(np.arange(n), counts)
            gcum = np.concatenate([[0], np.cumsum(counts)])
            gpos = np.arange(total) - np.repeat(gcum[:-1], counts)
            ny_r = np.maximum(np.repeat(ny, counts), 1)
            cxs = np.repeat(ix1c, counts) + gpos // ny_r
            cys = np.repeat(iy1c, counts) + gpos % ny_r
            cells[grep, gpos] = (cxs * grid.n + cys).astype(np.int32)
            cmask[grep, gpos] = True
        # the representative: the bbox centre's cell when valid (it lies in
        # the bbox's range), else the least overlapped cell
        c, valid = grid.assign_cell((parsed.bbox[:, 0] + parsed.bbox[:, 2]) / 2,
                                    (parsed.bbox[:, 1] + parsed.bbox[:, 3]) / 2)
        rep = np.where(np.asarray(valid), np.asarray(c, np.int64),
                       ix1c * grid.n + iy1c)
        cell_rep = np.where(counts > 0, rep, -1).astype(np.int32)
    else:
        C = cell_pad or 8
        cells = np.full((n, C), -1, np.int32)
        cmask = np.zeros((n, C), bool)
    size = bucket_size(n, 8) if pad is None else pad
    host = {
        "edges": pad_to(edges, size), "edge_mask": pad_to(emask, size),
        "bbox": pad_to(parsed.bbox.astype(np.float32), size),
        "obj_id": pad_to(parsed.obj_id, size),
        "ts": pad_to((parsed.ts - int(ts_base)).astype(np.int32), size),
        "cell": pad_to(cell_rep, size, fill=-1),
        "cells": pad_to(cells, size, fill=-1),
        "cells_mask": pad_to(cmask, size),
        "is_areal": pad_to(parsed.is_areal, size),
        "valid": pad_to(np.ones(n, bool), size),
    }
    return EdgeGeomBatch(**{k: to_device(v, GEOM_DTYPES[k], device)
                            for k, v in host.items()})


def bulk_geom_window_batches(parsed: ParsedGeoms, spec, grid=None, *,
                             device: torch.device):
    """The windows of a bulk-parsed polygon/linestring stream, assembled
    at once: ``(start, end, idx, EdgeGeomBatch)`` in window order (the
    geometry twin of :func:`bulk_window_batches`)."""
    if not len(parsed):
        return
    win, rec = spec.assign_bulk(parsed.ts)
    if not len(win):
        return
    bounds = np.flatnonzero(np.r_[True, win[1:] != win[:-1], True])
    for lo, hi in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        start = int(win[lo])
        idx = rec[lo:hi]
        yield (start, start + spec.size_ms, idx,
               geoms_to_edge_batch(parsed.subset(idx), grid, device=device,
                                   ts_base=start,
                                   pad=bucket_size(idx.size, 8)))


def bulk_parse_geom_file(path: str, fmt: str = "WKT", **kw) -> ParsedGeoms:
    """Bulk-parse a whole replay file of WKT or GeoJSON polygon/linestring
    records (``delimiter``/``date_format`` for WKT;
    ``property_obj_id``/``property_timestamp``/``date_format`` for
    GeoJSON)."""
    f = fmt.lower()
    if f not in ("wkt", "geojson"):
        raise ValueError(
            f"bulk geometry ingestion supports WKT/GeoJSON, not {fmt!r}")
    with open(path, "rb") as fh:
        data = fh.read()
    if f == "wkt":
        return bulk_parse_wkt(data, **kw)
    return bulk_parse_geojson_geoms(data, **kw)


class BulkWindow:
    """A bulk window's (or pane's) records: their original-record indices
    ``idx`` and the batch built from the parse's columns. The operators
    read it as they read a decoded window (:class:`LazyRecords`,
    :class:`GeomRecords`): its batch, and ``take`` of selected positions,
    which gives original-record index lists; ids resolve through the
    parse's ``interner``."""

    __slots__ = ("idx", "batch", "interner")

    def __init__(self, idx: np.ndarray, batch, interner: IdInterner):
        self.idx, self.batch, self.interner = idx, batch, interner

    def __len__(self) -> int:
        return int(self.idx.size)

    def point_batch(self, ts_base: int, device, compact: bool = False):
        if compact:
            raise ValueError("a bulk window has no realtime form")
        return self.batch, None

    def geom_batch(self, ts_base: int, device, interner, compact=False):
        return self.point_batch(ts_base, device, compact)

    def take(self, idx) -> List[int]:
        return self.idx[np.asarray(idx, np.int64)].tolist()

    def take_many(self, idx_lists) -> List[List[int]]:
        return [self.take(idx) for idx in idx_lists]


class BulkStream:
    """A bulk-parsed stream (:class:`ParsedPoints` or :class:`ParsedGeoms`)
    as an operator's input: every window assembled at once by
    :func:`bulk_window_batches` / :func:`bulk_geom_window_batches`, or, with
    ``panes`` and the operator's pane mode, pane by pane by
    :func:`bulk_pane_window_batches` (point streams)."""

    __slots__ = ("parsed", "panes")

    def __init__(self, parsed, panes: bool = True):
        self.parsed, self.panes = parsed, panes

    def windows(self, spec, grid, device):
        p = self.parsed
        gen = (bulk_geom_window_batches if isinstance(p, ParsedGeoms)
               else bulk_window_batches)
        for start, end, idx, batch in gen(p, spec, grid, device=device):
            yield start, end, BulkWindow(idx, batch, p.interner)

    def pane_windows(self, spec, grid, device):
        p = self.parsed
        for start, end, panes in bulk_pane_window_batches(p, spec, grid,
                                                          device=device):
            yield start, end, [(s, BulkWindow(idx, batch, p.interner))
                               for s, (idx, batch) in panes]
