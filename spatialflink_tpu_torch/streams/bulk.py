"""Columnar point ingestion (port of the point parts of
``spatialflink_tpu.streams.bulk``): a chunk of records -> structure of
arrays, and the lazy per-window record views built on it; and the chunk
of a polygon/linestring stream (:class:`GeomChunk`, parsed objects) with
its window view (:class:`GeomRecords`). Both chunk kinds give the window
assemblers a ``ts`` column, a length and ``view(segs)``.

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
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spatialflink_tpu_torch.index import UniformGrid
from spatialflink_tpu_torch import native
from spatialflink_tpu_torch.models import EdgeGeomBatch, Point, PointBatch
from spatialflink_tpu_torch.streams import formats
from spatialflink_tpu_torch.utils import IdInterner


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
    ``ingest_ms`` is the wall clock it was decoded at."""

    parsed: ParsedPoints
    cells: np.ndarray  # (N,) i32, -1 = outside grid
    ingest_ms: int = 0

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
