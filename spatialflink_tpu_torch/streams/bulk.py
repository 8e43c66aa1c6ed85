"""Columnar point ingestion (port of the point parts of
``spatialflink_tpu.streams.bulk``): a chunk of records -> structure of
arrays, and the lazy per-window record views built on it.

The JAX package parses CSV in native C++; this port splits the lines in
Python and converts the numeric columns with numpy in one call each (no
native ingest yet). Records that are not plain numeric rows (date-string
timestamps) parse per field through :func:`formats.parse_timestamp`.

Object ids are interned in the order the JAX package's ingest gives them,
because kNN breaks distance ties by interned id: a chunk's ids that its
native parser accepts (CSV/TSV rows with an all-digit timestamp, GeoJSON
points) in ascending FNV-1a 64 hash order of the id's bytes, the rows it
hands back to Python (date-string timestamps) in line order after them,
and Point objects in order of appearance.
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch

from spatialflink_tpu_torch.index import UniformGrid
from spatialflink_tpu_torch.models import Point, PointBatch
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


def bulk_parse_csv(lines: Sequence[str], *, delimiter: str = ",",
                   schema: Sequence = (0, 1, 2, 3),
                   date_format: Optional[str] = formats.DEFAULT_DATE_FORMAT,
                   interner: Optional[IdInterner] = None) -> ParsedPoints:
    """Parse CSV/TSV point rows (``schema`` = column indices of [oID,
    timestamp, x, y], None = absent), with the per-line semantics of
    :func:`formats.parse_csv`."""
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


def points_to_parsed(points: Sequence[Point], interner: IdInterner, *,
                     by_hash: bool = False) -> ParsedPoints:
    """Point objects as columns; new ids interned in order of appearance,
    or in :func:`fnv1a64` order (``by_hash``, for records the JAX package
    ingests natively)."""
    intern = _intern if by_hash else _intern_in_order
    return ParsedPoints(
        x=np.array([p.x for p in points], np.float64),
        y=np.array([p.y for p in points], np.float64),
        ts=np.array([p.timestamp for p in points], np.int64),
        obj_id=intern([p.obj_id for p in points], interner),
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

    def point_batch(self, ts_base: int, device: torch.device) -> PointBatch:
        """The window's device batch (cells were assigned per chunk)."""
        x, y, ts, oid, cell, _ = self.columns()
        return PointBatch.from_arrays(x, y, device=device, obj_id=oid, ts=ts,
                                      ts_base=ts_base, cell=cell)

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


def parse_points(items: Sequence, cfg, interner: IdInterner) -> ParsedPoints:
    """One decode chunk -> ParsedPoints. CSV/TSV lines take the columnar
    parse; GeoJSON records (str or dict) and Point objects parse one by
    one (GeoJSON ids interned as the JAX native GeoJSON parser does). A
    record of another geometry type is dropped with a warning (an off-type
    record in a declared point stream)."""
    fmt = cfg.format.lower()
    if fmt in ("csv", "tsv") and all(isinstance(r, str) for r in items):
        return bulk_parse_csv(
            items, delimiter="\t" if fmt == "tsv" else cfg.delimiter,
            schema=cfg.csv_tsv_schema, date_format=cfg.date_format,
            interner=interner)
    pts = []
    by_hash = fmt == "geojson" and all(isinstance(r, str) for r in items)
    for r in items:
        if isinstance(r, Point):
            pts.append(r)
        elif fmt == "geojson":
            try:
                pts.append(formats.parse_geojson(r, **cfg.geojson_kwargs()))
            except formats.OffTypeRecord as e:
                print(f"warning: dropping off-type {e} record from declared "
                      "Point stream", file=sys.stderr)
        elif fmt in ("csv", "tsv"):
            pts.append(formats.parse_csv(
                r, delimiter="\t" if fmt == "tsv" else cfg.delimiter,
                schema=cfg.csv_tsv_schema, date_format=cfg.date_format))
        else:
            raise ValueError(f"input format {cfg.format!r}: not yet ported "
                             "to spatialflink_tpu_torch (point streams in "
                             "CSV, TSV or GeoJSON)")
    return points_to_parsed(pts, interner, by_hash=by_hash)
