"""Host-side spatial objects (port of ``spatialflink_tpu.models.objects``:
``Point``, ``Polygon``, ``LineString``, ``MultiPoint``, ``MultiPolygon``,
``MultiLineString``, ``GeometryCollection``).

Records and query geometries live on the host; device work runs on the
padded batches of :mod:`spatialflink_tpu_torch.models.batches`.

- Every object carries ``obj_id``, ``timestamp`` (epoch millis) and an
  ``ingestion_time`` stamped at construction.
- ``Polygon`` rings are auto-closed; the largest-area ring is the shell.
- Points get one grid cell; polygons/linestrings the set of cells their
  bounding box overlaps.
- The edge geometries (``_EdgeGeom``: polygons, linestrings and their
  multi forms) are what a polygon or linestring stream keeps; a point,
  multi-point or collection in such a stream is off-type.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Set, Tuple

import numpy as np

from spatialflink_tpu_torch.index import UniformGrid

Coord = Tuple[float, float]


def _now_ms() -> int:
    return int(time.time() * 1000)


def _ring_area(ring: Sequence[Coord]) -> float:
    """Absolute shoelace area of a ring."""
    a = np.asarray(ring, dtype=np.float64)
    x, y = a[:, 0], a[:, 1]
    return abs(float(np.dot(x, np.roll(y, -1))
                     - np.dot(y, np.roll(x, -1)))) / 2


def _close_ring(ring: Sequence[Coord]) -> List[Coord]:
    ring = [tuple(map(float, c)) for c in ring]
    if ring and ring[0] != ring[-1]:
        ring.append(ring[0])
    return ring


def _coords_bbox(coords: np.ndarray) -> Tuple[float, float, float, float]:
    return (float(coords[:, 0].min()), float(coords[:, 1].min()),
            float(coords[:, 0].max()), float(coords[:, 1].max()))


@dataclass
class SpatialObject:
    """Base record: object id + event timestamp (epoch millis)."""

    obj_id: str = ""
    timestamp: int = 0
    ingestion_time: int = field(default_factory=_now_ms)


@dataclass
class Point(SpatialObject):
    x: float = 0.0
    y: float = 0.0
    cell: int = -1  # int cell id; -1 = unassigned / outside grid
    # the DEIM check-in fields (``Point.java:44-46``; apps.check_in)
    event_id: str = ""
    device_id: str = ""
    user_id: str = ""

    @classmethod
    def create(cls, x: float, y: float, grid: Optional[UniformGrid] = None,
               obj_id: str = "", timestamp: int = 0, **kw) -> "Point":
        p = cls(obj_id=obj_id, timestamp=timestamp, x=float(x), y=float(y),
                **kw)
        if grid is not None:
            cell, _ = grid.assign_cell(p.x, p.y)
            p.cell = int(cell)
        return p


@dataclass
class _EdgeGeom(SpatialObject):
    """Shared machinery for polygons / linestrings: bbox, grid-cell set,
    and an edge-array view."""

    bbox: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    cells: Set[int] = field(default_factory=set)
    cell: int = -1  # representative cell

    def _assign_cells(self, grid: Optional[UniformGrid]) -> None:
        if grid is None:
            return
        self.cells = grid.bbox_cells(*self.bbox)
        if self.cells:
            cx = (self.bbox[0] + self.bbox[2]) / 2
            cy = (self.bbox[1] + self.bbox[3]) / 2
            c, valid = grid.assign_cell(cx, cy)
            self.cell = (int(c) if valid and int(c) in self.cells
                         else min(self.cells))

    def edge_array(self) -> Tuple[np.ndarray, np.ndarray]:
        """-> (edges (E,4) f64 [x1, y1, x2, y2], mask (E,) bool)."""
        raise NotImplementedError


@dataclass
class Polygon(_EdgeGeom):
    """Polygon with optional holes. ``rings[0]`` is the shell."""

    rings: List[List[Coord]] = field(default_factory=list)

    @classmethod
    def create(cls, rings: Sequence[Sequence[Coord]],
               grid: Optional[UniformGrid] = None, obj_id: str = "",
               timestamp: int = 0) -> "Polygon":
        closed = [_close_ring(r) for r in rings if len(r) >= 3]
        if not closed:
            raise ValueError("polygon needs at least one ring of >= 3 coords")
        closed.sort(key=_ring_area, reverse=True)
        p = cls(obj_id=obj_id, timestamp=timestamp, rings=closed)
        p.bbox = _coords_bbox(
            np.concatenate([np.asarray(r, np.float64) for r in closed]))
        p._assign_cells(grid)
        return p

    def edge_array(self) -> Tuple[np.ndarray, np.ndarray]:
        segs = []
        for ring in self.rings:
            r = np.asarray(ring, dtype=np.float64)
            segs.append(np.concatenate([r[:-1], r[1:]], axis=1))
        edges = np.concatenate(segs, axis=0)
        return edges, np.ones(len(edges), dtype=bool)


@dataclass
class LineString(_EdgeGeom):
    coords_list: List[Coord] = field(default_factory=list)

    @classmethod
    def create(cls, coords: Sequence[Coord],
               grid: Optional[UniformGrid] = None, obj_id: str = "",
               timestamp: int = 0) -> "LineString":
        cc = [tuple(map(float, c)) for c in coords]
        if len(cc) < 2:
            raise ValueError("linestring needs >= 2 coords")
        ls = cls(obj_id=obj_id, timestamp=timestamp, coords_list=cc)
        ls.bbox = _coords_bbox(np.asarray(cc, np.float64))
        ls._assign_cells(grid)
        return ls

    def edge_array(self) -> Tuple[np.ndarray, np.ndarray]:
        r = np.asarray(self.coords_list, dtype=np.float64)
        edges = np.concatenate([r[:-1], r[1:]], axis=1)
        return edges, np.ones(len(edges), dtype=bool)


@dataclass
class MultiPoint(SpatialObject):
    points: List[Coord] = field(default_factory=list)
    bbox: Tuple[float, float, float, float] = (0.0, 0.0, 0.0, 0.0)
    cells: Set[int] = field(default_factory=set)
    cell: int = -1

    @classmethod
    def create(cls, coords, grid=None, obj_id="", timestamp=0) -> "MultiPoint":
        cc = [tuple(map(float, c)) for c in coords]
        mp = cls(obj_id=obj_id, timestamp=timestamp, points=cc)
        mp.bbox = _coords_bbox(np.asarray(cc, np.float64))
        if grid is not None:
            mp.cells = grid.bbox_cells(*mp.bbox)
            cell, _ = grid.assign_cell(*cc[0])
            mp.cell = int(cell)
        return mp


@dataclass
class MultiPolygon(_EdgeGeom):
    """Multiple polygons under one object id."""

    polygons: List[Polygon] = field(default_factory=list)

    @classmethod
    def create(cls, list_of_rings, grid=None, obj_id="",
               timestamp=0) -> "MultiPolygon":
        polys = [Polygon.create(rings, None, obj_id, timestamp)
                 for rings in list_of_rings]
        mp = cls(obj_id=obj_id, timestamp=timestamp, polygons=polys)
        boxes = np.asarray([p.bbox for p in polys])
        mp.bbox = (boxes[:, 0].min(), boxes[:, 1].min(),
                   boxes[:, 2].max(), boxes[:, 3].max())
        mp._assign_cells(grid)
        return mp

    def edge_array(self):
        edges = np.concatenate([p.edge_array()[0] for p in self.polygons],
                               axis=0)
        return edges, np.ones(len(edges), dtype=bool)


@dataclass
class MultiLineString(_EdgeGeom):
    """Multiple linestrings under one object id."""

    lines: List[LineString] = field(default_factory=list)

    @classmethod
    def create(cls, list_of_coords, grid=None, obj_id="",
               timestamp=0) -> "MultiLineString":
        lines = [LineString.create(c, None, obj_id, timestamp)
                 for c in list_of_coords]
        ml = cls(obj_id=obj_id, timestamp=timestamp, lines=lines)
        boxes = np.asarray([ln.bbox for ln in lines])
        ml.bbox = (boxes[:, 0].min(), boxes[:, 1].min(),
                   boxes[:, 2].max(), boxes[:, 3].max())
        ml._assign_cells(grid)
        return ml

    def edge_array(self):
        edges = np.concatenate([ln.edge_array()[0] for ln in self.lines],
                               axis=0)
        return edges, np.ones(len(edges), dtype=bool)


@dataclass
class GeometryCollection(SpatialObject):
    """Heterogeneous component list under one object id."""

    geometries: List[SpatialObject] = field(default_factory=list)

    @classmethod
    def create(cls, geometries, obj_id="",
               timestamp=0) -> "GeometryCollection":
        return cls(obj_id=obj_id, timestamp=timestamp,
                   geometries=list(geometries))
