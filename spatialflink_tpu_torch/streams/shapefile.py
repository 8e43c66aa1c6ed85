"""ESRI shapefile batch input (port of ``spatialflink_tpu.streams.
shapefile``; reference: ``spatialStreams/ShapeFileInputFormat.java:20-253``).

Reads the ``.shp`` main file: 100-byte header (big-endian file code 9994,
file length in 16-bit words at offset 24), then records of (big-endian
record header, little-endian shape payload). Supported shape types match the
reference: Point (1) → :class:`Point`, PolyLine (3) → :class:`MultiLineString`,
Polygon (5) → :class:`Polygon`; other types are skipped with a warning, null
shapes (0) silently.

Differences from the reference, on purpose:

- coordinate payloads are decoded in bulk with ``np.frombuffer`` instead of
  per-8-byte copies;
- polygon rings are split by the record's Parts index array (the spec's
  mechanism) rather than the reference's first-point-repeat heuristic
  (``ShapeFileInputFormat.java:185-189``) — identical output for well-formed
  files, robust to rings that share a start vertex;
- no thread-gating semaphore: the reader is a plain single-pass iterator.
"""

from __future__ import annotations

import struct
import sys
from typing import Iterator, List, Optional

import numpy as np

from spatialflink_tpu_torch.index import UniformGrid
from spatialflink_tpu_torch.models import (MultiLineString, Point, Polygon,
                                            SpatialObject)

FILE_CODE = 9994
SHAPE_NULL = 0
SHAPE_POINT = 1
SHAPE_POLYLINE = 3
SHAPE_POLYGON = 5

_HEADER_BYTES = 100


class ShapefileError(IOError):
    pass


def _parts_and_points(payload: bytes) -> tuple:
    """-> (list of (n_i, 2) float64 coord arrays, one per part)."""
    num_parts, num_points = struct.unpack_from("<ii", payload, 0x24)
    parts = np.frombuffer(payload, "<i4", count=num_parts, offset=0x2C)
    coords = np.frombuffer(
        payload, "<f8", count=num_points * 2, offset=0x2C + 4 * num_parts
    ).reshape(num_points, 2)
    bounds = list(parts) + [num_points]
    return [coords[bounds[i]:bounds[i + 1]] for i in range(num_parts)]


def iter_shapefile(path: str, grid: Optional[UniformGrid] = None,
                   ) -> Iterator[SpatialObject]:
    """Stream spatial objects from a ``.shp`` file."""
    with open(path, "rb") as f:
        header = f.read(_HEADER_BYTES)
        if len(header) < _HEADER_BYTES:
            raise ShapefileError(f"{path}: truncated header")
        (code,) = struct.unpack_from(">i", header, 0)
        if code != FILE_CODE:
            raise ShapefileError(
                f"{path}: not a shapefile (file code {code} != {FILE_CODE})")
        (file_words,) = struct.unpack_from(">i", header, 24)
        file_size = file_words * 2

        offset = _HEADER_BYTES
        while offset < file_size:
            rec_header = f.read(8)
            if len(rec_header) < 8:
                break
            rec_no, rec_words = struct.unpack(">ii", rec_header)
            payload = f.read(rec_words * 2)
            if len(payload) < rec_words * 2:
                raise ShapefileError(
                    f"{path}: truncated record {rec_no}")
            offset += 8 + len(payload)

            (shape_type,) = struct.unpack_from("<i", payload, 0)
            shape_type &= 0xFF
            if shape_type == SHAPE_POINT:
                x, y = struct.unpack_from("<dd", payload, 0x04)
                yield Point.create(x, y, grid, obj_id=str(rec_no))
            elif shape_type == SHAPE_POLYGON:
                rings = [r.tolist() for r in _parts_and_points(payload)
                         if len(r) >= 3]
                if rings:
                    yield Polygon.create(rings, grid, obj_id=str(rec_no))
            elif shape_type == SHAPE_POLYLINE:
                paths = [p.tolist() for p in _parts_and_points(payload)
                         if len(p) >= 2]
                if paths:
                    yield MultiLineString.create(paths, grid,
                                                 obj_id=str(rec_no))
            elif shape_type != SHAPE_NULL:
                print(f"Unsupported shape type [{shape_type}]",
                      file=sys.stderr)


def read_shapefile(path: str, grid: Optional[UniformGrid] = None
                   ) -> List[SpatialObject]:
    """Eager batch read (the reference's FileInputFormat role)."""
    return list(iter_shapefile(path, grid))
