"""Padded window batches of tensors on one device (port of
``spatialflink_tpu.models.batches``).

Conventions, the same as the JAX package's:
- coordinates: float32 (degree space)
- object ids: int32 (interned from strings by the host, ``IdInterner``)
- timestamps: int32 milliseconds relative to the batch's ``ts_base``, an
  epoch-millis int64 kept on the host
- cell ids: int32 ``cx * n + cy``; -1 marks out-of-grid and padding
- ``valid``: bool; padded slots are False and every kernel masks them
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from spatialflink_tpu_torch.index import UniformGrid
from spatialflink_tpu_torch.models.objects import (MultiPolygon, Polygon,
                                                    _EdgeGeom)
from spatialflink_tpu_torch.utils import IdInterner, bucket_size, pad_to

#: dtype of each PointBatch field
POINT_DTYPES = {"x": np.float32, "y": np.float32, "obj_id": np.int32,
                "ts": np.int32, "cell": np.int32, "valid": np.bool_}


def to_device(arr, np_dtype, device: torch.device) -> torch.Tensor:
    """A host array as a tensor of ``np_dtype`` on ``device``: converted
    explicitly (``torch.from_numpy`` of a float64 array would stay float64),
    and for a CUDA device staged through pinned memory so that the copy is
    asynchronous."""
    t = torch.from_numpy(np.ascontiguousarray(arr, dtype=np_dtype))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class PointBatch(NamedTuple):
    """A batch of N points (N padded to a bucket size), all on one device."""

    x: torch.Tensor        # (N,) f32
    y: torch.Tensor        # (N,) f32
    obj_id: torch.Tensor   # (N,) i32
    ts: torch.Tensor       # (N,) i32, millis offset from ts_base
    cell: torch.Tensor     # (N,) i32, -1 = outside grid / padding
    valid: torch.Tensor    # (N,) bool

    @property
    def capacity(self) -> int:
        return self.x.shape[-1]

    @staticmethod
    def from_arrays(x, y, *, device: torch.device,
                    grid: Optional[UniformGrid] = None, obj_id=None, ts=None,
                    ts_base: int = 0, cell=None) -> "PointBatch":
        """Build from host float64 arrays: assign cells (unless ``cell``
        carries them), pad to a power-of-two bucket, and move to
        ``device``."""
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        n = x.shape[0]
        obj_id = (np.zeros(n, np.int32) if obj_id is None
                  else np.asarray(obj_id, np.int32))
        if ts is None:
            ts32 = np.zeros(n, np.int32)
        else:
            ts32 = (np.asarray(ts, np.int64) - int(ts_base)).astype(np.int32)
        if cell is not None:
            cell = np.asarray(cell, np.int32)
        elif grid is not None:
            cell, _ = grid.assign_cell(x, y)
        else:
            cell = np.full(n, -1, np.int32)
        size = bucket_size(n)
        host = {
            "x": pad_to(x.astype(np.float32), size),
            "y": pad_to(y.astype(np.float32), size),
            "obj_id": pad_to(obj_id, size),
            "ts": pad_to(ts32, size),
            "cell": pad_to(cell, size, fill=-1),
            "valid": pad_to(np.ones(n, bool), size),
        }
        return PointBatch(**{k: to_device(v, POINT_DTYPES[k], device)
                             for k, v in host.items()})


#: dtype of each EdgeGeomBatch field
GEOM_DTYPES = {"edges": np.float32, "edge_mask": np.bool_,
               "bbox": np.float32, "obj_id": np.int32, "ts": np.int32,
               "cell": np.int32, "cells": np.int32, "cells_mask": np.bool_,
               "is_areal": np.bool_, "valid": np.bool_}


class EdgeGeomBatch(NamedTuple):
    """G polygon/linestring geometries as padded edge arrays on one device:
    a window of a polygon/linestring stream, or the query side of the
    multi-query paths. ``is_areal`` is per geometry: polygons count
    containment (distance 0 inside), linestrings do not."""

    edges: torch.Tensor       # (G, E, 4) f32 [x1, y1, x2, y2] per edge
    edge_mask: torch.Tensor   # (G, E) bool
    bbox: torch.Tensor        # (G, 4) f32 [minx, miny, maxx, maxy]
    obj_id: torch.Tensor      # (G,) i32
    ts: torch.Tensor          # (G,) i32
    cell: torch.Tensor        # (G,) i32 representative cell
    cells: torch.Tensor       # (G, C) i32 overlapped cells, -1 padded
    cells_mask: torch.Tensor  # (G, C) bool
    is_areal: torch.Tensor    # (G,) bool
    valid: torch.Tensor       # (G,) bool

    @property
    def capacity(self) -> int:
        return self.edges.shape[-3]

    @staticmethod
    def from_objects(geoms: Sequence[_EdgeGeom], *, device: torch.device,
                     interner: Optional[IdInterner] = None, ts_base: int = 0,
                     pad: Optional[int] = None,
                     edge_pad: Optional[int] = None,
                     cell_pad: Optional[int] = None,
                     obj_id=None) -> "EdgeGeomBatch":
        """Pad edges to ``bucket_size(max edges, 8)`` per geometry, cells to
        ``bucket_size(max cells, 8)`` and the geometry axis to
        ``bucket_size(G, 8)`` (or the given pads), as the JAX package does,
        and move to ``device``. Object ids are interned in order through
        ``interner`` unless ``obj_id`` (G,) gives them."""
        interner = interner if interner is not None else IdInterner()
        g = len(geoms)
        edge_arrays = [geo.edge_array() for geo in geoms]
        max_e = max((e.shape[0] for e, _ in edge_arrays), default=1)
        E = bucket_size(max_e, 8) if edge_pad is None else edge_pad
        max_c = max((len(geo.cells) for geo in geoms), default=1) or 1
        C = bucket_size(max_c, 8) if cell_pad is None else cell_pad
        edges = np.zeros((g, E, 4), np.float32)
        emask = np.zeros((g, E), bool)
        cells = np.full((g, C), -1, np.int32)
        cmask = np.zeros((g, C), bool)
        for i, (e, m) in enumerate(edge_arrays):
            edges[i, :e.shape[0]] = e.astype(np.float32)
            emask[i, :e.shape[0]] = m
            cs = sorted(geoms[i].cells)[:C]
            cells[i, :len(cs)] = cs
            cmask[i, :len(cs)] = True
        ts = np.array([geo.timestamp for geo in geoms], np.int64) - int(ts_base)
        size = bucket_size(g, 8) if pad is None else pad
        host = {
            "edges": pad_to(edges, size),
            "edge_mask": pad_to(emask, size),
            "bbox": pad_to(np.asarray([geo.bbox for geo in geoms],
                                      np.float32).reshape(g, 4), size),
            "obj_id": pad_to(np.array([interner.intern(geo.obj_id)
                                       for geo in geoms], np.int32)
                             if obj_id is None
                             else np.asarray(obj_id, np.int32), size),
            "ts": pad_to(ts.astype(np.int32), size),
            "cell": pad_to(np.array([geo.cell for geo in geoms], np.int32),
                           size, fill=-1),
            "cells": pad_to(cells, size, fill=-1),
            "cells_mask": pad_to(cmask, size),
            "is_areal": pad_to(np.array(
                [isinstance(geo, (Polygon, MultiPolygon)) for geo in geoms],
                bool), size),
            "valid": pad_to(np.ones(g, bool), size),
        }
        return EdgeGeomBatch(**{k: to_device(v, GEOM_DTYPES[k], device)
                                for k, v in host.items()})


def single_query_edges(geom: _EdgeGeom, edge_pad: Optional[int] = None
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Padded (E,4) f32 / (E,) bool host edge arrays for one query
    geometry."""
    e, m = geom.edge_array()
    E = bucket_size(e.shape[0], 8) if edge_pad is None else edge_pad
    return pad_to(e.astype(np.float32), E), pad_to(m, E)


#: dtype of each query-side array ``from_jax_arrays`` accepts
QUERY_DTYPES = {"edges": np.float32, "edge_mask": np.bool_,
                "gn_mask": np.bool_, "cn_mask": np.bool_}


def _geom_batch_from(geoms, dev) -> "EdgeGeomBatch":
    geoms = geoms._asdict() if hasattr(geoms, "_asdict") else geoms
    missing = set(GEOM_DTYPES) - set(geoms)
    if missing:
        raise ValueError(f"EdgeGeomBatch fields missing: {sorted(missing)}")
    return EdgeGeomBatch(**{
        k: to_device(np.asarray(geoms[k]), GEOM_DTYPES[k], dev)
        for k in EdgeGeomBatch._fields})


def from_jax_arrays(batch, device, **query) -> Tuple[object, dict]:
    """State carry from the JAX package: ``batch`` holds the fields of a
    ``spatialflink_tpu`` PointBatch (x, y, obj_id, ts, cell, valid) or of a
    stream-side ``spatialflink_tpu`` EdgeGeomBatch (a polygon/linestring
    window: edges, edge_mask, bbox, obj_id, ts, cell, cells, cells_mask,
    is_areal, valid), as a mapping of host arrays or the NamedTuple itself;
    ``query`` any of its query arrays (edges, edge_mask, gn_mask, cn_mask)
    and, under ``geoms``, the fields of a query-side EdgeGeomBatch. Returns
    the port's PointBatch or EdgeGeomBatch and a dict of query tensors (an
    :class:`EdgeGeomBatch` under ``geoms``) on ``device``, each in its
    declared dtype whatever dtype the array arrived in."""
    from spatialflink_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    unknown = set(query) - set(QUERY_DTYPES) - {"geoms"}
    if unknown:
        raise ValueError(f"unknown query arrays: {sorted(unknown)}")
    fields = batch._asdict() if hasattr(batch, "_asdict") else batch
    if "edges" in fields:
        out = _geom_batch_from(fields, dev)
    else:
        missing = set(POINT_DTYPES) - set(fields)
        if missing:
            raise ValueError(f"PointBatch fields missing: {sorted(missing)}")
        out = PointBatch(**{k: to_device(np.asarray(fields[k]),
                                         POINT_DTYPES[k], dev)
                            for k in PointBatch._fields})
    q = {k: to_device(np.asarray(v), QUERY_DTYPES[k], dev)
         for k, v in query.items() if k != "geoms"}
    if "geoms" in query:
        q["geoms"] = _geom_batch_from(query["geoms"], dev)
    return out, q
