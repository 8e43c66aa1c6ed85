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

from typing import Mapping, NamedTuple, Optional, Tuple

import numpy as np
import torch

from spatialflink_tpu_torch.index import UniformGrid
from spatialflink_tpu_torch.models.objects import _EdgeGeom
from spatialflink_tpu_torch.utils import bucket_size, pad_to

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


def from_jax_arrays(batch: Mapping[str, np.ndarray], device,
                    **query: np.ndarray
                    ) -> Tuple[PointBatch, dict]:
    """State carry from the JAX package: ``batch`` holds the fields of a
    ``spatialflink_tpu`` PointBatch (x, y, obj_id, ts, cell, valid) as host
    arrays, ``query`` any of its query arrays (edges, edge_mask, gn_mask,
    cn_mask). Returns the port's PointBatch and a dict of
    query tensors on ``device``, each in its declared dtype whatever dtype
    the array arrived in."""
    from spatialflink_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    missing = set(POINT_DTYPES) - set(batch)
    if missing:
        raise ValueError(f"PointBatch fields missing: {sorted(missing)}")
    unknown = set(query) - set(QUERY_DTYPES)
    if unknown:
        raise ValueError(f"unknown query arrays: {sorted(unknown)}")
    pb = PointBatch(**{k: to_device(np.asarray(batch[k]), POINT_DTYPES[k],
                                    dev)
                       for k in PointBatch._fields})
    q = {k: to_device(np.asarray(v), QUERY_DTYPES[k], dev)
         for k, v in query.items()}
    return pb, q
