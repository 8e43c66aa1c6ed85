"""K2: windowed kNN with object-id dedup (port of ``spatialflink_tpu.ops.knn``:
``knn_point_stats``, ``knn_point_multi_stats``, ``knn_eligible_stats``,
``point_stream_eligibility`` and the selection of ``topk_by_distance`` /
``topk_by_distance_multi``).

Windowed kNN semantics (``ops/knn.py:1-19`` of the JAX package): the radius
selects candidate cells only — the distance is not radius-filtered; each
object keeps its *minimum* distance; the result is the k smallest minima
ordered by (distance, interned object id) ascending, in always-k slots with
empty ones holding (``_OID_SENTINEL``, ``_BIG``, valid=False);
``dist_evals`` counts the cell-eligible slots.

Every entry point is a wrapper of ONE hand-written CUDA kernel,
``csrc/knn_topk.cu`` (:func:`knn_topk`, with a mode argument and a query
axis): CUDA tensors launch it (or the call raises), CPU tensors run
:func:`knn_topk_plain`. There is no other path, and the CUDA path calls no
library sort, top-k or scatter.

The JAX package picks among several exact selection strategies and, in
approximate mode, ``lax.approx_min_k`` (recall < 1). The port has one exact
selection; approximate mode keeps it (recall 1) and only swaps in bbox
distances where the JAX package does.

``num_ids`` is the size of the per-object table: one entry per interned id.
Operators pass the window interner's size (known on the host without a
device sync); when it is None it is read from the ids (a device sync).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from spatialflink_tpu_torch.index.uniform_grid import cheb_layers
from spatialflink_tpu_torch.models.batches import to_device
from spatialflink_tpu_torch.ops import distances as D
from spatialflink_tpu_torch.ops import native

_BIG = 3.4e38  # "infinitely far" sentinel that survives f32 math
_OID_SENTINEL = 2 ** 31 - 1

MODE_POINT = 0     # point query: Chebyshev layers + point-point distance
MODE_CELLS = 1     # (Q, N) distances + (Q, n*n) neighbouring-cell masks
MODE_ELIGIBLE = 2  # (Q, N) distances + (Q, N) eligibility
#: keys sorted per block in the kernel's selection; k <= TILE // 2
TILE = 2048
MAX_K = TILE // 2
#: operations per (point, query) slot of the kernel's fold: point mode
#: (layers: 4 div/rem, 2 sub, 2 abs, max, 2 compares; distance: 2 sub,
#: 2 mul, add, sqrt; fold compare) and the other modes (a gather or a
#: load, compares, the fold compare)
OPS_PER_SLOT = {MODE_POINT: 19, MODE_CELLS: 5, MODE_ELIGIBLE: 3}


class KnnResult(NamedTuple):
    obj_id: torch.Tensor  # (..., k) i32; _OID_SENTINEL in empty slots
    dist: torch.Tensor    # (..., k) f32; _BIG in empty slots
    valid: torch.Tensor   # (..., k) bool


def point_stream_eligibility(cell, valid, nb_mask):
    """Valid, in-grid, and in a neighbouring cell of the query: ``nb_mask``
    (n*n,) gives (N,), a (Q, n*n) stack gives (Q, N)."""
    return valid & (cell >= 0) & nb_mask[..., torch.clamp_min(cell, 0)]


def _num_ids(obj_id) -> int:
    return int(obj_id.max()) + 1 if obj_id.numel() else 0


def topk_by_distance_multi(obj_id, dist, eligible, k: int,
                           num_ids: Optional[int] = None) -> KnnResult:
    """The plain selection over (Q, N) distances sharing one (N,) id
    window: ``scatter_reduce_`` "amin" of the distance bits into a (Q,
    num_ids) id table, a stable sort of the id-ordered rows (equal
    distances keep ascending id order), the first k. Returns (Q, k)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    num_ids = _num_ids(obj_id) if num_ids is None else int(num_ids)
    q, dev = dist.shape[0], dist.device
    width = max(num_ids, 1)
    no_key = 1 << 32  # above every f32 bit pattern of a distance >= +0
    ok = eligible & (obj_id >= 0) & (obj_id < num_ids)
    bits = (dist + 0.0).view(torch.int32).to(torch.int64)  # -0 -> +0
    keys = torch.where(ok, bits, no_key)
    table = torch.full((q, width), no_key, dtype=torch.int64, device=dev)
    ids = obj_id.to(torch.int64).clamp(0, width - 1).expand(q, -1)
    table.scatter_reduce_(1, ids, keys, "amin")
    top, order = torch.sort(table, dim=1, stable=True)
    kk = min(k, width)
    top, order = top[:, :kk], order[:, :kk]
    present = top < no_key
    d = torch.where(present, top, 0).to(torch.int32).view(torch.float32)
    d = torch.where(present, d, _BIG)
    valid = present & (d < _BIG)
    oid = torch.where(valid, order.to(torch.int32), _OID_SENTINEL)
    if kk < k:
        pad = k - kk
        d = torch.cat([d, d.new_full((q, pad), _BIG)], dim=1)
        oid = torch.cat([oid, oid.new_full((q, pad), _OID_SENTINEL)], dim=1)
        valid = torch.cat([valid, valid.new_zeros((q, pad))], dim=1)
    return KnnResult(obj_id=oid, dist=d, valid=valid)


def topk_by_distance(obj_id, dist, eligible, k: int,
                     num_ids: Optional[int] = None) -> KnnResult:
    """:func:`topk_by_distance_multi` for one (N,) row: (k,) fields."""
    res = topk_by_distance_multi(obj_id, dist[None], eligible[None], k,
                                 num_ids)
    return KnnResult(*(t[0] for t in res))


def knn_topk_plain(obj_id, *, mode: int, k: int, num_ids: Optional[int],
                   x=None, y=None, cell=None, valid=None, qx=None, qy=None,
                   q_cell=None, n: int = 1, nb_layers: int = -1, dists=None,
                   nb_mask=None, eligible=None):
    """Plain version of :func:`knn_topk`: the same four outputs."""
    if mode == MODE_POINT:
        layers = cheb_layers(cell[None, :], q_cell[:, None], n)
        elig = valid[None, :] & (layers <= nb_layers)
        d = D.pp_dist(x[None, :], y[None, :], qx[:, None], qy[:, None])
    elif mode == MODE_CELLS:
        elig = point_stream_eligibility(cell, valid, nb_mask)
        d = dists
    elif mode == MODE_ELIGIBLE:
        elig, d = eligible, dists
    else:
        raise ValueError(f"knn_topk: unknown mode {mode}")
    res = topk_by_distance_multi(obj_id, d, elig, k, num_ids)
    return (*res, elig.sum(dim=1, dtype=torch.int32))


_C = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_I, _I, _I, _I, _I, _C, _C, _C, _C, _C, _C, _C, _C, _I, _I, _C,
             _C, _I, _C, _C, _C, _C, _C, _C, _C, _C, _C)


def _require(t, name, dtype, shape, dev):
    if t is None:
        raise ValueError(f"knn_topk: {name} is required in this mode")
    if t.device != dev:
        raise ValueError(f"knn_topk: {name} on {t.device}, obj_id on {dev}")
    if t.dtype != dtype:
        raise TypeError(f"knn_topk: {name} is {t.dtype}, needs {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"knn_topk: {name} shape {tuple(t.shape)}, needs "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"knn_topk: {name} is not contiguous")
    return t.data_ptr()


def knn_topk(obj_id, *, mode: int, k: int, num_ids: Optional[int],
             x=None, y=None, cell=None, valid=None, qx=None, qy=None,
             q_cell=None, n: int = 1, nb_layers: int = -1, dists=None,
             nb_mask=None, eligible=None):
    """Launch the K2 kernel on CUDA tensors: returns ``(obj_id (Q, k)
    int32, dist (Q, k) f32, valid (Q, k) bool, counts (Q,) int32)``.
    Point mode takes x, y, cell, valid (N,) and qx, qy, q_cell (Q,); cell
    mode cell, valid (N,), dists (Q, N) and nb_mask (Q, n*n); eligible mode
    dists and eligible (Q, N)."""
    dev = obj_id.device
    if dev.type != "cuda":
        raise ValueError(f"knn_topk: obj_id on {dev}, needs cuda")
    _check_k(k)
    num_ids = _num_ids(obj_id) if num_ids is None else int(num_ids)
    N = obj_id.shape[0]
    p = {name: None for name in ("x", "y", "cell", "valid", "qx", "qy",
                                 "q_cell", "dists", "nb_mask", "eligible")}
    p["obj_id"] = _require(obj_id, "obj_id", torch.int32, (N,), dev)
    if mode == MODE_POINT:
        Q = qx.shape[0]
        for name, t, dt in (("x", x, torch.float32), ("y", y, torch.float32),
                            ("cell", cell, torch.int32),
                            ("valid", valid, torch.bool)):
            p[name] = _require(t, name, dt, (N,), dev)
        for name, t, dt in (("qx", qx, torch.float32),
                            ("qy", qy, torch.float32),
                            ("q_cell", q_cell, torch.int32)):
            p[name] = _require(t, name, dt, (Q,), dev)
        cells = 0
    elif mode in (MODE_CELLS, MODE_ELIGIBLE):
        Q = dists.shape[0]
        p["dists"] = _require(dists, "dists", torch.float32, (Q, N), dev)
        if mode == MODE_CELLS:
            cells = nb_mask.shape[-1]
            p["cell"] = _require(cell, "cell", torch.int32, (N,), dev)
            p["valid"] = _require(valid, "valid", torch.bool, (N,), dev)
            p["nb_mask"] = _require(nb_mask, "nb_mask", torch.bool,
                                    (Q, cells), dev)
        else:
            cells = 0
            p["eligible"] = _require(eligible, "eligible", torch.bool,
                                     (Q, N), dev)
    else:
        raise ValueError(f"knn_topk: unknown mode {mode}")
    tiles = native.function("knn_topk", "knn_topk_tiles", (_I,))(num_ids)
    best = torch.empty((Q, max(num_ids, 1)), dtype=torch.int32, device=dev)
    scratch = torch.empty((2, Q, tiles * k), dtype=torch.int64, device=dev)
    out_oid = torch.empty((Q, k), dtype=torch.int32, device=dev)
    out_dist = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_valid = torch.empty((Q, k), dtype=torch.bool, device=dev)
    counts = torch.empty(Q, dtype=torch.int32, device=dev)
    launch = native.function("knn_topk", "knn_topk_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = launch(mode, N, Q, num_ids, k, p["obj_id"], p["x"], p["y"],
                     p["cell"], p["valid"], p["qx"], p["qy"], p["q_cell"],
                     int(n), int(nb_layers), p["dists"], p["nb_mask"],
                     cells, p["eligible"], best.data_ptr(),
                     scratch[0].data_ptr(), scratch[1].data_ptr(),
                     out_oid.data_ptr(), out_dist.data_ptr(),
                     out_valid.data_ptr(), counts.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
    native.check(err, "knn_topk")
    knn_topk.launches += 1
    return out_oid, out_dist, out_valid, counts


knn_topk.launches = 0


def _check_k(k: int) -> None:
    if not 1 <= k <= MAX_K:
        raise NotImplementedError(
            f"kNN with k={k}: the kernel's selection supports 1 <= k <= "
            f"{MAX_K} (half of one {TILE}-key tile)")


def _knn(obj_id, **kw):
    """The kernel on CUDA tensors, its plain version on CPU tensors; both
    refuse a k the kernel does not support."""
    _check_k(kw["k"])
    if obj_id.device.type == "cpu":
        return knn_topk_plain(obj_id, **kw)
    return knn_topk(obj_id, **kw)


def _query_array(v, np_dtype, device) -> torch.Tensor:
    """A (Q,) query array on ``device``: a tensor passes through, host
    scalars and arrays are copied (asynchronously to a card)."""
    if isinstance(v, torch.Tensor):
        return v.reshape(-1)
    return to_device(np.atleast_1d(np.asarray(v, np_dtype)), np_dtype, device)


def knn_point_multi_stats(points, qx, qy, q_cell, nb_layers, *, n: int,
                          k: int, num_ids: Optional[int] = None):
    """kNN of Q query points over one window batch in one launch: ``(
    KnnResult with (Q, k) fields, dist_evals (Q,))``. ``nb_layers`` is the
    candidate layer count; pass ``n`` (the grid size) for radius 0 (every
    cell is a neighbour)."""
    dev = points.x.device
    out = _knn(points.obj_id, mode=MODE_POINT, k=k, num_ids=num_ids,
               x=points.x, y=points.y, cell=points.cell, valid=points.valid,
               qx=_query_array(qx, np.float32, dev),
               qy=_query_array(qy, np.float32, dev),
               q_cell=_query_array(q_cell, np.int32, dev), n=n,
               nb_layers=nb_layers)
    return KnnResult(*out[:3]), out[3]


def knn_point_stats(points, qx, qy, q_cell, nb_layers, *, n: int, k: int,
                    num_ids: Optional[int] = None):
    """kNN of ONE query point: ``(KnnResult with (k,) fields, dist_evals)``
    (the Q = 1 row of :func:`knn_point_multi_stats`)."""
    res, evals = knn_point_multi_stats(points, qx, qy, q_cell, nb_layers,
                                       n=n, k=k, num_ids=num_ids)
    return KnnResult(*(t[0] for t in res)), evals[0]


def knn_masked_stats(points, dists, nb_mask, *, k: int,
                     num_ids: Optional[int] = None):
    """kNN over caller-computed distances with the point-stream eligibility
    (:func:`point_stream_eligibility`) fused into the kernel: ``dists``
    (N,) with ``nb_mask`` (n*n,) gives (k,) fields and a scalar count;
    (Q, N) with (Q, n*n) gives (Q, k) and (Q,)."""
    single = dists.dim() == 1
    out = _knn(points.obj_id, mode=MODE_CELLS, k=k, num_ids=num_ids,
               cell=points.cell, valid=points.valid,
               dists=dists[None] if single else dists,
               nb_mask=nb_mask[None] if single else nb_mask)
    if single:
        return KnnResult(*(t[0] for t in out[:3])), out[3][0]
    return KnnResult(*out[:3]), out[3]


def knn_eligible_stats(obj_id, dists, eligible, *, k: int,
                       num_ids: Optional[int] = None):
    """Dedup + top-k over caller-computed eligibility and distances, plus
    the eligible count: (N,) inputs give (k,) fields and a scalar, (Q, N)
    inputs (Q, k) and (Q,)."""
    single = dists.dim() == 1
    out = _knn(obj_id, mode=MODE_ELIGIBLE, k=k, num_ids=num_ids,
               dists=dists[None] if single else dists,
               eligible=eligible[None] if single else eligible)
    if single:
        return KnnResult(*(t[0] for t in out[:3])), out[3][0]
    return KnnResult(*out[:3]), out[3]
