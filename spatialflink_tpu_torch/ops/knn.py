"""K2: windowed kNN with object-id dedup, and K3: the merge of pane top-k
partials (port of ``spatialflink_tpu.ops.knn``: ``knn_point_stats``,
``knn_point_multi_stats``, ``knn_eligible_stats``,
``point_stream_eligibility``, the selection of ``topk_by_distance`` /
``topk_by_distance_multi``, ``merge_topk_host``, ``_merge_topk_stacked``
/ ``_merge_topk_stacked_multi`` and ``merge_knn_device`` /
``merge_knn_device_multi``, both :func:`knn_merge_parts` here).

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

K3 (``csrc/knn_merge.cu``) merges a window's pane partials into its exact
top-k: the JAX package's full-sort dedup (``_topk_full_sort``) over each
query row's P·k candidates, as a merge of the sorted pane lists. Its
entries are :func:`knn_merge_parts` (the partials where they lie, as the
device pane merge passes them) and :func:`knn_merge` (a (P, Q, k) stack);
its plain version is :func:`merge_topk_stacked_plain`, which the parts
entry runs on CPU tensors.

Both kernels take any k >= 1, as the JAX package does.

The JAX package picks among several exact selection strategies and, in
approximate mode, ``lax.approx_min_k`` (recall < 1). The port has one exact
selection; approximate mode keeps it (recall 1) and only swaps in bbox
distances where the JAX package does.

``num_ids`` is the size of the per-object table: one entry per interned id.
Operators pass the window interner's size (known on the host without a
device sync), or in realtime mode a micro-batch's distinct id count (its
ids compacted, ``operators/knn_query.py``); when it is None it is read from
the ids (a device sync).
"""

from __future__ import annotations

import ctypes
import functools
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


def _launch_args(obj_id, *, mode: int, x=None, y=None, cell=None,
                 valid=None, qx=None, qy=None, q_cell=None, dists=None,
                 nb_mask=None, eligible=None):
    """Check every tensor of a K2 launch (device, dtype, shape, contiguity)
    and return ``(N, Q, num_cells, pointers by name)``, None for the
    tensors the mode does not read."""
    dev = obj_id.device
    N = obj_id.shape[0]
    p = {name: None for name in ("x", "y", "cell", "valid", "qx", "qy",
                                 "q_cell", "dists", "nb_mask", "eligible")}
    p["obj_id"] = _require(obj_id, "obj_id", torch.int32, (N,), dev)
    cells = 0
    if mode == MODE_POINT:
        if qx is None:
            raise ValueError("knn_topk: qx is required in this mode")
        Q = qx.shape[0]
        for name, t, dt in (("x", x, torch.float32), ("y", y, torch.float32),
                            ("cell", cell, torch.int32),
                            ("valid", valid, torch.bool)):
            p[name] = _require(t, name, dt, (N,), dev)
        for name, t, dt in (("qx", qx, torch.float32),
                            ("qy", qy, torch.float32),
                            ("q_cell", q_cell, torch.int32)):
            p[name] = _require(t, name, dt, (Q,), dev)
    elif mode in (MODE_CELLS, MODE_ELIGIBLE):
        if dists is None:
            raise ValueError("knn_topk: dists is required in this mode")
        Q = dists.shape[0]
        p["dists"] = _require(dists, "dists", torch.float32, (Q, N), dev)
        if mode == MODE_CELLS:
            if nb_mask is None:
                raise ValueError("knn_topk: nb_mask is required in this mode")
            cells = nb_mask.shape[-1]
            p["cell"] = _require(cell, "cell", torch.int32, (N,), dev)
            p["valid"] = _require(valid, "valid", torch.bool, (N,), dev)
            p["nb_mask"] = _require(nb_mask, "nb_mask", torch.bool,
                                    (Q, cells), dev)
        else:
            p["eligible"] = _require(eligible, "eligible", torch.bool,
                                     (Q, N), dev)
    else:
        raise ValueError(f"knn_topk: unknown mode {mode}")
    if Q < 1:
        raise ValueError("knn_topk: needs at least one query")
    return N, Q, cells, p


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
    N, Q, cells, p = _launch_args(
        obj_id, mode=mode, x=x, y=y, cell=cell, valid=valid, qx=qx, qy=qy,
        q_cell=q_cell, dists=dists, nb_mask=nb_mask, eligible=eligible)
    zone_ints = native.function("knn_topk", "knn_topk_zone_ints", (_I, _I),
                                ctypes.c_longlong)(Q, num_ids)
    best = torch.empty((max(num_ids, 1), Q), dtype=torch.int32, device=dev)
    zone = torch.empty(zone_ints, dtype=torch.int32, device=dev)
    cand = torch.empty(native.function(
        "knn_topk", "knn_topk_cand_keys", (_I, _I), ctypes.c_longlong)(Q, k),
        dtype=torch.int64, device=dev)
    over = torch.empty((Q, max(num_ids, 1)), dtype=torch.int64, device=dev)
    out_oid = torch.empty((Q, k), dtype=torch.int32, device=dev)
    out_dist = torch.empty((Q, k), dtype=torch.float32, device=dev)
    out_valid = torch.empty((Q, k), dtype=torch.bool, device=dev)
    launch = native.function("knn_topk", "knn_topk_launch", _ARGTYPES)
    with torch.cuda.device(dev):
        err = launch(mode, N, Q, num_ids, k, p["obj_id"], p["x"], p["y"],
                     p["cell"], p["valid"], p["qx"], p["qy"], p["q_cell"],
                     int(n), int(nb_layers), p["dists"], p["nb_mask"],
                     cells, p["eligible"], best.data_ptr(), zone.data_ptr(),
                     cand.data_ptr(), over.data_ptr(), out_oid.data_ptr(),
                     out_dist.data_ptr(), out_valid.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
    native.check(err, "knn_topk")
    knn_topk.launches += 1
    return out_oid, out_dist, out_valid, zone[:Q]


knn_topk.launches = 0


def _check_k(k: int) -> None:
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")


def _knn(obj_id, **kw):
    """The kernel on CUDA tensors, its plain version on CPU tensors."""
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


# ------------------------------------------------------------------------ #
# K3: the pane top-k merge

def merge_topk_host(parts, k: int, tie_key=None):
    """Host merge of per-pane top-k lists of ``(obj_id, dist)``: the
    minimum distance per object, then the k smallest by (distance,
    ``tie_key(obj_id)``). Exact by the covering argument of the JAX
    package's ``merge_topk_host``; ``tie_key`` must reproduce the kernels'
    tie order, so operators pass their interner's ``intern`` (ascending
    interned id)."""
    best: dict = {}
    for part in parts:
        for oid, d in part:
            cur = best.get(oid)
            if cur is None or d < cur:
                best[oid] = d
    tie_key = tie_key if tie_key is not None else str
    out = sorted(best.items(), key=lambda kv: (kv[1], tie_key(kv[0])))[:k]
    return [(oid, d) for oid, d in out]


def _float_order_key(d: torch.Tensor) -> torch.Tensor:
    """int64 keys in the total order of f32 values (negatives reversed
    below the positives, -0 just below +0), as the kernel orders them."""
    bits = d.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(bits >= 0x80000000, 0xFFFFFFFF - bits,
                       bits + 0x80000000)


def merge_topk_stacked_plain(obj_id, dist, valid, k: int) -> KnnResult:
    """Plain version of :func:`knn_merge`: stacked partials (P, w) give the
    (k,) merged top-k, (P, Q, w) give (Q, k), each query row over its P·w
    candidates in pane-major order. Ineligible slots become
    (``_OID_SENTINEL``, ``_BIG``); a sort on (id, distance) keeps the first
    slot of each id (its minimum); the kept slots' k smallest distances
    follow, equal distances in ascending id (``_topk_full_sort``); slots
    past the kept ones are (``_OID_SENTINEL``, ``_BIG``, False)."""
    if k < 1:
        raise ValueError(f"k must be >= 1, got {k}")
    single = obj_id.dim() == 2
    if single:
        obj_id, dist, valid = obj_id[:, None], dist[:, None], valid[:, None]
    p, q, w = obj_id.shape
    m = p * w
    oid = obj_id.permute(1, 0, 2).reshape(q, m).to(torch.int64)
    d = dist.permute(1, 0, 2).reshape(q, m)
    v = valid.permute(1, 0, 2).reshape(q, m)
    oid = torch.where(v, oid, _OID_SENTINEL)
    d = torch.where(v, d, torch.full_like(d, _BIG))
    # lexicographic (id, distance): stable sorts, secondary key first
    o1 = torch.sort(_float_order_key(d), dim=1, stable=True).indices
    o2 = torch.sort(oid.gather(1, o1), dim=1, stable=True).indices
    order = o1.gather(1, o2)
    oid_s, d_s = oid.gather(1, order), d.gather(1, order)
    prev = torch.cat([oid_s.new_full((q, 1), _OID_SENTINEL),
                      oid_s[:, :-1]], dim=1)
    keep = (oid_s != prev) & (oid_s != _OID_SENTINEL)
    d_masked = torch.where(keep, d_s, torch.full_like(d_s, _BIG))
    kk = min(k, m)
    top = torch.sort(_float_order_key(d_masked), dim=1,
                     stable=True).indices[:, :kk]
    top_d = d_masked.gather(1, top)
    ok = top_d < _BIG
    top_oid = torch.where(ok, oid_s.gather(1, top),
                          _OID_SENTINEL).to(torch.int32)
    top_d = torch.where(ok, top_d, torch.full_like(top_d, _BIG))
    if kk < k:
        pad = k - kk
        top_d = torch.cat([top_d, top_d.new_full((q, pad), _BIG)], dim=1)
        top_oid = torch.cat([top_oid, top_oid.new_full((q, pad),
                                                       _OID_SENTINEL)], 1)
        ok = torch.cat([ok, ok.new_zeros((q, pad))], dim=1)
    res = KnnResult(obj_id=top_oid, dist=top_d, valid=ok)
    return KnnResult(*(t[0] for t in res)) if single else res


_MERGE_ARGTYPES = (_I, _I, _I, _C, _C, _C, _C, _C, _C)


@functools.lru_cache(maxsize=None)
def _merge_launch_fn():
    return native.function("knn_merge", "knn_merge_launch", _MERGE_ARGTYPES)


@functools.lru_cache(maxsize=1024)
def _merge_scratch_bytes(p: int, q: int, k: int) -> int:
    """The kernel's scratch for a shape (its pointer table and the work
    of rows wider than one block; 0 when it needs neither)."""
    return native.function("knn_merge", "knn_merge_scratch_bytes",
                           (_I, _I, _I), ctypes.c_longlong)(p, q, k)


def _merge_outputs(q: int, k: int, dev, single: bool) -> KnnResult:
    """The merge's outputs: one allocation of q*k*9 bytes viewed as the
    three fields, (k,) each when ``single`` (q = 1), else (q, k)."""
    n = q * k
    buf = torch.empty(9 * n, dtype=torch.uint8, device=dev)
    out = KnnResult(buf[:4 * n].view(torch.int32),
                    buf[4 * n:8 * n].view(torch.float32),
                    buf[8 * n:].view(torch.bool))
    return out if single else KnnResult(*(t.view(q, k) for t in out))


def _merge_launch(ptrs, p: int, q: int, k: int, dev, single: bool):
    """One K3 launch over ``p`` panes of ``q`` rows: ``ptrs`` lists every
    pane's obj_id pointer, then dist, then valid. Scratch is allocated
    only when the kernel asks for it."""
    out = _merge_outputs(q, k, dev, single)
    nbytes = _merge_scratch_bytes(p, q, k)
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
               if nbytes else None)
    with torch.cuda.device(dev):
        err = _merge_launch_fn()(
            p, q, k, (ctypes.c_longlong * len(ptrs))(*ptrs),
            None if scratch is None else scratch.data_ptr(),
            out.obj_id.data_ptr(), out.dist.data_ptr(), out.valid.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    native.check(err, "knn_merge")
    knn_merge.launches += 1
    return out


def knn_merge(obj_id, dist, valid, k: int) -> KnnResult:
    """Launch the K3 kernel on CUDA tensors: stacked partials ``obj_id``
    (P, Q, k) int32, ``dist`` f32 and ``valid`` bool, all contiguous, give
    the (Q, k) merged :class:`KnnResult` (:func:`merge_topk_stacked_plain`
    bit for bit): the kernel of :func:`knn_merge_parts` over the P panes of
    the stack."""
    dev = obj_id.device
    if dev.type != "cuda":
        raise ValueError(f"knn_merge: obj_id on {dev}, needs cuda")
    _check_k(k)
    if obj_id.dim() != 3 or obj_id.shape[2] != k:
        raise ValueError(f"knn_merge: obj_id shape {tuple(obj_id.shape)}, "
                         f"needs (P, Q, {k})")
    p, q, _ = obj_id.shape
    if p < 1 or q < 1:
        raise ValueError("knn_merge: needs at least one pane and one query")
    shape = tuple(obj_id.shape)
    ptrs = []
    for t, name, dt in ((obj_id, "obj_id", torch.int32),
                        (dist, "dist", torch.float32),
                        (valid, "valid", torch.bool)):
        base, step = _require(t, name, dt, shape, dev), q * k * t.element_size()
        ptrs += [base + i * step for i in range(p)]
    return _merge_launch(ptrs, p, q, k, dev, single=False)


knn_merge.launches = 0


def _part_ptrs(results, k: int):
    """Check the partials of :func:`knn_merge_parts` (one device, dtypes,
    one shape (k,) or (Q, k), contiguous) and return (pointers, Q,
    device)."""
    first = results[0].obj_id
    dev, shape = first.device, first.shape
    if shape[-1:] != (k,) or len(shape) > 2:
        raise ValueError(f"knn_merge_parts: partial shape {tuple(shape)}, "
                         f"needs ({k},) or (Q, {k})")
    ptrs = ([], [], [])
    for r in results:
        for t, dt, acc in zip(r, (torch.int32, torch.float32, torch.bool),
                              ptrs):
            if (t.dtype is not dt or t.shape != shape or t.device != dev
                    or not t.is_contiguous()):
                raise ValueError(
                    f"knn_merge_parts: a partial is {t.dtype} {tuple(t.shape)}"
                    f" on {t.device}, needs contiguous {dt} {tuple(shape)} on "
                    f"{dev}")
            acc.append(t.data_ptr())
    return ptrs[0] + ptrs[1] + ptrs[2], (shape[0] if len(shape) == 2 else 1), \
        dev


def merge_topk_parts_plain(results, k: int) -> KnnResult:
    """Plain version of :func:`knn_merge_parts`:
    :func:`merge_topk_stacked_plain` over the partials' stack."""
    return merge_topk_stacked_plain(
        *(torch.stack([getattr(r, f) for r in results])
          for f in KnnResult._fields), k)


def knn_merge_parts(results, k: int) -> KnnResult:
    """K3 over a window's pane partials as they lie (the device pane merge
    of the kNN operators): ``results``, P
    :class:`KnnResult` s with (k,) or (Q, k) fields (int32, f32, bool,
    contiguous, one device), give the merged (k,) or (Q, k) result. On
    CUDA tensors one launch reads each partial through its pointers (no
    stack, no copy); on CPU tensors the plain version runs over their
    stack."""
    _check_k(k)
    if not results:
        raise ValueError("knn_merge_parts: needs at least one partial")
    single = results[0].obj_id.dim() == 1
    if results[0].obj_id.device.type == "cpu":
        return merge_topk_parts_plain(results, k)
    ptrs, q, dev = _part_ptrs(results, k)
    return _merge_launch(ptrs, len(results), q, k, dev, single)

