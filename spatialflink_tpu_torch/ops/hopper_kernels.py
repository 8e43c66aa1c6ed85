"""K4: fused point-in-polygon + min boundary distance to ONE query geometry
(port of ``spatialflink_tpu.ops.pallas_kernels.pip_dist``).

- :func:`pip_dist` is the wrapper. CUDA tensors go through the
  hand-written kernel ``csrc/pip_dist.cu`` (or the call raises); CPU tensors
  go through :func:`pip_dist_plain`. There is no other path.
- :func:`pip_dist_plain` is the plain PyTorch version:
  ``ops.geom.points_to_single_edges_raw`` (the JAX package's jnp twin of
  its Pallas kernel) plus the final select, in point blocks so that the
  (points x edges) intermediates stay bounded at any edge count.

The kernel replaces the Pallas TPU kernel ``_pip_kernel`` / ``_pip_pallas``
(``spatialflink_tpu/ops/pallas_kernels.py:100-209``). On an H100 it is
bound by arithmetic (about 26 f32 operations per point-edge pair against
12 bytes per point); its design (disjoint point ranges per block, edge
chunks staged in shared memory with the per-edge divides done once per
edge, int crossing counts) is described in the source.
"""

from __future__ import annotations

import ctypes

import torch

from spatialflink_tpu_torch.ops import geom as G
from spatialflink_tpu_torch.ops import native

#: edges staged in shared memory per pass of the kernel's edge loop
EDGE_CHUNK = 512
#: f32 operations per (point, valid edge) pair in the kernel's inner loop:
#: ray cast (2 compares, xor, sub, mul, add, compare, and, add = 9) +
#: projection (sub, 2 mul, add, mul, max, min = 7) + distance (2 mul,
#: 2 add, 2 sub, 2 mul, add, min = 10)
OPS_PER_PAIR = 26
#: points per block of the plain version: (block x edges) intermediates
#: stay at ~2**24 elements
_PLAIN_ELEMS = 1 << 24

_C = ctypes.c_void_p
_ARGTYPES = (_C, _C, ctypes.c_int, _C, _C, ctypes.c_int, ctypes.c_int, _C,
             _C)


def _ceil_to(n: int, m: int) -> int:
    return max(((n + m - 1) // m) * m, m)


def bucket_edges(ne: int) -> int:
    """Edge-count bucket (as ``pallas_kernels.pip_dist``): multiples of 64
    up to one chunk, whole chunks beyond."""
    return _ceil_to(ne, 64) if ne <= EDGE_CHUNK else _ceil_to(ne, EDGE_CHUNK)


def pip_dist_plain(px, py, edges, edge_mask, is_areal: bool):
    """(N,) distance from each point to ONE geometry: 0 inside an areal
    geometry, else sqrt(min squared boundary distance); an empty edge set
    gives sqrt(3.4e38) ~ 1.8e19."""
    n = px.shape[0]
    step = max(1, _PLAIN_ELEMS // max(1, edges.shape[0]))
    parts = []
    for lo in range(0, n, step):
        inside, mind2 = G.points_to_single_edges_raw(
            px[lo:lo + step], py[lo:lo + step], edges, edge_mask)
        parts.append(torch.where(inside & bool(is_areal), 0.0,
                                 torch.sqrt(mind2)))
    if not parts:
        return torch.empty_like(px)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _check_cuda_args(px, py, edges, edge_mask) -> None:
    dev = px.device
    for name, t, dtype in (("px", px, torch.float32), ("py", py, torch.float32),
                           ("edges", edges, torch.float32),
                           ("edge_mask", edge_mask, torch.bool)):
        if t.device != dev:
            raise ValueError(f"pip_dist: {name} on {t.device}, px on {dev}")
        if t.dtype != dtype:
            raise TypeError(f"pip_dist: {name} is {t.dtype}, needs {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"pip_dist: {name} is not contiguous")
    if px.dim() != 1 or py.shape != px.shape:
        raise ValueError(f"pip_dist: px {tuple(px.shape)} / py "
                         f"{tuple(py.shape)} must be equal 1-D shapes")
    if edges.dim() != 2 or edges.shape[1] != 4 \
            or edge_mask.shape != edges.shape[:1]:
        raise ValueError(f"pip_dist: edges {tuple(edges.shape)} must be "
                         f"(E, 4) with edge_mask (E,), got "
                         f"{tuple(edge_mask.shape)}")


def pip_dist(px, py, edges, edge_mask, is_areal: bool):
    """(N,) JTS-style distance from each point to ONE query geometry (0
    inside areal geometries, else min boundary distance). CPU tensors run
    :func:`pip_dist_plain`; CUDA tensors launch the K4 kernel."""
    if px.device.type == "cpu":
        return pip_dist_plain(px, py, edges, edge_mask, is_areal)
    _check_cuda_args(px, py, edges, edge_mask)
    ne = edges.shape[0]
    ep = bucket_edges(ne)
    if ep != ne:  # padded edges are masked out in the kernel
        edges = torch.cat([edges, edges.new_zeros((ep - ne, 4))])
        edge_mask = torch.cat([edge_mask, edge_mask.new_zeros(ep - ne)])
    dist = torch.empty_like(px)
    launch = native.function("pip_dist", "pip_dist_launch", _ARGTYPES)
    with torch.cuda.device(px.device):
        err = launch(px.data_ptr(), py.data_ptr(), px.shape[0],
                     edges.data_ptr(), edge_mask.data_ptr(), ep,
                     int(bool(is_areal)), dist.data_ptr(),
                     torch.cuda.current_stream(px.device).cuda_stream)
    native.check(err, "pip_dist")
    pip_dist.launches += 1
    return dist


pip_dist.launches = 0
