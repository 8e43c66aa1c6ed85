"""K8: the trajectory kernels (port of ``spatialflink_tpu.ops.trajectory``).

- :func:`tstats_update` (K8a) — each trajectory's running spatial length,
  temporal length and speed over a batch, with carried per-object state
  (:class:`TrajStatsState`, updated in place).
- :func:`tstats_window_summary` (K8b) — the same on fresh state, one row
  per object (pair sum, count, ts extent, first and last point): the
  mergeable form the pane path stitches (:func:`tstats_stitch_host`).
- :func:`taggregate_group_extents` (K8c) and :func:`taggregate_groups` —
  a window grouped by (cell, object) with each group's ts extent / length.
- :func:`taggregate_heatmap` (K8d) — per-cell SUM/AVG/MIN/MAX/COUNT of the
  group lengths.

Each is the wrapper of ONE hand-written CUDA entry point
(``csrc/traj.cu``): CUDA tensors launch it (or the call raises), CPU
tensors run its plain version (``*_plain``). There is no other path.
Outputs are in sorted order, with ``order`` mapping back to batch
positions, as in the JAX package. K8a, K8b and K8c sort on a key as wide
as the batch's own fields (:func:`tstats_layout`, :func:`summary_layout`,
:func:`extents_layout`): one launch up to :data:`ONE_BLOCK_MAX` points
(every realtime cut), else a key launch, one launch per 8-bit pass and a
walk. K8d is one launch.

One deliberate difference from the JAX package: the running lengths of
K8a are sums over each trajectory's own run, taken one contribution at a
time in (object, ts) order and added to the carried totals, where the JAX
package takes differences of one f32 cumsum over the whole sorted batch.
The two agree exactly on the carried state, on integer temporal lengths
whose batch total stays below 2**24 ms, and otherwise within the cumsum's
rounding (about 2**-23 of the batch's running total per step). The plain
versions fix the kernels' order of every float sum (a loop over run
positions, each step one f32 add across the runs), so kernel and plain
version agree bit for bit.

``tstats_stitch_host`` and ``taggregate_merge_extents_host`` (the pane
merges) are numpy on the host, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from spatialflink_tpu_torch.ops import distances as D
from spatialflink_tpu_torch.ops import native

INT32_MIN = -(2 ** 31)
INT32_MAX = 2 ** 31 - 1
_OID_SENTINEL = INT32_MAX
#: K8d's aggregate codes
AGGREGATES = {"SUM": 0, "AVG": 1, "MIN": 2, "MAX": 3, "COUNT": 4}
#: the most points K8a, K8b and K8c sort in one block, in one launch:
#: csrc/traj.cu's kOneBlockMax (PERF.md has the measurement that set it)
ONE_BLOCK_MAX = 4096


class TrajStatsState(NamedTuple):
    """Per-object carried state, sized (M,) for M interned object ids."""

    last_x: torch.Tensor    # f32
    last_y: torch.Tensor    # f32
    last_ts: torch.Tensor   # i32; INT32_MIN = uninitialised
    spatial: torch.Tensor   # f32 running spatial length (degrees)
    temporal: torch.Tensor  # f32 running temporal length (ms)

    @staticmethod
    def zeros(m: int, device) -> "TrajStatsState":
        dev = torch.device(device)
        return TrajStatsState(
            last_x=torch.zeros(m, dtype=torch.float32, device=dev),
            last_y=torch.zeros(m, dtype=torch.float32, device=dev),
            last_ts=torch.full((m,), INT32_MIN, dtype=torch.int32,
                               device=dev),
            spatial=torch.zeros(m, dtype=torch.float32, device=dev),
            temporal=torch.zeros(m, dtype=torch.float32, device=dev))


class TStatsOut(NamedTuple):
    """Per-input-point emissions, in sorted (objID, ts) order."""

    obj_id: torch.Tensor    # (N,) i32; 2**31 - 1 at padded slots
    spatial: torch.Tensor   # (N,) f32 running spatial length
    temporal: torch.Tensor  # (N,) f32 running temporal length (ms)
    speed: torch.Tensor     # (N,) f32 spatial / temporal
    emit: torch.Tensor      # (N,) bool: in-order, state-initialised points
    order: torch.Tensor     # (N,) i32 batch position


class TStatsWindowSummary(NamedTuple):
    """Per-trajectory (M,) summary of one window slice (a pane): the
    within-slice pair sums plus the boundary data a stitch needs."""

    spatial: torch.Tensor  # (M,) f32 consecutive-pair distance sum
    count: torch.Tensor    # (M,) i32 accepted points
    min_ts: torch.Tensor   # (M,) i32 (INT32_MAX where absent)
    max_ts: torch.Tensor   # (M,) i32 (INT32_MIN where absent)
    first_x: torch.Tensor  # (M,) f32 earliest accepted point (0 if absent)
    first_y: torch.Tensor
    last_x: torch.Tensor   # (M,) f32 latest accepted point (0 if absent)
    last_y: torch.Tensor


class TAggregateExtents(NamedTuple):
    """Per-(cell, objID) group ts extents of a window, in sorted order."""

    cell: torch.Tensor    # (N,) i32 group cell (num_cells at padded slots)
    obj_id: torch.Tensor  # (N,) i32 group object (2**31 - 1 there)
    min_ts: torch.Tensor  # (N,) i32 group min timestamp
    max_ts: torch.Tensor  # (N,) i32 group max timestamp
    first: torch.Tensor   # (N,) bool marks group representatives


class TAggregateGroups(NamedTuple):
    """Per-(cell, objID) groups of a window, in sorted order."""

    cell: torch.Tensor    # (N,) i32 group cell
    obj_id: torch.Tensor  # (N,) i32 group object
    length: torch.Tensor  # (N,) i32 max_ts - min_ts of the group
    first: torch.Tensor   # (N,) bool marks group representatives


class SortLayout(NamedTuple):
    """How K8a, K8b or K8c sorts a batch of ``n`` points: the key's ``bits``
    (a 32-bit word up to 32, else 64), the 8-bit LSD ``passes``, the path
    (``one_block``) and the kernel ``launches`` (1 in one block; else the
    key launch, one per pass and the walk)."""

    bits: int
    passes: int
    one_block: bool
    launches: int


def sort_layout(n: int, bits: int) -> SortLayout:
    """The :class:`SortLayout` of ``n`` points on a ``bits``-bit key (one
    block up to :data:`ONE_BLOCK_MAX` points, read at call time)."""
    if not 1 <= bits <= 64:
        raise ValueError(f"a K8 sort key of {bits} bits")
    passes = -(-bits // 8)
    one = n <= ONE_BLOCK_MAX
    launches = 0 if n == 0 else 1 if one else passes + 2
    return SortLayout(bits, passes, one, launches)


def tstats_layout(n: int, m: int, ts_lo: int, ts_hi: int
                  ) -> Tuple[int, SortLayout]:
    """K8a's key: the object (``m`` for a padded slot) in bit_length(m)
    bits above ts - ts_lo in bit_length(ts_hi - ts_lo) bits, for a batch
    whose every slot's ts lies in [ts_lo, ts_hi]: (ts bits, layout)."""
    if m < 1:
        raise ValueError(f"tstats_update: m must be >= 1, got {m}")
    if not INT32_MIN <= ts_lo <= ts_hi <= INT32_MAX:
        raise ValueError(f"tstats_update: ts range ({ts_lo}, {ts_hi}) is "
                         "not an int32 interval")
    ts_bits = int(ts_hi - ts_lo).bit_length()
    return ts_bits, sort_layout(n, int(m).bit_length() + ts_bits)


def summary_layout(n: int, m: int, ts_lo: int, ts_hi: int
                   ) -> Tuple[int, SortLayout]:
    """K8b's key and layout: K8a's (:func:`tstats_layout`), except that an
    empty batch still takes the one-block launch, which writes every row
    absent."""
    ts_bits, lay = tstats_layout(n, m, ts_lo, ts_hi)
    if n == 0:
        lay = lay._replace(one_block=True, launches=1)
    return ts_bits, lay


def extents_layout(n: int, num_cells: int, oid_bits: int) -> SortLayout:
    """K8c's key: the cell (``num_cells`` for a padded or out-of-grid
    slot) above the object id in ``oid_bits`` bits."""
    return sort_layout(n, int(oid_bits) + int(num_cells).bit_length())


def _oid_bits(num_ids: int) -> int:
    """Bits of K8c's id field for ids in [0, num_ids)."""
    bits = max(1, int(num_ids - 1).bit_length()) if num_ids > 1 else 1
    if bits > 31:
        raise ValueError(f"taggregate_group_extents: num_ids {num_ids} "
                         "exceeds the int32 id range")
    return bits


def _check_ts_range(what: str, batch, ts_range) -> None:
    """A stated range must hold the ts of every slot of the batch, padded
    ones too (the kernel's key field); checked where it costs no device
    sync, on the CPU."""
    if ts_range is None or batch.ts.numel() == 0:
        return
    lo, hi = (int(v) for v in torch.aminmax(batch.ts))
    if lo < ts_range[0] or hi > ts_range[1]:
        raise ValueError(f"{what}: ts range {tuple(ts_range)} does "
                         f"not hold the batch's ts [{lo}, {hi}]")


def _ts_range(batch, ts_range) -> Tuple[int, int]:
    """The stated range as ints, or the batch's own (a device sync)."""
    if ts_range is None:
        ts_range = (torch.stack(torch.aminmax(batch.ts)).tolist()
                    if batch.ts.numel() else (0, 0))
    return int(ts_range[0]), int(ts_range[1])


# ------------------------------------------------------------------------ #
# the plain versions


def _tstats_sorted(batch, m: int):
    """The batch stably sorted by (object, ts), padded slots (object m)
    last: (order, oid_s int64, ts_s int32, x_s, y_s, valid_s)."""
    hi = torch.where(batch.valid, batch.obj_id.to(torch.int64),
                     torch.full_like(batch.obj_id, m, dtype=torch.int64))
    key = hi * (1 << 32) + (batch.ts.to(torch.int64) + (1 << 31))
    skey, order = torch.sort(key, stable=True)
    oid_s = skey >> 32
    ts_s = ((skey & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)
    return (order, oid_s, ts_s, batch.x[order], batch.y[order], oid_s < m)


def _runs(oid_s, nv: int):
    """(run of each of the first ``nv`` sorted positions, run starts, run
    lengths) for the runs of equal ``oid_s``."""
    o = oid_s[:nv]
    first = torch.ones(nv, dtype=torch.bool, device=o.device)
    if nv > 1:
        first[1:] = o[1:] != o[:-1]
    rid = torch.cumsum(first.to(torch.int64), 0) - 1
    starts = torch.nonzero(first).reshape(-1)
    lens = torch.bincount(rid, minlength=starts.shape[0])
    return rid, starts, lens


def _run_sums(starts, lens, values):
    """For each run, the running f32 sums of ``values`` over its positions
    in order, one add per position as the kernels take them: (running (P,)
    at each position, totals (R,))."""
    acc = torch.zeros(starts.shape[0], dtype=torch.float32,
                      device=values.device)
    running = torch.zeros_like(values)
    longest = int(lens.max()) if lens.numel() else 0
    for j in range(longest):
        act = torch.nonzero(lens > j).reshape(-1)
        p = starts[act] + j
        acc[act] = acc[act] + values[p]
        running[p] = acc[act]
    return running, acc


def _prev_accepted(accepted, oid_s):
    """Position of the previous accepted point of the same run (clamped to
    0) and whether there is one."""
    n = accepted.shape[0]
    ar = torch.arange(n, dtype=torch.int64, device=accepted.device)
    pos = torch.where(accepted, ar, torch.full_like(ar, -1))
    prev = torch.full_like(ar, -1)
    if n > 1:
        prev[1:] = torch.cummax(pos, 0).values[:-1]
    gp = prev.clamp_min(0)
    return gp, (prev >= 0) & (oid_s[gp] == oid_s)


def tstats_update_plain(state: TrajStatsState, batch,
                        ts_range: Optional[Tuple[int, int]] = None):
    """Plain version of :func:`tstats_update` (state updated in place;
    ``ts_range`` is taken for the kernel's signature and not used)."""
    n = batch.x.shape[0]
    m = state.last_x.shape[0]
    dev = batch.x.device
    order, oid_s, ts_s, x_s, y_s, valid_s = _tstats_sorted(batch, m)
    safe = torch.where(valid_s, oid_s, torch.zeros_like(oid_s))
    run_first = torch.ones(n, dtype=torch.bool, device=dev)
    if n > 1:
        run_first[1:] = oid_s[1:] != oid_s[:-1]
    st_ts = state.last_ts[safe]
    prev_ts = torch.full_like(ts_s, INT32_MIN)
    if n > 1:
        prev_ts[1:] = ts_s[:-1]
    tie = ~run_first & (ts_s == prev_ts)
    accepted = valid_s & ~tie & (ts_s > st_ts)
    gp, has_bp = _prev_accepted(accepted, oid_s)
    init = st_ts != INT32_MIN
    lx = torch.where(has_bp, x_s[gp], state.last_x[safe])
    ly = torch.where(has_bp, y_s[gp], state.last_y[safe])
    lts = torch.where(has_bp, ts_s[gp], st_ts)
    emit = accepted & (has_bp | init)
    zero = torch.zeros_like(x_s)
    cd = torch.where(emit, D.pp_dist(lx, ly, x_s, y_s), zero)
    ct = torch.where(emit, (ts_s - lts).to(torch.float32), zero)

    nv = int(valid_s.sum())
    _, starts, lens = _runs(oid_s, nv)
    run_d, tot_d = _run_sums(starts, lens, cd[:nv])
    run_t, tot_t = _run_sums(starts, lens, ct[:nv])
    sv = safe[:nv]
    out_sp = torch.zeros_like(x_s)
    out_tm = torch.zeros_like(x_s)
    out_sp[:nv] = state.spatial[sv] + run_d
    out_tm[:nv] = state.temporal[sv] + run_t
    speed = torch.where(out_tm > 0, out_sp / out_tm, zero)
    out_oid = torch.where(valid_s, oid_s,
                          torch.full_like(oid_s, _OID_SENTINEL)
                          ).to(torch.int32)

    # the state: each run's last accepted point, and its totals
    ar = torch.arange(n, dtype=torch.int64, device=dev)
    last_acc = torch.cummax(torch.where(accepted, ar, torch.full_like(ar, -1)),
                            0).values if n else ar
    ends = starts + lens - 1
    la = last_acc[ends]
    have = la >= starts
    o = oid_s[starts[have]]
    la = la[have]
    state.last_x[o] = x_s[la]
    state.last_y[o] = y_s[la]
    state.last_ts[o] = ts_s[la]
    state.spatial[o] = state.spatial[o] + tot_d[have]
    state.temporal[o] = state.temporal[o] + tot_t[have]
    return state, TStatsOut(obj_id=out_oid, spatial=out_sp, temporal=out_tm,
                            speed=speed, emit=emit,
                            order=order.to(torch.int32))


def tstats_window_summary_plain(batch, *, m: int,
                                ts_range: Optional[Tuple[int, int]] = None
                                ) -> TStatsWindowSummary:
    """Plain version of :func:`tstats_window_summary` (``ts_range`` is
    taken for the kernel's signature and not used)."""
    n = batch.x.shape[0]
    dev = batch.x.device
    order, oid_s, ts_s, x_s, y_s, valid_s = _tstats_sorted(batch, m)
    run_first = torch.ones(n, dtype=torch.bool, device=dev)
    prev_ts = torch.full_like(ts_s, INT32_MIN)
    if n > 1:
        run_first[1:] = oid_s[1:] != oid_s[:-1]
        prev_ts[1:] = ts_s[:-1]
    accepted = valid_s & ~(~run_first & (ts_s == prev_ts))
    gp, has_bp = _prev_accepted(accepted, oid_s)
    pair = accepted & has_bp
    cd = torch.where(pair, D.pp_dist(x_s[gp], y_s[gp], x_s, y_s),
                     torch.zeros_like(x_s))
    nv = int(valid_s.sum())
    rid, starts, lens = _runs(oid_s, nv)
    _, tot = _run_sums(starts, lens, cd[:nv])
    ar = torch.arange(n, dtype=torch.int64, device=dev)
    last_acc = torch.cummax(torch.where(accepted, ar, torch.full_like(ar, -1)),
                            0).values if n else ar
    la = last_acc[starts + lens - 1]
    o = oid_s[starts]
    f32 = dict(dtype=torch.float32, device=dev)
    i32 = dict(dtype=torch.int32, device=dev)
    out = TStatsWindowSummary(
        spatial=torch.zeros(m, **f32), count=torch.zeros(m, **i32),
        min_ts=torch.full((m,), INT32_MAX, **i32),
        max_ts=torch.full((m,), INT32_MIN, **i32),
        first_x=torch.zeros(m, **f32), first_y=torch.zeros(m, **f32),
        last_x=torch.zeros(m, **f32), last_y=torch.zeros(m, **f32))
    counts = torch.zeros(starts.shape[0], dtype=torch.int32, device=dev)
    counts.index_add_(0, rid, accepted[:nv].to(torch.int32))
    out.spatial[o] = tot
    out.count[o] = counts
    out.min_ts[o] = ts_s[starts]
    out.max_ts[o] = ts_s[la]
    out.first_x[o] = x_s[starts]
    out.first_y[o] = y_s[starts]
    out.last_x[o] = x_s[la]
    out.last_y[o] = y_s[la]
    return out


def taggregate_group_extents_plain(batch, *, num_cells: int,
                                   num_ids: Optional[int] = None
                                   ) -> TAggregateExtents:
    """Plain version of :func:`taggregate_group_extents` (``num_ids`` is
    taken for the kernel's signature and not used)."""
    n = batch.x.shape[0]
    dev = batch.x.device
    ok = batch.valid & (batch.cell >= 0)
    nc = torch.full_like(batch.cell, num_cells, dtype=torch.int64)
    hi = torch.where(ok, batch.cell.to(torch.int64).clamp(max=num_cells), nc)
    lo = torch.where(ok, batch.obj_id.to(torch.int64),
                     torch.zeros_like(nc))
    skey, perm = torch.sort(hi * (1 << 31) + lo, stable=True)
    cell_s = skey >> 31
    in_grid = cell_s < num_cells
    oid_s = torch.where(in_grid, skey & INT32_MAX,
                        torch.full_like(skey, _OID_SENTINEL))
    ts_p = batch.ts[perm]
    starts = torch.ones(n, dtype=torch.bool, device=dev)
    if n > 1:
        starts[1:] = skey[1:] != skey[:-1]
    gid = torch.cumsum(starts.to(torch.int64), 0) - 1
    g = int(gid[-1]) + 1 if n else 0
    mn = torch.full((g,), INT32_MAX, dtype=torch.int32, device=dev)
    mx = torch.full((g,), INT32_MIN, dtype=torch.int32, device=dev)
    mn.scatter_reduce_(0, gid, ts_p, "amin")
    mx.scatter_reduce_(0, gid, ts_p, "amax")
    return TAggregateExtents(cell=cell_s.to(torch.int32),
                             obj_id=oid_s.to(torch.int32),
                             min_ts=mn[gid], max_ts=mx[gid],
                             first=starts & in_grid)


def taggregate_heatmap_plain(groups: TAggregateGroups, *, num_cells: int,
                             agg: str) -> torch.Tensor:
    """Plain version of :func:`taggregate_heatmap`."""
    code = _agg_code(agg)
    dev = groups.cell.device
    out = torch.zeros(num_cells, dtype=torch.float32, device=dev)
    f = torch.nonzero(groups.first).reshape(-1)
    if f.numel() == 0:
        return out
    c = groups.cell[f].to(torch.int64)
    v = groups.length[f].to(torch.float32)
    if code in (2, 3):
        out.scatter_reduce_(0, c, v, "amin" if code == 2 else "amax",
                            include_self=False)
        return out
    _, starts, lens = _runs(c, c.shape[0])
    _, total = _run_sums(starts, lens, v)
    _, cnt = _run_sums(starts, lens, torch.ones_like(v))
    cells = c[starts]
    out[cells] = {0: total, 1: total / cnt, 4: cnt}[code]
    return out


# ------------------------------------------------------------------------ #
# the kernels

_C = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_UPDATE_ARGTYPES = (_C, _C, _C, _C, _C, _I, _I, _L, _I, _I, _C, _C, _C, _C,
                    _C, _C, _C, _C, _C, _C, _C, _C, _C)
_SUMMARY_ARGTYPES = (_C, _C, _C, _C, _C, _I, _I, _L, _I, _I, _C, _C, _C, _C,
                     _C, _C, _C, _C, _C, _C)
_EXTENTS_ARGTYPES = (_C, _C, _C, _C, _I, _I, _I, _I, _C, _C, _C, _C, _C, _C,
                     _C)
_HEATMAP_ARGTYPES = (_C, _C, _C, _I, _I, _I, _C, _C)


@functools.lru_cache(maxsize=None)
def _fn(symbol: str, argtypes: tuple, restype=ctypes.c_int):
    """``csrc/traj.cu``'s C function, looked up once."""
    return native.function("traj", symbol, argtypes, restype)


@functools.lru_cache(maxsize=None)
def _sort_scratch_bytes(n: int, bits: int) -> int:
    """K8a's, K8b's and K8c's tiled scratch for n points on a bits-bit
    key."""
    return int(_fn("traj_sort_scratch_bytes", (_I, _I), _L)(n, bits))


def _carve(dev, n: int, words: int, bools: int, scratch_bytes: int = 0):
    """One device allocation for a wrapper's outputs and scratch: ``words``
    (n,) rows of 4-byte values (int32; a float32 row is a view of one),
    ``bools`` (n,) bool rows and ``scratch_bytes`` after them, each part
    256-byte aligned: ((words, n) int32, [bool rows], the scratch's address
    or None)."""
    row, brow = -(-n // 64) * 64, -(-n // 256) * 256
    head = 4 * row * words + brow * bools
    buf = torch.empty(head + scratch_bytes, dtype=torch.uint8, device=dev)
    w = buf[:4 * row * words].view(torch.int32).view(words, row)[:, :n]
    b = [buf[4 * row * words + i * brow:][:n].view(torch.bool)
         for i in range(bools)]
    return w, b, (buf.data_ptr() + head if scratch_bytes else None)


def _agg_code(agg: str) -> int:
    code = AGGREGATES.get(str(agg).upper())
    if code is None:
        raise ValueError(f"unknown aggregate {agg!r}")
    return code


def _check_batch(what: str, batch) -> torch.device:
    """Device, dtype, shape and contiguity of a CUDA point batch."""
    dev = batch.x.device
    n = batch.x.shape[0]
    for name, dt in (("x", torch.float32), ("y", torch.float32),
                     ("obj_id", torch.int32), ("ts", torch.int32),
                     ("cell", torch.int32), ("valid", torch.bool)):
        t = getattr(batch, name)
        if t.device != dev:
            raise ValueError(f"{what}: {name} on {t.device}, x on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{what}: {name} is {t.dtype}, needs {dt}")
        if tuple(t.shape) != (n,):
            raise ValueError(f"{what}: {name} shape {tuple(t.shape)}, needs "
                             f"({n},)")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} is not contiguous")
    return dev


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def tstats_update(state: TrajStatsState, batch,
                  ts_range: Optional[Tuple[int, int]] = None):
    """-> (state, :class:`TStatsOut`): K8a. The batch's obj_id must lie in
    [0, M) for an M-slot state; the state is updated in place (the JAX
    package donates it). ``ts_range`` = (lo, hi) must hold the ts of every
    slot of the batch, padded ones too (the operators take it from the
    rows they build the batch from); None reads it from the batch, a
    device sync. CPU tensors run :func:`tstats_update_plain` (and check a
    stated range); CUDA tensors launch ``csrc/traj.cu``."""
    if batch.x.device.type == "cpu":
        _check_ts_range("tstats_update", batch, ts_range)
        return tstats_update_plain(state, batch)
    dev = _check_batch("tstats_update", batch)
    m = state.last_x.shape[0]
    for name, dt in (("last_x", torch.float32), ("last_y", torch.float32),
                     ("last_ts", torch.int32), ("spatial", torch.float32),
                     ("temporal", torch.float32)):
        t = getattr(state, name)
        if t.device != dev or t.dtype != dt or tuple(t.shape) != (m,) \
                or not t.is_contiguous():
            raise ValueError(f"tstats_update: state.{name} must be a "
                             f"contiguous ({m},) {dt} on {dev}")
    n = batch.x.shape[0]
    lo, hi = _ts_range(batch, ts_range)
    ts_bits, lay = tstats_layout(n, m, lo, hi)
    scratch = 0 if lay.one_block else _sort_scratch_bytes(n, lay.bits)
    w, (out_emit,), scratch_ptr = _carve(dev, n, 5, 1, scratch)
    f = w.view(torch.float32)
    out_oid, out_sp, out_tm, out_speed, order = w[0], f[1], f[2], f[3], w[4]
    launch = _fn("tstats_update_launch", _UPDATE_ARGTYPES)
    with torch.cuda.device(dev):
        err = launch(batch.x.data_ptr(), batch.y.data_ptr(),
                     batch.obj_id.data_ptr(), batch.ts.data_ptr(),
                     batch.valid.data_ptr(), n, m, lo, ts_bits,
                     int(lay.one_block), state.last_x.data_ptr(),
                     state.last_y.data_ptr(), state.last_ts.data_ptr(),
                     state.spatial.data_ptr(), state.temporal.data_ptr(),
                     out_oid.data_ptr(), out_sp.data_ptr(), out_tm.data_ptr(),
                     out_speed.data_ptr(), out_emit.data_ptr(),
                     order.data_ptr(), scratch_ptr, _stream(dev))
    native.check(err, "tstats_update")
    tstats_update.launches += 1
    return state, TStatsOut(obj_id=out_oid, spatial=out_sp, temporal=out_tm,
                            speed=out_speed, emit=out_emit, order=order)


tstats_update.launches = 0


def tstats_window_summary(batch, *, m: int,
                          ts_range: Optional[Tuple[int, int]] = None
                          ) -> TStatsWindowSummary:
    """Fresh-state (windowed) per-trajectory summary of one batch (a pane):
    K8b, on K8a's key and sort. obj_id in [0, m); ``ts_range`` as
    :func:`tstats_update` takes it (None reads it from the batch, a device
    sync). CPU tensors run :func:`tstats_window_summary_plain` (and check a
    stated range); CUDA tensors launch ``csrc/traj.cu``."""
    if batch.x.device.type == "cpu":
        _check_ts_range("tstats_window_summary", batch, ts_range)
        return tstats_window_summary_plain(batch, m=m)
    dev = _check_batch("tstats_window_summary", batch)
    if m < 1:
        raise ValueError(f"tstats_window_summary: m must be >= 1, got {m}")
    n = batch.x.shape[0]
    lo, hi = _ts_range(batch, ts_range)
    ts_bits, lay = summary_layout(n, m, lo, hi)
    scratch = 0 if lay.one_block else _sort_scratch_bytes(n, lay.bits)
    w, _, scratch_ptr = _carve(dev, m, 8, 0, scratch)
    f = w.view(torch.float32)
    out = TStatsWindowSummary(spatial=f[0], count=w[1], min_ts=w[2],
                              max_ts=w[3], first_x=f[4], first_y=f[5],
                              last_x=f[6], last_y=f[7])
    launch = _fn("tstats_summary_launch", _SUMMARY_ARGTYPES)
    with torch.cuda.device(dev):
        err = launch(batch.x.data_ptr(), batch.y.data_ptr(),
                     batch.obj_id.data_ptr(), batch.ts.data_ptr(),
                     batch.valid.data_ptr(), n, int(m), lo, ts_bits,
                     int(lay.one_block), *(t.data_ptr() for t in out),
                     scratch_ptr, _stream(dev))
    native.check(err, "tstats_window_summary")
    tstats_window_summary.launches += 1
    return out


tstats_window_summary.launches = 0


def taggregate_group_extents(batch, *, num_cells: int,
                             num_ids: Optional[int] = None
                             ) -> TAggregateExtents:
    """Group a window by (cell, objID) with per-group [min_ts, max_ts]
    extents (``tAggregate/TAggregateQuery.java:381-494``): K8c.
    ``num_ids`` bounds the object ids (0 <= id < num_ids; read from the
    ids, a device sync, when None). CPU tensors run
    :func:`taggregate_group_extents_plain`; CUDA tensors launch
    ``csrc/traj.cu``."""
    if batch.x.device.type == "cpu":
        return taggregate_group_extents_plain(batch, num_cells=num_cells)
    dev = _check_batch("taggregate_group_extents", batch)
    if num_cells < 1:
        raise ValueError(f"taggregate_group_extents: num_cells must be >= 1, "
                         f"got {num_cells}")
    n = batch.x.shape[0]
    if num_ids is None:
        num_ids = int(batch.obj_id.max()) + 1 if n else 1
    oid_bits = _oid_bits(num_ids)
    lay = extents_layout(n, num_cells, oid_bits)
    scratch = 0 if lay.one_block else _sort_scratch_bytes(n, lay.bits)
    w, (first,), scratch_ptr = _carve(dev, n, 4, 1, scratch)
    out = TAggregateExtents(cell=w[0], obj_id=w[1], min_ts=w[2],
                            max_ts=w[3], first=first)
    launch = _fn("taggregate_extents_launch", _EXTENTS_ARGTYPES)
    with torch.cuda.device(dev):
        err = launch(batch.cell.data_ptr(), batch.obj_id.data_ptr(),
                     batch.ts.data_ptr(), batch.valid.data_ptr(), n,
                     int(num_cells), oid_bits, int(lay.one_block),
                     *(t.data_ptr() for t in out), scratch_ptr, _stream(dev))
    native.check(err, "taggregate_group_extents")
    taggregate_group_extents.launches += 1
    return out


taggregate_group_extents.launches = 0


def taggregate_groups(batch, *, num_cells: int,
                      num_ids: Optional[int] = None) -> TAggregateGroups:
    """Group a window by (cell, objID); per-group trajectory length = max -
    min timestamp (K8c, then one subtraction)."""
    e = taggregate_group_extents(batch, num_cells=num_cells, num_ids=num_ids)
    return TAggregateGroups(cell=e.cell, obj_id=e.obj_id,
                            length=e.max_ts - e.min_ts, first=e.first)


def taggregate_heatmap(groups: TAggregateGroups, *, num_cells: int,
                       agg: str) -> torch.Tensor:
    """Dense (num_cells,) f32 heatmap from (cell, objID) groups in K8c's
    (cell, object) order: agg in {SUM, AVG, MIN, MAX, COUNT}
    (``geoflink-conf.yml:53``; ALL is served by the groups themselves):
    K8d, one launch (the kernel takes each cell's groups from K8c's
    cell-ascending order). CPU tensors run :func:`taggregate_heatmap_plain`;
    CUDA tensors launch ``csrc/traj.cu``."""
    code = _agg_code(agg)
    if groups.cell.device.type == "cpu":
        return taggregate_heatmap_plain(groups, num_cells=num_cells, agg=agg)
    dev = groups.cell.device
    n = groups.cell.shape[0]
    for name, dt in (("cell", torch.int32), ("length", torch.int32),
                     ("first", torch.bool)):
        t = getattr(groups, name)
        if t.device != dev or t.dtype != dt or tuple(t.shape) != (n,) \
                or not t.is_contiguous():
            raise ValueError(f"taggregate_heatmap: {name} must be a "
                             f"contiguous ({n},) {dt} on {dev}")
    if num_cells < 1:
        raise ValueError(f"taggregate_heatmap: num_cells must be >= 1, got "
                         f"{num_cells}")
    out = torch.empty(num_cells, dtype=torch.float32, device=dev)
    launch = _fn("taggregate_heatmap_launch", _HEATMAP_ARGTYPES)
    with torch.cuda.device(dev):
        err = launch(groups.cell.data_ptr(), groups.length.data_ptr(),
                     groups.first.data_ptr(), n, int(num_cells), code,
                     out.data_ptr(), _stream(dev))
    native.check(err, "taggregate_heatmap")
    taggregate_heatmap.launches += 1
    return out


taggregate_heatmap.launches = 0


# ------------------------------------------------------------------------ #
# the pane merges (host)


def tstats_stitch_host(parts):
    """NumPy stitch of per-PANE window summaries (copy of the JAX
    package's): ``parts`` is a time-ordered list of dicts with keys
    ``spatial``/``count``/``min_ts``/``max_ts`` (absolute int64 ms)
    /``first_x``/``first_y``/``last_x``/``last_y``, each sized to its
    pane's interner bucket — shorter tables are padded with absent-
    trajectory defaults. Returns ``(spatial (M,) f32, temporal_ms (M,) i64,
    count (M,))``; trajectories emit iff count >= 2. Panes partition event
    time, so the boundary link d(last of the previous present pane, first
    of the next) is exactly the consecutive pair of the whole window's
    sorted run."""
    i64 = np.int64
    M = max(p["count"].shape[0] for p in parts)

    def pad(a, fill, dtype=None):
        if a.shape[0] == M:
            return a
        out = np.full(M, fill, dtype or a.dtype)
        out[: a.shape[0]] = a
        return out

    spatial = np.zeros(M, np.float32)
    count = np.zeros(M, i64)
    min_ts = np.full(M, np.iinfo(i64).max, i64)
    max_ts = np.full(M, np.iinfo(i64).min, i64)
    has = np.zeros(M, bool)
    plx = np.zeros(M, np.float32)
    ply = np.zeros(M, np.float32)
    for p in parts:
        cnt = pad(p["count"], 0)
        present = cnt > 0
        link = has & present
        fx, fy = pad(p["first_x"], 0.0), pad(p["first_y"], 0.0)
        dx = (fx - plx).astype(np.float32)
        dy = (fy - ply).astype(np.float32)
        spatial += pad(p["spatial"], 0.0) + np.where(
            link, np.hypot(dx, dy).astype(np.float32), np.float32(0.0))
        count += cnt
        min_ts = np.minimum(min_ts, pad(p["min_ts"], np.iinfo(i64).max))
        max_ts = np.maximum(max_ts, pad(p["max_ts"], np.iinfo(i64).min))
        lx, ly = pad(p["last_x"], 0.0), pad(p["last_y"], 0.0)
        plx = np.where(present, lx, plx)
        ply = np.where(present, ly, ply)
        has |= present
    temporal = np.where(count > 0, max_ts - min_ts, 0)
    return spatial, temporal, count


def taggregate_merge_extents_host(parts):
    """Merge per-pane (cell, objID, min_ts, max_ts) extent rows into the
    window's groups (copy of the JAX package's): ``parts`` is a list of
    ``(cells, oids, min_ts, max_ts)`` array tuples; returns
    ``{(cell, oid): (min_ts, max_ts)}`` in first-seen order."""
    merged: dict = {}
    for cells, oids, mns, mxs in parts:
        for c, o, mn, mx in zip(cells.tolist(), oids.tolist(),
                                mns.tolist(), mxs.tolist()):
            key = (c, o)
            cur = merged.get(key)
            if cur is None:
                merged[key] = (mn, mx)
            else:
                merged[key] = (min(cur[0], mn), max(cur[1], mx))
    return merged
