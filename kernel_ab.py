#!/usr/bin/env python3
"""Times the port's K1, K2, K3, K4, K5, K6, K7, K8a and K8c kernels against
an earlier revision's, on one card, in turns (old, new, new, old), at the
main path's shapes.

Run from the root of a checkout on a machine with one NVIDIA card, with
the earlier revision's ``csrc/`` unpacked into a directory that
``.gitignore`` lists:

    git archive <commit> spatialflink_tpu_torch/csrc | tar -x -C _scratch/old
    python3 kernel_ab.py --old _scratch/old/spatialflink_tpu_torch/csrc \
        [--kernels k1,k2,k3,k4,k5,k6,k7,k8]
    python3 kernel_ab.py --kernels k3wide

The old ``range_mask.cu``, ``pip_dist.cu`` (with its ``pip_edges.cuh``)
and ``geom_dist.cu`` are built with the port's own nvcc flags into
``_scratch/ab_build`` and called through their C signatures, which are
those of commit 48d27a2 and later for ``range_mask_stats_launch(mode,
approximate, n, Q, ..., mask_out, dists_out, counts, stream)`` (it zeroes
the counts with its own memset) and ``pip_dist_launch(px, py, n, edges,
edge_mask, ne, is_areal, dist, stream)``, and those of commit c481f39
and later for ``geom_dist_launch``, whose arguments the wrapper
``ops/geom.geom_stream_dist`` marshals for both sides, and those of commit
407ef10 for ``join_reduce_launch(ax, ay, acell, avalid, na, bx, by, bcell,
bvalid, nb, r2, layers, n, cnt, mind2, amin, stream)`` and
``join_lattice_count`` / ``join_lattice_write(ax, ay, acell, avalid, rows,
m, bx, by, bcell, bvalid, nb, tile, cx, cy, r2, layers, all_cells, n,
counts, offsets, out_a, out_b, stream)`` (K7 and K6 as they walked every b
point, before the join index), which ``old_reduce`` and ``old_lattice``
call as that revision's wrappers did, and those of commit 90102f5 for
``knn_merge_launch(panes, queries, k, obj_id, dist, valid, scratch_ints,
s_oid, s_dist, out_oid, out_dist, out_valid, stream)`` (K3 over stacked
(P, Q, k) partials, sorting each row twice), which ``old_merge`` calls
after the three ``torch.stack`` copies that revision's device merge
made, and ``knn_topk_launch`` with a (Q, 2,048) candidate list (K2 as
commit 90102f5 had it, k <= 1,024), which ``old_topk`` calls. Every case
first checks that old and new give the same outputs bit for bit, then
times 5 rounds of old, new, new, old (10 pairs) with chip_smoke's timer
(CUDA events, L2 evicted before each launch), counts the pairs the new
side wins, each side's A/A ratio (the median of its first run in each
round over that of its second), and prints one JSON line per case with a
profiler split of
the new side's device operations (kernels and memsets) and, for K1 and
K5, of the old side's; the card's name and power limit beside it, and a
summary line last.

Cases. K1 and K4 at 1,048,576 points over the conf's bbox: K1 point Q=1
with its distances and without (the main path's form), point Q=16, mask
mode Q=1 (over the first polygon's K4x row, as options 6 and 11 call it),
Q=8 and Q=16 over K4x rows; K4 on the conf's 100 x 100 grid: the main
path's 64-edge polygon with its per-cell table and without, 128-, 256-
and 512-edge polygons (table) and a 1,301-edge one (dense in both), each
with the table's fold share (``hopper_kernels.pip_table_fold_share``);
and K4 on coarser grids (64 and 512 edges on 10 x 10 against the old
kernel; then a sweep of grids of 2 to 100 cells a side over the conf's
2-edge linestring and 8- to 512-edge polygons, the table form forced
against the dense fold, both new), which sets ``hopper_kernels.pip_table``'s
gate. K5 at ``chip_smoke.k5_setups``' 13 cases: a 131,072-geometry
window of chip_smoke's polygon and linestring streams (generated and
parsed here the same way, ~1 min) against the conf's point, the conf's polygon, the 16
query polygons and the conf's linestring, range and kNN mode, approximate
once, and a 512-polygon micro-batch against the conf's polygon and point,
whose launch-to-completion times (host clock) stand beside their card
times. K7 and K6 at ``chip_smoke.join_setups``' cases (option 101's
window, 262,144 x 8,192, uniform and clustered, K6 on the rows K7 keeps;
the sparse stream's 262,144 x 256; the conf's radius 0.5; realtime 102's
per-cut shapes 512 x 2,048 and 65,536 x 256): the new side's K7 and its
direct-branch K6 build the join index inside the call, and its K6 on
K7's rows takes the index K7's window built (as ``join_pairs_host``
shares it); each with both sides' launch-to-completion times. K3 at
``chip_smoke.K3_CASES`` (option 51's window and its multiQuery, 10 and 60
panes, k = 1,024, rows of 16 blocks, ties, duplicates, all-invalid rows,
K2's partials over 1 s panes): the old side stacks the partials and
launches, the new side reads them through ``knn_merge_parts``; each with
both sides' launch-to-completion times, and the new side's host steps (``k3_host_split``). The old kernel
refuses k > 1,024, so its k = 2,048 case times the new side alone.
``k3wide`` needs no earlier revision: it times the checkout's K3 on rows
wider than one block of k <= 512 (``K3_WIDE_CASES``) through its two
wide-row paths, each forced by a variant of the source (``K3_VARIANTS``:
the sort across blocks, and the survivor reduce whatever its levels),
beside the port's own choice. K2 at
``chip_smoke.k2_specs``' cases of k <= 1,024 (1,048,576 points, 100,000
ids), whose path the k > 1,024 work must leave as it was.

``k8``: K8a (``tstats_update``) and K8c (``taggregate_group_extents``)
against the ``traj.cu`` of commit 9f063e8 (one 64-bit key, three launches
per 8-bit pass), called through that commit's ``tstats_update_launch(x,
y, oid, ts, valid, n, m, last_x, last_y, last_ts, spatial, temporal,
out_oid, out_sp, out_tm, out_speed, out_emit, order, scratch, stream)``
and ``taggregate_extents_launch(cell, oid, ts, valid, n, num_cells,
oid_bits, out_cell, out_oid, out_min, out_max, out_first, scratch,
stream)`` by a copy of that commit's wrappers (``old_tstats_update``,
``old_group_extents``: their host work as it was, six or seven
allocations and the ctypes lookups per call), over chip_smoke's
trajectory stream (10,357 taxis): K8a at the 10 s window (fresh
16,384-slot state) and at a 512-point cut with the state of the 64 cuts
before it, K8c at the window and at the 5 s pane, and both at the window
skewed so that one object holds 3/4 of its points. Each case adds
``torch.sort(keys, stable=True)`` of the same packed keys (the new key
layout, int64) as a yardstick of the sort stage alone, and both
wrappers' host microseconds per call. Then the new kernels' two paths
against each other (``ONE_BLOCK_MAX`` forced to 0 for the tiled one) at
512-4,096 consecutive points, the one-block path's range.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

import numpy as np

import chip_smoke as CS

BUILD = os.path.join(CS.ROOT, "_scratch", "ab_build")
#: rounds of old, new, new, old per A/B case (two pairs each)
ROUNDS = 5
_C, _I = ctypes.c_void_p, ctypes.c_int
#: knn_topk_launch's arguments before the trajectory kNN's radius filter
#: (the revisions this script compares against)
K2_OLD_ARGTYPES = (_I, _I, _I, _I, _I, _C, _C, _C, _C, _C, _C, _C, _C, _I,
                   _I, _C, _C, _I, _C, _C, _C, _C, _C, _C, _C, _C, _C)


def build_old(old_csrc: str, names) -> dict:
    """Compile the old sources (one nvcc each, in parallel) and load them."""
    from spatialflink_tpu_torch.ops import geom as G
    from spatialflink_tpu_torch.ops import knn as K
    from spatialflink_tpu_torch.ops import native

    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name in names:
        out = os.path.join(BUILD, f"libold_{name}.so")
        cmd = [native.nvcc_path(), *native.NVCC_FLAGS, "-o", out,
               os.path.join(old_csrc, f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    libs = {}
    for name, (proc, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the old {name}.cu:\n{log}")
        print("old-build", name, json.dumps(native.ptxas_report(log)),
              flush=True)
        libs[name] = ctypes.CDLL(out)
    C, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if "range_mask" in libs:
        libs["range_mask"].range_mask_stats_launch.argtypes = (
            [I, I, I, I, C, C, C, C, F, F, I, C, C, C, I, I, I, C, C, C, I, F,
             C, C, C, C])
    if "pip_dist" in libs:
        libs["pip_dist"].pip_dist_launch.argtypes = [C, C, I, C, C, I, I, C,
                                                     C]
    if "geom_dist" in libs:
        fn = libs["geom_dist"].geom_dist_launch
        fn.argtypes, fn.restype = list(G._ARGTYPES), ctypes.c_int
    if "join_reduce" in libs:
        libs["join_reduce"].join_reduce_launch.argtypes = [
            C, C, C, C, I, C, C, C, C, I, F, I, I, C, C, C, C]
    if "knn_topk" in libs:
        libs["knn_topk"].knn_topk_launch.argtypes = list(K2_OLD_ARGTYPES)
        libs["knn_topk"].knn_topk_zone_ints.argtypes = [I, I]
        libs["knn_topk"].knn_topk_zone_ints.restype = ctypes.c_longlong
    if "knn_merge" in libs:
        libs["knn_merge"].knn_merge_launch.argtypes = [
            I, I, I, C, C, C, ctypes.c_longlong, C, C, C, C, C, C]
    if "traj" in libs:
        lib = libs["traj"]
        lib.tstats_update_launch.argtypes = [C] * 5 + [I, I] + [C] * 13
        lib.taggregate_extents_launch.argtypes = [C] * 4 + [I, I, I] + [C] * 7
        lib.traj_scratch_bytes.argtypes = [I]
        lib.traj_scratch_bytes.restype = ctypes.c_longlong
    if "join_lattice" in libs:
        for fn in (libs["join_lattice"].join_lattice_count,
                   libs["join_lattice"].join_lattice_write):
            fn.argtypes = [C, C, C, C, C, I, C, C, C, C, I, I, F, F, F, I, I,
                           I, C, C, C, C, C]
    return libs


def _ptr(t):
    return None if t is None else t.data_ptr()


def old_range(torch, lib, b, *, mode, approximate, radius, qx=0.0, qy=0.0,
              q_cell=-1, qxs=None, qys=None, q_cells=None, n=1, gn_layers=-1,
              cn_layers=-1, gn_mask=None, cn_mask=None, dists=None,
              with_dists=False):
    """The old K1 launch: (mask (Q, N), counts (Q, 2)[, dists (Q, N)])."""
    N = b.capacity
    if mode == 0:
        Q = 1 if qxs is None else qxs.shape[0]
    else:
        Q = 1 if gn_mask.dim() == 1 else gn_mask.shape[0]
    mask = torch.empty((Q, N), dtype=torch.bool, device="cuda")
    counts = torch.empty((Q, 2), dtype=torch.int32, device="cuda")
    dout = (torch.empty((Q, N), dtype=torch.float32, device="cuda")
            if with_dists else None)
    err = lib.range_mask_stats_launch(
        mode, int(approximate), N, Q, b.x.data_ptr(), b.y.data_ptr(),
        b.cell.data_ptr(), b.valid.data_ptr(), qx, qy, q_cell, _ptr(qxs),
        _ptr(qys), _ptr(q_cells), n, gn_layers, cn_layers, _ptr(gn_mask),
        _ptr(cn_mask), _ptr(dists), 0 if gn_mask is None
        else gn_mask.shape[-1], radius, mask.data_ptr(), _ptr(dout),
        counts.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"old range_mask: CUDA error {err}")
    return (mask, counts) + ((dout,) if with_dists else ())


def new_range(R, b, with_dists=False, **kw):
    """The new K1 launch in the old one's output layout."""
    N = b.capacity
    mask, dists, counts = R.range_mask_stats(b, return_dists=with_dists,
                                             **kw)
    Q = counts.numel() // 2
    out = (mask.reshape(Q, N), counts.reshape(Q, 2))
    return out + ((dists.reshape(Q, N),) if with_dists else ())


def old_pip(torch, lib, px, py, edges, edge_mask, is_areal):
    dist = torch.empty_like(px)
    err = lib.pip_dist_launch(px.data_ptr(), py.data_ptr(), px.shape[0],
                              edges.data_ptr(), edge_mask.data_ptr(),
                              edges.shape[0], int(is_areal), dist.data_ptr(),
                              torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"old pip_dist: CUDA error {err}")
    return dist


def old_geom(G, launch, gb, args):
    """The old K5 launch: the wrapper's own checks and argument marshalling
    (``ops/geom.geom_stream_dist``) with the old library's
    ``geom_dist_launch`` in place of the new one."""
    real = G.native.function
    G.native.function = lambda *a, **kw: launch
    try:
        return G.geom_stream_dist(gb, **args)
    finally:
        G.native.function = real


def old_reduce(torch, lib, a, b, radius, layers, n):
    """The old K7 launch (commit 407ef10's wrapper): every b point staged
    for every a point."""
    from spatialflink_tpu_torch.ops import join as J

    na, nb = a.capacity, b.capacity
    cnt = torch.empty(na, dtype=torch.int32, device="cuda")
    mind2 = torch.empty(na, dtype=torch.float32, device="cuda")
    amin = torch.empty(na, dtype=torch.int32, device="cuda")
    err = lib.join_reduce_launch(
        a.x.data_ptr(), a.y.data_ptr(), a.cell.data_ptr(),
        a.valid.data_ptr(), na, b.x.data_ptr(), b.y.data_ptr(),
        b.cell.data_ptr(), b.valid.data_ptr(), nb, J._r2(radius),
        J._layers(layers), n, cnt.data_ptr(), mind2.data_ptr(),
        amin.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"old join_reduce: CUDA error {err}")
    return cnt, mind2, amin


def old_lattice(torch, lib, a, b, radius, layers, cx, cy, n, rows=None):
    """The old K6 launch (commit 407ef10's wrapper): a count pass and a
    scan over every b point of each tile, one read of the pair total, and
    a write pass."""
    from spatialflink_tpu_torch.ops import join as J

    na, nb = a.capacity, b.capacity
    m = na if rows is None else rows.numel()
    tile = max(1, min(J.JOIN_TILE, nb))
    n_tiles = -(-nb // tile)
    blocks = -(-m // J.LATTICE_ROWS_PER_BLOCK) * n_tiles
    counts = torch.empty(max(1, m * n_tiles), dtype=torch.int32,
                         device="cuda")
    offsets = torch.empty(blocks + 1, dtype=torch.int32, device="cuda")
    lay = J._layers(layers)
    args = (a.x.data_ptr(), a.y.data_ptr(), a.cell.data_ptr(),
            a.valid.data_ptr(), None if rows is None else rows.data_ptr(), m,
            b.x.data_ptr(), b.y.data_ptr(), b.cell.data_ptr(),
            b.valid.data_ptr(), nb, tile, J._f32(cx), J._f32(cy),
            J._r2(radius), lay, int(lay >= J.NO_LAYER), n,
            counts.data_ptr(), offsets.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    if lib.join_lattice_count(*args, None, None, stream):
        raise RuntimeError("old join_lattice count: CUDA error")
    total = int(offsets[blocks])
    ai = torch.empty(total, dtype=torch.int32, device="cuda")
    bi = torch.empty(total, dtype=torch.int32, device="cuda")
    if total and lib.join_lattice_write(*args, ai.data_ptr(), bi.data_ptr(),
                                        stream):
        raise RuntimeError("old join_lattice write: CUDA error")
    return ai, bi


def old_topk(torch, lib, obj_id, *, mode, k, num_ids, n=1, nb_layers=-1,
             **kw):
    """The old K2 call, as that revision's wrapper made it."""
    from spatialflink_tpu_torch.ops import knn as K
    from spatialflink_tpu_torch.ops import native

    dev = obj_id.device
    N, Q, cells, p = K._launch_args(obj_id, mode=mode, **kw)
    best = torch.empty((max(num_ids, 1), Q), dtype=torch.int32, device=dev)
    zone = torch.empty(lib.knn_topk_zone_ints(Q, num_ids), dtype=torch.int32,
                       device=dev)
    cand = torch.empty((Q, 2048), dtype=torch.int64, device=dev)
    over = torch.empty((Q, max(num_ids, 1)), dtype=torch.int64, device=dev)
    out = (torch.empty((Q, k), dtype=torch.int32, device=dev),
           torch.empty((Q, k), dtype=torch.float32, device=dev),
           torch.empty((Q, k), dtype=torch.bool, device=dev))
    err = lib.knn_topk_launch(
        mode, N, Q, num_ids, k, p["obj_id"], p["x"], p["y"], p["cell"],
        p["valid"], p["qx"], p["qy"], p["q_cell"], int(n), int(nb_layers),
        p["dists"], p["nb_mask"], cells, p["eligible"], best.data_ptr(),
        zone.data_ptr(), cand.data_ptr(), over.data_ptr(),
        *(t.data_ptr() for t in out),
        torch.cuda.current_stream(dev).cuda_stream)
    native.check(err, "old knn_topk")
    return (*out, zone[:Q])


def k2_cases(torch, timer, card, lib, lattice_rows, seed) -> list:
    """K2 old/new at chip_smoke's K2 cases of k <= 1,024."""
    from spatialflink_tpu_torch.ops import knn as K

    specs, _ = CS.k2_specs(torch, seed, lattice_rows)
    rows = []
    for name, k, kw in specs:
        if k > 1024:
            continue
        kw = dict(kw)
        obj_id = kw.pop("obj_id")

        def old(kw=kw, k=k, o=obj_id):
            return old_topk(torch, lib, o, k=k, **kw)

        def new(kw=kw, k=k, o=obj_id):
            return K.knn_topk(o, k=k, **kw)

        rows.append(ab_case(torch, timer, card, f"K2 {name}", old, new,
                            split_old=True, k=k))
    return rows


def old_merge(torch, lib, parts, k):
    """The old K3 call: the three stacks of its device merge, its
    outputs and two scratch halves (four allocations), one launch."""
    from spatialflink_tpu_torch.ops import knn as K
    from spatialflink_tpu_torch.ops import native

    oid, dist, valid = (torch.stack([getattr(r, f) for r in parts])
                        for f in K.KnnResult._fields)
    p, q, _ = oid.shape
    m = p * k
    n_scratch = max(q * -(-m // 8192) * k if m > 8192 else 0, 1)
    dev = oid.device
    s_oid = torch.empty((2, n_scratch), dtype=torch.int32, device=dev)
    s_dist = torch.empty((2, n_scratch), dtype=torch.float32, device=dev)
    out = K.KnnResult(torch.empty((q, k), dtype=torch.int32, device=dev),
                      torch.empty((q, k), dtype=torch.float32, device=dev),
                      torch.empty((q, k), dtype=torch.bool, device=dev))
    err = lib.knn_merge_launch(
        p, q, k, oid.data_ptr(), dist.data_ptr(), valid.data_ptr(),
        n_scratch, s_oid.data_ptr(), s_dist.data_ptr(),
        *(t.data_ptr() for t in out),
        torch.cuda.current_stream(dev).cuda_stream)
    native.check(err, "old knn_merge")
    return out


def host_us(torch, fn, reps: int = 400) -> float:
    """Median host microseconds of one call of ``fn`` (the device
    synchronised after each call, outside the time)."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
        torch.cuda.synchronize()
    return float(np.median(ts)) * 1e6


def k3_host_split(torch, parts, k) -> dict:
    """Host microseconds of ``knn_merge_parts``' steps: the partials'
    checks (``_part_ptrs``), the output allocation and its views, the C
    launch call alone (arguments made beforehand), the whole wrapper; and
    the three ``torch.stack`` copies that commit 90102f5's device merge
    made."""
    from spatialflink_tpu_torch.ops import knn as K

    p = len(parts)
    single = parts[0].obj_id.dim() == 1
    ptrs, q, dev = K._part_ptrs(parts, k)
    out = K._merge_outputs(q, k, dev, single)
    nbytes = K._merge_scratch_bytes(p, q, k)
    scratch = (torch.empty(nbytes, dtype=torch.uint8, device=dev)
               if nbytes else None)
    launch = K._merge_launch_fn()
    stream = torch.cuda.current_stream(dev).cuda_stream

    def c_call():
        err = launch(p, q, k, (ctypes.c_longlong * len(ptrs))(*ptrs),
                     None if scratch is None else scratch.data_ptr(),
                     *(t.data_ptr() for t in out), stream)
        assert err == 0, err

    return {"checks": host_us(torch, lambda: K._part_ptrs(parts, k)),
            "outputs": host_us(
                torch, lambda: K._merge_outputs(q, k, dev, single)),
            "c_launch": host_us(torch, c_call),
            "wrapper": host_us(torch, lambda: K.knn_merge_parts(parts, k)),
            "old_stacks": host_us(torch, lambda: [
                torch.stack([getattr(r, f) for r in parts])
                for f in K.KnnResult._fields])}


def k3_cases(torch, timer, card, lib, seed) -> list:
    """K3 old/new at chip_smoke's K3 cases."""
    from spatialflink_tpu_torch.ops import knn as K

    rows = []
    for name, p, q, k, args in CS.k3_inputs(torch, seed):
        parts = [K.KnnResult(*(t[i] for t in args)) for i in range(p)]

        def old(parts=parts, k=k):
            return old_merge(torch, lib, parts, k)

        def new(parts=parts, k=k):
            return K.knn_merge_parts(parts, k)

        extra = dict(panes=p, queries=q, k=k,
                     new_launch_to_completion_ms=CS.launch_ms(torch, new),
                     new_host_us=k3_host_split(torch, parts, k))
        if k > 1024:  # the old kernel refuses it
            CS.compare(torch, new(), K.merge_topk_stacked_plain(*args, k),
                       f"K3 {name}")
            n = [timer.ms(new) for _ in range(2 * ROUNDS)]
            row = {"case": f"K3 {name}", **extra, "old": "refuses k > 1024",
                   "new_ms": n, "new_median_ms": float(np.median(n)),
                   "identical_to_plain": True,
                   "new_kernels_us": kernel_split(torch, new), "card": card}
            print("ab", json.dumps(row), flush=True)
            rows.append(row)
            continue
        extra["old_launch_to_completion_ms"] = CS.launch_ms(torch, old)
        rows.append(ab_case(torch, timer, card, f"K3 {name}", old, new,
                            split_old=True, **extra))
    return rows


#: rows wider than one block of k <= 512, where K3 may take its survivor
#: reduce: (name, panes, queries, k, id pool, distances, valid share) as in
#: chip_smoke.K3_CASES
K3_WIDE_CASES = [
    ("21-panes", 21, 2, 50, CS.N_IDS, None, 0.9),
    ("60-panes", 60, 1, 100, CS.N_IDS, None, 1.0),
    ("60-panes-16q", 60, CS.N_QUERIES, 100, CS.N_IDS, None, 1.0),
    ("300-panes", 300, 1, 100, CS.N_IDS, None, 1.0),
    ("16x512", 16, 1, 512, CS.N_IDS, None, 1.0),
    ("32x512", 32, 1, 512, CS.N_IDS, None, 1.0),
    ("300x512", 300, 1, 512, CS.N_IDS, None, 1.0),
]
#: the variants of knn_merge.cu's ``reduces``: (name, line replaced, its
#: replacement)
K3_VARIANTS = (
    ("sort", "bool reduces(long long n, int k) {",
     "bool reduces(long long n, int k) {\n  return false;"),
    ("reduce", "  return levels <= kReduceLevels;", "  return true;"),
)


def build_k3_variants() -> dict:
    """The checkout's knn_merge.cu built twice (one nvcc each, in
    parallel): every row wider than one block through the sort across
    blocks, and every such row of 2k <= 1,024 through the survivor reduce,
    whatever its levels."""
    from spatialflink_tpu_torch.ops import knn as K
    from spatialflink_tpu_torch.ops import native

    src = os.path.join(CS.ROOT, "spatialflink_tpu_torch", "csrc")
    with open(os.path.join(src, "knn_merge.cu")) as f:
        text = f.read()
    with open(os.path.join(src, "topk_merge.cuh")) as f:
        header = f.read()
    procs = {}
    for name, line, repl in K3_VARIANTS:
        if line not in text:
            raise RuntimeError(f"knn_merge.cu: {line!r} not found")
        out_dir = os.path.join(BUILD, f"k3_{name}")
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "knn_merge.cu"), "w") as f:
            f.write(text.replace(line, repl))
        with open(os.path.join(out_dir, "topk_merge.cuh"), "w") as f:
            f.write(header)
        so = os.path.join(out_dir, f"libk3_{name}.so")
        procs[name] = (subprocess.Popen(
            [native.nvcc_path(), *native.NVCC_FLAGS, "-o", so,
             os.path.join(out_dir, "knn_merge.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {name} variant:\n{log}")
        lib = ctypes.CDLL(so)
        lib.knn_merge_launch.argtypes = list(K._MERGE_ARGTYPES)
        lib.knn_merge_scratch_bytes.argtypes = [ctypes.c_int] * 3
        lib.knn_merge_scratch_bytes.restype = ctypes.c_longlong
        libs[name] = lib
    return libs


def k3_variant_call(torch, lib, parts, k):
    """``knn_merge_parts``' host steps over a variant's library."""
    from spatialflink_tpu_torch.ops import knn as K
    from spatialflink_tpu_torch.ops import native

    p = len(parts)
    ptrs, q, dev = K._part_ptrs(parts, k)
    out = K._merge_outputs(q, k, dev, False)
    scratch = torch.empty(lib.knn_merge_scratch_bytes(p, q, k),
                          dtype=torch.uint8, device=dev)
    native.check(lib.knn_merge_launch(
        p, q, k, (ctypes.c_longlong * len(ptrs))(*ptrs), scratch.data_ptr(),
        *(t.data_ptr() for t in out),
        torch.cuda.current_stream(dev).cuda_stream), "knn_merge variant")
    return out


def k3_wide_cases(torch, timer, card, seed) -> list:
    """K3's two paths for rows wider than one block at K3_WIDE_CASES, the
    sort across blocks (old side) against the survivor reduce (new side),
    each forced by a variant of the checkout's source, through the same
    host steps; beside them the port's own ``knn_merge_parts``, which
    takes the reduce only within its level cap."""
    from spatialflink_tpu_torch.ops import knn as K

    libs = build_k3_variants()
    rows = []
    for name, p, q, k, args in CS.k3_inputs(torch, seed, K3_WIDE_CASES):
        parts = [K.KnnResult(*(t[i] for t in args)) for i in range(p)]

        def sort(parts=parts, k=k):
            return k3_variant_call(torch, libs["sort"], parts, k)

        def reduce(parts=parts, k=k):
            return k3_variant_call(torch, libs["reduce"], parts, k)

        def port(parts=parts, k=k):
            return K.knn_merge_parts(parts, k)

        CS.compare(torch, port(), K.merge_topk_stacked_plain(*args, k),
                   f"K3 wide {name}")
        CS.compare(torch, reduce(), port(), f"K3 wide {name}")
        rows.append(ab_case(
            torch, timer, card, f"K3 wide {name}", sort, reduce,
            split_old=True, panes=p, queries=q, k=k,
            old_path="sort across blocks", new_path="survivor reduce",
            port_ms=[timer.ms(port) for _ in range(2 * ROUNDS)],
            old_launch_to_completion_ms=CS.launch_ms(torch, sort),
            new_launch_to_completion_ms=CS.launch_ms(torch, reduce),
            port_launch_to_completion_ms=CS.launch_ms(torch, port)))
    return rows


def join_cases(torch, timer, card, libs, which) -> list:
    """K7 and K6 old/new at chip_smoke's join kernel cases."""
    from spatialflink_tpu_torch.ops import join as J

    grid = CS._grid()
    n = grid.n
    cx, cy = J.grid_center(grid)
    rows = []
    for s in CS.join_setups(torch, grid):
        key = "k7" if s["kernel"] == "join_reduce" else "k6"
        if key not in which:
            continue
        new, _, ops, nbytes, extra = CS.join_calls(torch, grid, s)
        a, b, r, lay = s["a"], s["b"], s["radius"], s["layers"]
        if key == "k7":
            def old(a=a, b=b, r=r, lay=lay):
                return old_reduce(torch, libs["join_reduce"], a, b, r, lay,
                                  n)
        else:
            def old(a=a, b=b, r=r, lay=lay, rw=s["rows"]):
                return old_lattice(torch, libs["join_lattice"], a, b, r, lay,
                                   cx, cy, n, rw)
        bound, by = CS.bound_ms(ops, nbytes)
        # ab_case's "pairs" counts its timed pairs
        extra["join_pairs"] = extra.pop("pairs", None)
        rows.append(ab_case(
            torch, timer, card, f"{key.upper()} {s['name']}", old, new,
            split_old=True, bound_ms=bound, bound_by=by,
            old_launch_to_completion_ms=CS.launch_ms(torch, old),
            new_launch_to_completion_ms=CS.launch_ms(torch, new), **extra))
        del new, old
        torch.cuda.empty_cache()
    return rows


def kernel_split(torch, fn, reps: int = 5) -> dict:
    """Device microseconds per call of each kernel ``fn`` launches, from a
    torch.profiler trace of ``reps`` calls (memsets included)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(ev, "device_time_total", None)
        us = ev.cuda_time_total if us is None else us
        out[ev.name[:60]] = out.get(ev.name[:60], 0.0) + us / reps
    return out


def ab_case(torch, timer, card, name, old, new, split_old=False, **extra):
    """Old and new equal bit for bit, then timed in ROUNDS rounds of old,
    new, new, old: 2 x ROUNDS (old, new) pairs, each side first in half."""
    got_old, got_new = old(), new()
    torch.cuda.synchronize()
    CS.compare(torch, got_new, got_old, f"A/B {name}")
    o, n = [], []
    for _ in range(ROUNDS):
        t = [timer.ms(old), timer.ms(new), timer.ms(new), timer.ms(old)]
        o += [t[0], t[3]]
        n += [t[1], t[2]]
    q1, q3 = np.percentile(o, [25, 75])
    row = {"case": name, **extra, "old_ms": o, "new_ms": n,
           "old_median_ms": float(np.median(o)),
           "new_median_ms": float(np.median(n)),
           "speedup": float(np.median(o) / np.median(n)),
           "new_wins": sum(b < a for a, b in zip(o, n)), "pairs": len(o),
           "old_iqr_ms": float(q3 - q1),
           # A/A: each side's first run of a round against its second
           "aa_old": float(np.median(o[0::2]) / np.median(o[1::2])),
           "aa_new": float(np.median(n[0::2]) / np.median(n[1::2])),
           "identical": True, "new_kernels_us": kernel_split(torch, new),
           "card": card}
    if split_old:
        row["old_kernels_us"] = kernel_split(torch, old)
    print("ab", json.dumps(row), flush=True)
    return row


def k1_cases(torch, timer, card, lib, b, grid, pts, polys, lattice_rows):
    """K1 old/new at the main path's shapes."""
    from spatialflink_tpu_torch.ops import range as R

    dev = torch.device("cuda")
    r = 0.5
    layers = dict(n=grid.n, gn_layers=grid.guaranteed_layers(r),
                  cn_layers=grid.candidate_layers(r))
    q = [torch.tensor([getattr(p, a) for p in pts], dtype=dt, device=dev)
         for a, dt in (("x", torch.float32), ("y", torch.float32),
                       ("cell", torch.int32))]
    one = dict(mode=R.MODE_POINT, approximate=False, radius=r, qx=pts[0].x,
               qy=pts[0].y, q_cell=pts[0].cell, **layers)
    many = dict(mode=R.MODE_POINT, approximate=False, radius=r, qxs=q[0],
                qys=q[1], q_cells=q[2], **layers)
    gn = torch.from_numpy(np.stack([grid.guaranteed_cells_mask(
        r, sorted(p.cells)) for p in polys])).to(dev)
    cn = torch.from_numpy(np.stack([grid.candidate_cells_mask(
        r, sorted(p.cells)) for p in polys])).to(dev)
    masks = dict(mode=R.MODE_MASKS, approximate=False, radius=r, gn_mask=gn,
                 cn_mask=cn, dists=lattice_rows)
    mask1 = dict(masks, gn_mask=gn[0], cn_mask=cn[0], dists=lattice_rows[0])
    mask8 = dict(masks, gn_mask=gn[:8].contiguous(),
                 cn_mask=cn[:8].contiguous(),
                 dists=lattice_rows[:8].contiguous())
    rows = []
    for name, kw, dists in (("point-q1-dists", one, True),
                            ("point-q1", one, False),
                            ("point-q16", many, False),
                            ("masks-q1", mask1, False),
                            ("masks-q8", mask8, False),
                            ("masks-q16", masks, False)):
        rows.append(ab_case(
            torch, timer, card, f"K1 {name}",
            lambda kw=kw, d=dists: old_range(torch, lib, b, with_dists=d,
                                             **kw),
            lambda kw=kw, d=dists: new_range(R, b, with_dists=d, **kw),
            split_old=True))
    return rows


def k4_cases(torch, timer, card, lib, b, grid):
    """K4 old (dense) / new (per-cell table where one applies)."""
    from spatialflink_tpu_torch.models import Polygon, single_query_edges
    from spatialflink_tpu_torch.ops import hopper_kernels as HK

    dev = torch.device("cuda")
    rows = []
    for name, rg, table in (("64-edges-table", CS.ring(64, 0.35), True),
                            ("64-edges-dense", CS.ring(64, 0.35), False),
                            ("128-edges-table", CS.ring(128, 0.4), True),
                            ("256-edges-table", CS.ring(256, 0.4), True),
                            ("512-edges-table", CS.ring(512, 0.4), True),
                            ("1301-edges", CS.ring(1301, 0.45), True)):
        e, m = (torch.from_numpy(a).to(dev) for a in single_query_edges(
            Polygon.create([rg], grid)))
        t = HK.pip_table(e, m, True, grid if table else None)
        kw = dict(cell=b.cell, table=t) if t.bits is not None else {}
        rows.append(ab_case(
            torch, timer, card, f"K4 {name}",
            lambda t=t: (old_pip(torch, lib, b.x, b.y, t.edges, t.edge_mask,
                                 True),),
            lambda t=t, kw=kw: (HK.pip_dist(b.x, b.y, t.edges, t.edge_mask,
                                            True, **kw),),
            table=t.bits is not None,
            fold=HK.pip_table_fold_share(b.cell, t)))
    return rows


def k4_grid_cases(torch, timer, card, lib, x, y):
    """K4 on grids coarser than the conf's: old (dense) / new at 10 x 10,
    then the table form forced against the dense fold (both new) over a
    sweep of grids and geometries, with the table's mean listed share per
    cell."""
    from spatialflink_tpu_torch.index import UniformGrid
    from spatialflink_tpu_torch.models import (LineString, PointBatch,
                                                Polygon, single_query_edges)
    from spatialflink_tpu_torch.ops import hopper_kernels as HK

    dev = torch.device("cuda")
    rows = []
    for cells in (10, 2, 5, 25, 50, 100):
        grid = UniformGrid(CS.BBOX[0], CS.BBOX[2], CS.BBOX[1], CS.BBOX[3],
                           num_grid_partitions=cells)
        b = PointBatch.from_arrays(x, y, device=dev, grid=grid)
        geoms = {"linestring-2": LineString.create(
            [(116.2, 40.2), (117.0, 40.2), (117.0, 40.9)], grid)}
        for k, r in ((8, 0.35), (16, 0.35), (32, 0.35), (64, 0.35),
                     (512, 0.4)):
            geoms[f"{k}-edges"] = Polygon.create([CS.ring(k, r)], grid)
        for name, g in geoms.items():
            areal = isinstance(g, Polygon)
            e, m = (torch.from_numpy(a).to(dev)
                    for a in single_query_edges(g))
            t = HK.pip_table(e, m, areal, grid)
            forced = HK.pip_table(e, m, areal, grid, gate=False)
            share = HK.pip_table_listed_share(forced)
            fold = HK.pip_table_fold_share(b.cell, forced)

            def table(t=forced, a=areal):
                return (HK.pip_dist(b.x, b.y, t.edges, t.edge_mask, a,
                                    cell=b.cell, table=t),)

            def dense(t=forced, a=areal):
                return (HK.pip_dist(b.x, b.y, t.edges, t.edge_mask, a),)

            if cells == 10 and name in ("64-edges", "512-edges"):
                kw = dict(cell=b.cell, table=t) if t.bits is not None else {}
                rows.append(ab_case(
                    torch, timer, card, f"K4 {name} grid {cells}",
                    lambda t=t: (old_pip(torch, lib, b.x, b.y, t.edges,
                                         t.edge_mask, True),),
                    lambda t=t, kw=kw: (HK.pip_dist(
                        b.x, b.y, t.edges, t.edge_mask, True, **kw),),
                    table=t.bits is not None, listed_share=share,
                    fold=fold))
            CS.compare(torch, table(), dense(), f"K4 sweep {cells} {name}")
            ms = [timer.ms(table), timer.ms(dense), timer.ms(dense),
                  timer.ms(table)]
            row = {"case": f"K4 sweep {name} grid {cells}",
                   "listed_share": share, "fold": fold,
                   "table_ms": float(np.median(ms[::3])),
                   "dense_ms": float(np.median(ms[1:3])),
                   "table_kept": t.bits is not None, "card": card}
            print("ab", json.dumps(row), flush=True)
            rows.append(row)
    return rows


def k5_cases(torch, timer, card, lib, seed):
    """K5 old/new at chip_smoke's K5 cases (a window of its polygon and
    linestring streams, a micro-batch), with launch-to-completion times of
    both sides at the micro-batch."""
    from spatialflink_tpu_torch.ops import geom as G

    t0 = time.perf_counter()
    streams = {}
    for i, kind in enumerate(("Polygon", "LineString")):
        lines = CS.geom_stream_lines(seed + 5 + i, CS.N_GEOM, kind)
        streams[kind], _ = CS.decode_geoms(lines[:CS.WINDOW_GEOMS], kind)
    print(f"K5 streams parsed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    setups, _ = CS.k5_setups(torch, streams["Polygon"],
                             streams["LineString"])
    rows = []
    for name, gb, args, _kind, _reps, n_queries in setups:
        def old(gb=gb, args=args):
            return old_geom(G, lib.geom_dist_launch, gb, args)

        def new(gb=gb, args=args):
            return G.geom_stream_dist(gb, **args)

        extra = dict(queries=n_queries, edges_padded=int(gb.edges.shape[1]),
                     consulted=int(torch.isfinite(new()[1]).sum()))
        if name.startswith("micro-"):
            extra["old_launch_to_completion_ms"] = CS.launch_ms(torch, old)
            extra["new_launch_to_completion_ms"] = CS.launch_ms(torch, new)
        rows.append(ab_case(torch, timer, card, f"K5 {name}", old, new,
                            split_old=True, **extra))
    return rows


def old_tstats_update(torch, lib, state, batch):
    """Commit 9f063e8's ``tstats_update`` wrapper over its ``traj.cu``:
    the same checks, six output allocations, the scratch size and the
    launch looked up on every call."""
    from spatialflink_tpu_torch.ops import trajectory as T

    dev = T._check_batch("tstats_update", batch)
    m = state.last_x.shape[0]
    for name, dt in (("last_x", torch.float32), ("last_y", torch.float32),
                     ("last_ts", torch.int32), ("spatial", torch.float32),
                     ("temporal", torch.float32)):
        t = getattr(state, name)
        if t.device != dev or t.dtype != dt or tuple(t.shape) != (m,) \
                or not t.is_contiguous():
            raise ValueError(f"state.{name}")
    n = batch.x.shape[0]
    out_oid = torch.empty(n, dtype=torch.int32, device=dev)
    out_sp = torch.empty(n, dtype=torch.float32, device=dev)
    out_tm = torch.empty_like(out_sp)
    out_speed = torch.empty_like(out_sp)
    out_emit = torch.empty(n, dtype=torch.bool, device=dev)
    order = torch.empty(n, dtype=torch.int32, device=dev)
    size_fn = lib.traj_scratch_bytes
    size_fn.argtypes, size_fn.restype = [_I], ctypes.c_longlong
    scratch = torch.empty(int(size_fn(n)), dtype=torch.uint8, device=dev)
    launch = lib.tstats_update_launch
    launch.argtypes, launch.restype = [_C] * 5 + [_I, _I] + [_C] * 13, _I
    with torch.cuda.device(dev):
        err = launch(batch.x.data_ptr(), batch.y.data_ptr(),
                     batch.obj_id.data_ptr(), batch.ts.data_ptr(),
                     batch.valid.data_ptr(), n, m, state.last_x.data_ptr(),
                     state.last_y.data_ptr(), state.last_ts.data_ptr(),
                     state.spatial.data_ptr(), state.temporal.data_ptr(),
                     out_oid.data_ptr(), out_sp.data_ptr(), out_tm.data_ptr(),
                     out_speed.data_ptr(), out_emit.data_ptr(),
                     order.data_ptr(), scratch.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
    assert err == 0, err
    return state, T.TStatsOut(obj_id=out_oid, spatial=out_sp,
                              temporal=out_tm, speed=out_speed,
                              emit=out_emit, order=order)


def old_group_extents(torch, lib, batch, num_cells, num_ids):
    """Commit 9f063e8's ``taggregate_group_extents`` wrapper over its
    ``traj.cu``."""
    from spatialflink_tpu_torch.ops import trajectory as T

    dev = T._check_batch("taggregate_group_extents", batch)
    n = batch.x.shape[0]
    oid_bits = max(1, int(num_ids - 1).bit_length()) if num_ids > 1 else 1
    i32 = dict(dtype=torch.int32, device=dev)
    out = T.TAggregateExtents(cell=torch.empty(n, **i32),
                              obj_id=torch.empty(n, **i32),
                              min_ts=torch.empty(n, **i32),
                              max_ts=torch.empty(n, **i32),
                              first=torch.empty(n, dtype=torch.bool,
                                                device=dev))
    size_fn = lib.traj_scratch_bytes
    size_fn.argtypes, size_fn.restype = [_I], ctypes.c_longlong
    scratch = torch.empty(int(size_fn(n)), dtype=torch.uint8, device=dev)
    launch = lib.taggregate_extents_launch
    launch.argtypes, launch.restype = [_C] * 4 + [_I, _I, _I] + [_C] * 7, _I
    with torch.cuda.device(dev):
        err = launch(batch.cell.data_ptr(), batch.obj_id.data_ptr(),
                     batch.ts.data_ptr(), batch.valid.data_ptr(), n,
                     int(num_cells), oid_bits,
                     *(t.data_ptr() for t in out), scratch.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
    assert err == 0, err
    return out


def k8_keys(torch, b, kind, *, m=None, ts_range=None, num_cells=None,
            num_ids=None):
    """The new layout's packed sort keys of batch ``b`` as int64 (K8a: the
    object or m above ts - lo; K8c: the cell or num_cells above the id)."""
    from spatialflink_tpu_torch.ops import trajectory as T

    if kind == "k8a":
        ts_bits, _ = T.tstats_layout(b.x.shape[0], m, *ts_range)
        hi = torch.where(b.valid, b.obj_id.long(), m)
        return (hi << ts_bits) | (b.ts.long() - ts_range[0])
    ok = b.valid & (b.cell >= 0)
    hi = torch.where(ok, b.cell.long().clamp(max=num_cells), num_cells)
    return (hi << T._oid_bits(num_ids)) | torch.where(ok, b.obj_id.long(), 0)


def k8_cases(torch, timer, card, lib, seed) -> list:
    """K8a and K8c old/new over chip_smoke's trajectory stream, then the
    new kernels' one-block path against their tiled one."""
    from spatialflink_tpu_torch.models import PointBatch
    from spatialflink_tpu_torch.ops import trajectory as T

    dev = torch.device("cuda")
    grid = CS._grid()
    _, _, (x, y, ts, traj) = CS.traj_stream(seed)
    m, ids, cells = CS.TRAJ_STATE, CS.N_TAXIS, grid.num_cells

    def batch(sel, ts_base, skew=False):
        oid = traj[sel].copy()
        if skew:
            oid[np.random.default_rng(seed).random(oid.shape[0]) < 0.75] = 0
        return (PointBatch.from_arrays(x[sel], y[sel], device=dev, grid=grid,
                                       obj_id=oid, ts=ts[sel],
                                       ts_base=ts_base),
                PointBatch.ts_range(ts[sel], ts_base))

    window = np.nonzero((ts >= CS.T0) & (ts < CS.T0 + 10_000))[0]
    pane = np.nonzero((ts >= CS.T0) & (ts < CS.T0 + 5_000))[0]
    cut = np.arange(64 * CS.N_MICRO, 65 * CS.N_MICRO)
    cut_base = int(ts[cut[0]])
    carried = T.TrajStatsState.zeros(m, dev)
    for c in range(64):
        idx = np.arange(c * CS.N_MICRO, (c + 1) * CS.N_MICRO)
        carried, _ = T.tstats_update_plain(carried, batch(idx, cut_base)[0])

    def clone(st):
        return T.TrajStatsState(*(t.clone() for t in st))

    rows = []

    def k8a(name, sel, base, state0, skew=False):
        b, rng_ts = batch(sel, base, skew)
        # each side updates its own copy in place as it is timed (the sort
        # and the walk do the same work whatever the state holds)
        work_old, work_new = clone(state0), clone(state0)

        def old(b=b):
            return old_tstats_update(torch, lib, work_old, b)[1]

        def new(b=b, rng_ts=rng_ts):
            return T.tstats_update(work_new, b, ts_range=rng_ts)[1]

        # equality on fresh copies of the state, outputs and state both
        so, go = old_tstats_update(torch, lib, clone(state0), b)
        sn, gn = T.tstats_update(clone(state0), b, ts_range=rng_ts)
        torch.cuda.synchronize()
        CS.compare(torch, (*gn, *sn), (*go, *so), f"K8a {name} state")
        keys = k8_keys(torch, b, "k8a", m=m, ts_range=rng_ts)
        _, lay = T.tstats_layout(b.x.shape[0], m, *rng_ts)
        rows.append(ab_case(
            torch, timer, card, f"K8a {name}", old, new, split_old=True,
            points=int(b.valid.sum()), slots=b.x.shape[0],
            key_bits=lay.bits, passes=lay.passes, launches=lay.launches,
            torch_sort_ms=timer.ms(lambda: torch.sort(keys, stable=True)),
            old_launch_to_completion_ms=CS.launch_ms(torch, old),
            new_launch_to_completion_ms=CS.launch_ms(torch, new),
            old_host_us=host_us(torch, old, 100),
            new_host_us=host_us(torch, new, 100)))

    def k8c(name, sel, base, skew=False):
        b, _ = batch(sel, base, skew)

        def old(b=b):
            return old_group_extents(torch, lib, b, cells, ids)

        def new(b=b):
            return T.taggregate_group_extents(b, num_cells=cells,
                                              num_ids=ids)

        keys = k8_keys(torch, b, "k8c", num_cells=cells, num_ids=ids)
        lay = T.extents_layout(b.x.shape[0], cells, T._oid_bits(ids))
        rows.append(ab_case(
            torch, timer, card, f"K8c {name}", old, new, split_old=True,
            points=int(b.valid.sum()), slots=b.x.shape[0],
            key_bits=lay.bits, passes=lay.passes, launches=lay.launches,
            torch_sort_ms=timer.ms(lambda: torch.sort(keys, stable=True)),
            old_launch_to_completion_ms=CS.launch_ms(torch, old),
            new_launch_to_completion_ms=CS.launch_ms(torch, new),
            old_host_us=host_us(torch, old, 100),
            new_host_us=host_us(torch, new, 100)))

    fresh = T.TrajStatsState.zeros(m, dev)
    k8a("window", window, CS.T0, fresh)
    k8a("cut", cut, cut_base, carried)
    k8a("skewed window", window, CS.T0, fresh, skew=True)
    k8c("window", window, CS.T0)
    k8c("pane", pane, CS.T0)
    k8c("cut", cut, cut_base)
    k8c("skewed window", window, CS.T0, skew=True)

    # the one-block path ("new") against the tiled one ("old"), both new
    for n in (512, 1024, 2048, 4096):
        sel = np.arange(64 * CS.N_MICRO, 64 * CS.N_MICRO + n)
        b, rng_ts = batch(sel, cut_base)
        works = {0: clone(carried), T.ONE_BLOCK_MAX: clone(carried)}

        def path(limit, fn):
            def call():
                saved, T.ONE_BLOCK_MAX = T.ONE_BLOCK_MAX, limit
                try:
                    return fn(works[limit])
                finally:
                    T.ONE_BLOCK_MAX = saved
            return call

        for kind, fn in (
                ("K8a", lambda work, b=b, r=rng_ts: T.tstats_update(
                    work, b, ts_range=r)[1]),
                ("K8c", lambda _, b=b: T.taggregate_group_extents(
                    b, num_cells=cells, num_ids=ids))):
            tiled, one = path(0, fn), path(T.ONE_BLOCK_MAX, fn)
            rows.append(ab_case(
                torch, timer, card, f"{kind} paths n={n}", tiled, one,
                old_is="tiled", new_is="one block", points=n,
                old_launch_to_completion_ms=CS.launch_ms(torch, tiled),
                new_launch_to_completion_ms=CS.launch_ms(torch, one)))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", default=None,
                    help="the earlier revision's csrc directory")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", default="k1,k4,k5",
                    help="comma-separated kernels to compare: k1, k2, k3, "
                    "k3wide (K3's two wide-row paths, both of the checkout; "
                    "needs no --old), k4 (with the table sweep), k5, k6, k7, "
                    "k8 (K8a and K8c)")
    args = ap.parse_args(argv)
    which = set(args.kernels.split(","))
    known = {"k1", "k2", "k3", "k3wide", "k4", "k5", "k6", "k7", "k8"}
    if not which <= known:
        ap.error(f"--kernels: unknown {sorted(which - known)}")
    if args.old is None and which - {"k3wide"}:
        ap.error("--old is needed for every kernel but k3wide")

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 2
    from spatialflink_tpu_torch.ops import native

    card = CS.card_line()
    print(f"card: {card}", flush=True)
    native.build(("pip_lattice", "cell_order", "pip_dist", "range_mask",
                  "geom_dist", "join_reduce", "join_lattice", "knn_topk",
                  "knn_merge", "traj"))
    libs = build_old(args.old, [name for key, name in (
        ("k1", "range_mask"), ("k2", "knn_topk"), ("k3", "knn_merge"),
        ("k4", "pip_dist"),
        ("k5", "geom_dist"), ("k6", "join_lattice"), ("k7", "join_reduce"),
        ("k8", "traj")) if key in which])
    for name in ("geom_dist", "join_reduce", "join_lattice", "cell_order",
                 "knn_merge", "traj"):
        print(f"new-build {name}", json.dumps(native.ptxas_report(
            native.build_log(name))), flush=True)
    timer = CS.Timer(torch)
    rows = []
    if "k8" in which:
        rows += k8_cases(torch, timer, card, libs["traj"], args.seed)
    if "k3" in which:
        rows += k3_cases(torch, timer, card, libs["knn_merge"], args.seed)
    if "k3wide" in which:
        rows += k3_wide_cases(torch, timer, card, args.seed)
    if which & {"k6", "k7"}:
        rows += join_cases(torch, timer, card, libs, which)
    if "k5" in which:
        rows += k5_cases(torch, timer, card, libs["geom_dist"], args.seed)
    if which & {"k1", "k2", "k4"}:
        rows += point_cases(torch, timer, card, libs, which, args.seed)
    print(card, flush=True)
    print(json.dumps({"ab": rows, "card": card}), flush=True)
    return 0


def point_cases(torch, timer, card, libs, which, seed) -> list:
    """K1 and K4 old/new over one window of 1,048,576 points."""
    from spatialflink_tpu_torch.models import (EdgeGeomBatch, LineString,
                                                Point, PointBatch, Polygon)
    from spatialflink_tpu_torch.ops import hopper_kernels as HK

    grid = CS._grid()
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    x = rng.uniform(CS.BBOX[0], CS.BBOX[2], CS.N_KERNEL)
    y = rng.uniform(CS.BBOX[1], CS.BBOX[3], CS.N_KERNEL)
    b = PointBatch.from_arrays(x, y, device=dev, grid=grid)
    # mask mode's distance rows: K4x over the multiQuery runs' polygons
    polys = [Polygon.create([rg], grid) for rg in CS.query_polygons()]
    main = EdgeGeomBatch.from_objects(
        polys + [LineString.create([(116.2, 40.2), (117.0, 40.2),
                                    (117.0, 40.9)], grid)],
        device=dev, pad=len(polys) + 1)
    rows_k4x = HK.pip_lattice(b.x, b.y, main.edges, main.edge_mask,
                              main.is_areal, cell=b.cell,
                              num_cells=grid.num_cells)
    pts = [Point.create(px, py, grid) for px, py in CS.query_points()]
    rows = []
    if "k1" in which:
        rows += k1_cases(torch, timer, card, libs["range_mask"], b, grid,
                         pts, polys, rows_k4x[:len(polys)].contiguous())
    if "k2" in which:
        rows += k2_cases(torch, timer, card, libs["knn_topk"],
                         rows_k4x[:len(polys)].contiguous(), seed)
    if "k4" in which:
        rows += k4_cases(torch, timer, card, libs["pip_dist"], b, grid)
        rows += k4_grid_cases(torch, timer, card, libs["pip_dist"], x, y)
    return rows


if __name__ == "__main__":
    raise SystemExit(main())
