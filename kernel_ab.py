#!/usr/bin/env python3
"""Times the port's K1, K4, K5, K6 and K7 kernels against an earlier
revision's, on one card, in turns (old, new, new, old), at the main path's
shapes.

Run from the root of a checkout on a machine with one NVIDIA card, with
the earlier revision's ``csrc/`` unpacked into a directory that
``.gitignore`` lists:

    git archive <commit> spatialflink_tpu_torch/csrc | tar -x -C _scratch/old
    python3 kernel_ab.py --old _scratch/old/spatialflink_tpu_torch/csrc \
        [--kernels k1,k4,k5,k6,k7]

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
call as that revision's wrappers did. Every case
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
shares it); each with both sides' launch-to-completion times.
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


def build_old(old_csrc: str, names) -> dict:
    """Compile the old sources (one nvcc each, in parallel) and load them."""
    from spatialflink_tpu_torch.ops import geom as G
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True,
                    help="the earlier revision's csrc directory")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kernels", default="k1,k4,k5",
                    help="comma-separated kernels to compare: k1, k4 (with "
                    "the table sweep), k5, k6, k7")
    args = ap.parse_args(argv)
    which = set(args.kernels.split(","))
    known = {"k1", "k4", "k5", "k6", "k7"}
    if not which <= known:
        ap.error(f"--kernels: unknown {sorted(which - known)}")

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 2
    from spatialflink_tpu_torch.ops import native

    card = CS.card_line()
    print(f"card: {card}", flush=True)
    native.build(("pip_lattice", "cell_order", "pip_dist", "range_mask",
                  "geom_dist", "join_reduce", "join_lattice"))
    libs = build_old(args.old, [name for key, name in (
        ("k1", "range_mask"), ("k4", "pip_dist"), ("k5", "geom_dist"),
        ("k6", "join_lattice"), ("k7", "join_reduce")) if key in which])
    for name in ("geom_dist", "join_reduce", "join_lattice", "cell_order"):
        print(f"new-build {name}", json.dumps(native.ptxas_report(
            native.build_log(name))), flush=True)
    timer = CS.Timer(torch)
    rows = []
    if which & {"k6", "k7"}:
        rows += join_cases(torch, timer, card, libs, which)
    if "k5" in which:
        rows += k5_cases(torch, timer, card, libs["geom_dist"], args.seed)
    if which & {"k1", "k4"}:
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
    if "k4" in which:
        rows += k4_cases(torch, timer, card, libs["pip_dist"], b, grid)
        rows += k4_grid_cases(torch, timer, card, libs["pip_dist"], x, y)
    return rows


if __name__ == "__main__":
    raise SystemExit(main())
