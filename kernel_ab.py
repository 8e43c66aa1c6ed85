#!/usr/bin/env python3
"""Times the port's K4x and K2 kernels against an earlier revision's, on
one card, in turns (old, new, new, old), at the main path's shapes.

Run from the root of a checkout on a machine with one NVIDIA card, with
the earlier revision's ``csrc/`` unpacked into a directory that
``.gitignore`` lists:

    git archive <commit> spatialflink_tpu_torch/csrc | tar -x -C _scratch/old
    python3 kernel_ab.py --old _scratch/old/spatialflink_tpu_torch/csrc

The old ``pip_lattice.cu`` (with its ``pip_edges.cuh``) and ``knn_topk.cu``
are built with the port's own nvcc flags into ``_scratch/ab_build`` and
called through their own C signatures: ``pip_lattice_launch(px, py, n,
edges, edge_mask, ne, is_areal, g, dist, stream)`` and
``knn_topk_launch(..., best, scratch_a, scratch_b, out_oid, out_dist,
out_valid, counts, stream)``. Every case first checks that old and new
give the same outputs bit for bit, then times old, new, new, old with
chip_smoke's timer (CUDA events, L2 evicted before each launch) and prints
one JSON line per case, the card's name and power limit beside it, and a
summary line last.

Cases: K4x at 1,048,576 points x (16 polygons of 64 edges + 1 linestring)
(the multiQuery runs' shape; new in cell order, as the main path calls
it, and in stream order) and at 65,536 points x 10,240 four-edge
rectangles (the Pallas experiment's shape); K2 at 1,048,576 points and
100,000 object ids in the main path's four modes: point k=50 with 1 and
16 queries, cell mode k=10 with 1 query (over K4 distances) and 16
queries (over K4x rows).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

import chip_smoke as CS

BUILD = os.path.join(CS.ROOT, "_scratch", "ab_build")


def build_old(old_csrc: str) -> dict:
    """Compile the old sources (one nvcc each, in parallel) and load them."""
    from spatialflink_tpu_torch.ops import native

    os.makedirs(BUILD, exist_ok=True)
    procs = {}
    for name in ("pip_lattice", "knn_topk"):
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
    C, I = ctypes.c_void_p, ctypes.c_int
    libs["pip_lattice"].pip_lattice_launch.argtypes = [C, C, I, C, C, I, C, I,
                                                       C, C]
    libs["knn_topk"].knn_topk_launch.argtypes = (
        [I] * 5 + [C] * 8 + [I, I, C, C, I] + [C] * 9)
    libs["knn_topk"].knn_topk_tiles.argtypes = [I]
    return libs


def old_lattice(torch, lib, px, py, gb):
    g, ne = gb.edges.shape[0], gb.edges.shape[1]
    dist = torch.empty((g, px.shape[0]), dtype=torch.float32, device="cuda")
    err = lib.pip_lattice_launch(
        px.data_ptr(), py.data_ptr(), px.shape[0], gb.edges.data_ptr(),
        gb.edge_mask.data_ptr(), ne, gb.is_areal.data_ptr(), g,
        dist.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"old pip_lattice: CUDA error {err}")
    return dist


def old_knn(torch, lib, obj_id, *, mode, k, num_ids, x=None, y=None,
            cell=None, valid=None, qx=None, qy=None, q_cell=None, n=1,
            nb_layers=-1, dists=None, nb_mask=None):
    Q = qx.shape[0] if qx is not None else dists.shape[0]
    tiles = lib.knn_topk_tiles(num_ids)
    best = torch.empty((Q, num_ids), dtype=torch.int32, device="cuda")
    scratch = torch.empty((2, Q, tiles * k), dtype=torch.int64,
                          device="cuda")
    oid = torch.empty((Q, k), dtype=torch.int32, device="cuda")
    dist = torch.empty((Q, k), dtype=torch.float32, device="cuda")
    ok = torch.empty((Q, k), dtype=torch.bool, device="cuda")
    counts = torch.empty(Q, dtype=torch.int32, device="cuda")

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.knn_topk_launch(
        mode, obj_id.shape[0], Q, num_ids, k, ptr(obj_id), ptr(x), ptr(y),
        ptr(cell), ptr(valid), ptr(qx), ptr(qy), ptr(q_cell), n, nb_layers,
        ptr(dists), ptr(nb_mask), 0 if nb_mask is None else nb_mask.shape[-1],
        None, best.data_ptr(), scratch[0].data_ptr(), scratch[1].data_ptr(),
        oid.data_ptr(), dist.data_ptr(), ok.data_ptr(), counts.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"old knn_topk: CUDA error {err}")
    return oid, dist, ok, counts


def skip_stats(torch, HK, sx, sy, gb, pts=4, seed_min=16):
    """The share of (warp, valid edge) pairs whose ray cast and whose
    distance fold K4x's cell-order variant runs, replayed with tensor ops:
    warps of 32 lanes x ``pts`` consecutive points of ``sx, sy`` (in cell
    order), each geometry folded seed edge first, then its valid edges in
    order, with the kernel's votes (any lane that may straddle the edge,
    any lane whose squared box bound does not exceed its largest min d2).
    The kernel's staging chunks are not replayed: it assumes each
    geometry's edges sit in one chunk, as at the main path's shape."""
    per_warp = 32 * pts
    W = sx.shape[0] // per_warp
    x = sx[:W * per_warp].reshape(W, 32, pts)
    y = sy[:W * per_warp].reshape(W, 32, pts)
    xlo, xhi, ylo, yhi = x.amin(2), x.amax(2), y.amin(2), y.amax(2)
    scale = HK.distance_skip_margin(1.0)
    m = torch.maximum(torch.maximum(xlo.abs(), xhi.abs()),
                      torch.maximum(ylo.abs(), yhi.abs())) * scale
    bylo, byhi = ylo - m, yhi + m
    ray_n = dist_n = total = 0
    for g in range(gb.edges.shape[0]):
        e = gb.edges[g][gb.edge_mask[g]]
        if e.shape[0] == 0:
            continue
        x1, y1, x2, y2 = e.unbind(1)
        cx, cy = x2 - x1, y2 - y1
        ls = cx * cx + cy * cy
        inv = torch.where(ls > 0, 1.0 / torch.where(ls > 0, ls, 1.0), 0.0)
        me = torch.maximum(torch.maximum(x1.abs(), x2.abs()),
                           torch.maximum(y1.abs(), y2.abs())) * scale
        eylo, eyhi = torch.minimum(y1, y2) - me, torch.maximum(y1, y2) + me
        mind2 = torch.full_like(x, 3.4e38)
        dmax = torch.full_like(xlo, 3.4e38)

        def gap2(j):
            return HK.distance_skip_bound(xlo, xhi, ylo, yhi, e[j])

        def fold(j, need, mind2):
            dot = (x - x1[j]) * cx[j] + (y - y1[j]) * cy[j]
            t = torch.clamp(dot * inv[j], 0, 1)
            dx = (x1[j] + t * cx[j]) - x
            dy = (y1[j] + t * cy[j]) - y
            return torch.where(need[:, None, None],
                               torch.minimum(mind2, dx * dx + dy * dy), mind2)

        if e.shape[0] >= seed_min:
            lane_min, lane_arg = torch.stack(
                [gap2(j) for j in range(e.shape[0])]).min(0)
            seed = lane_arg.gather(1, lane_min.argmin(1)[:, None])[:, 0]
            for j in seed.unique().tolist():
                mind2 = fold(j, seed == j, mind2)
            dmax = mind2.amax(2)
        for j in range(e.shape[0]):
            ray = (~((byhi < eylo[j]) | (bylo >= eyhi[j]))).any(1)
            dist = (~(gap2(j) > dmax)).any(1)
            ray_n += int(ray.sum())
            dist_n += int(dist.sum())
            total += W
            if bool(dist.any()):
                mind2 = fold(j, dist, mind2)
                dmax = mind2.amax(2)
    return {"warps": W, "warp_edges": total, "ray_share": ray_n / total,
            "dist_share": dist_n / total}


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


def ab_case(torch, timer, card, name, old, new, **extra):
    """Old and new equal bit for bit, then timed old, new, new, old."""
    got_old, got_new = old(), new()
    torch.cuda.synchronize()
    CS.compare(torch, got_new, got_old, f"A/B {name}")
    t = [timer.ms(old), timer.ms(new), timer.ms(new), timer.ms(old)]
    row = {"case": name, **extra, "old_ms": [t[0], t[3]],
           "new_ms": [t[1], t[2]], "old_median_ms": float(np.median(t[::3])),
           "new_median_ms": float(np.median(t[1:3])),
           "speedup": float(np.median(t[::3]) / np.median(t[1:3])),
           "identical": True, "new_kernels_us": kernel_split(torch, new),
           "card": card}
    print("ab", json.dumps(row), flush=True)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old", required=True,
                    help="the earlier revision's csrc directory")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device available", file=sys.stderr)
        return 2
    from spatialflink_tpu_torch.models import (EdgeGeomBatch, LineString,
                                                Point, PointBatch, Polygon,
                                                single_query_edges)
    from spatialflink_tpu_torch.ops import hopper_kernels as HK
    from spatialflink_tpu_torch.ops import knn as K
    from spatialflink_tpu_torch.ops import native

    card = CS.card_line()
    print(f"card: {card}", flush=True)
    native.build(("pip_lattice", "cell_order", "knn_topk", "pip_dist"))
    libs = build_old(args.old)
    timer = CS.Timer(torch)
    grid = CS._grid()
    dev = torch.device("cuda")
    rows = []

    # K4x at the multiQuery runs' shape
    rng = np.random.default_rng(args.seed)
    b = PointBatch.from_arrays(rng.uniform(CS.BBOX[0], CS.BBOX[2], CS.N_KERNEL),
                               rng.uniform(CS.BBOX[1], CS.BBOX[3], CS.N_KERNEL),
                               device=dev, grid=grid)
    polys = [Polygon.create([rg], grid) for rg in CS.query_polygons()]
    main = EdgeGeomBatch.from_objects(
        polys + [LineString.create([(116.2, 40.2), (117.0, 40.2),
                                    (117.0, 40.9)], grid)],
        device=dev, pad=len(polys) + 1)
    args_m = (b.x, b.y, main.edges, main.edge_mask, main.is_areal)
    rows.append(ab_case(
        torch, timer, card, "K4x 1048576x16polygons+1linestring cell order",
        lambda: (old_lattice(torch, libs["pip_lattice"], b.x, b.y, main),),
        lambda: (HK.pip_lattice(*args_m, cell=b.cell,
                                num_cells=grid.num_cells),)))
    rows.append(ab_case(
        torch, timer, card, "K4x 1048576x16polygons+1linestring stream order",
        lambda: (old_lattice(torch, libs["pip_lattice"], b.x, b.y, main),),
        lambda: (HK.pip_lattice(*args_m),)))
    order_ms = timer.ms(lambda: HK.cell_order(b.cell, grid.num_cells, b.x,
                                              b.y))
    # what the write-back through perm costs: the same launch on the sorted
    # points with perm = identity writes each row at neighbouring addresses
    perm, sx, sy = HK.cell_order(b.cell, grid.num_cells, b.x, b.y)
    ident = torch.arange(b.capacity, dtype=torch.int32, device=dev)
    launch = native.function("pip_lattice", "pip_lattice_launch",
                             HK._LATTICE_ARGTYPES)
    out = torch.empty((main.capacity, b.capacity), device=dev)

    def lattice_on_sorted(p):
        launch(sx.data_ptr(), sy.data_ptr(), p.data_ptr(), b.capacity,
               main.edges.data_ptr(), main.edge_mask.data_ptr(),
               main.edges.shape[1], main.is_areal.data_ptr(),
               main.capacity, HK.distance_skip_margin(1.0), out.data_ptr(),
               torch.cuda.current_stream().cuda_stream)

    scatter = [timer.ms(lambda: lattice_on_sorted(perm)),
               timer.ms(lambda: lattice_on_sorted(ident))]
    stats = skip_stats(torch, HK, sx, sy, main)
    print("ab", json.dumps({
        "case": "cell_order 1048576 points", "new_ms": order_ms,
        "lattice_sorted_perm_ms": scatter[0],
        "lattice_sorted_identity_ms": scatter[1],
        "scatter_cost_ms": scatter[0] - scatter[1], "skip": stats,
        "cell_order_kernels_us": kernel_split(
            torch, lambda: HK.cell_order(b.cell, grid.num_cells, b.x, b.y)),
        "card": card}), flush=True)

    # K4x at the experiment's shape
    rng = np.random.default_rng(3)
    rects = []
    for _ in range(10_240):
        cx = rng.uniform(CS.BBOX[0] + 0.1, CS.BBOX[2] - 0.1)
        cy = rng.uniform(CS.BBOX[1] + 0.1, CS.BBOX[3] - 0.1)
        w, h = rng.uniform(0.01, 0.05, 2)
        rects.append(Polygon.create(
            [[(cx - w, cy - h), (cx + w, cy - h), (cx + w, cy + h),
              (cx - w, cy + h), (cx - w, cy - h)]], grid))
    gb = EdgeGeomBatch.from_objects(rects, device=dev, pad=len(rects))
    pb = PointBatch.from_arrays(rng.uniform(CS.BBOX[0], CS.BBOX[2], 65_536),
                                rng.uniform(CS.BBOX[1], CS.BBOX[3], 65_536),
                                device=dev, grid=grid)
    args_x = (pb.x, pb.y, gb.edges, gb.edge_mask, gb.is_areal)
    rows.append(ab_case(
        torch, timer, card, "K4x 65536x10240rectangles stream order",
        lambda: (old_lattice(torch, libs["pip_lattice"], pb.x, pb.y, gb),),
        lambda: (HK.pip_lattice(*args_x),)))
    rows.append(ab_case(
        torch, timer, card, "K4x 65536x10240rectangles cell order",
        lambda: (old_lattice(torch, libs["pip_lattice"], pb.x, pb.y, gb),),
        lambda: (HK.pip_lattice(*args_x, cell=pb.cell,
                                num_cells=grid.num_cells),)))
    rows_k4x = HK.pip_lattice(*args_m, cell=b.cell, num_cells=grid.num_cells)
    del gb, pb, args_x
    torch.cuda.empty_cache()

    # K2 in the main path's four modes
    rng = np.random.default_rng(args.seed + 5)
    oid = torch.from_numpy(rng.integers(0, CS.N_IDS, CS.N_KERNEL)
                           .astype(np.int32)).to(dev)
    pts = [Point.create(x, y, grid) for x, y in CS.query_points()]
    q = [torch.tensor([getattr(p, a) for p in pts], dtype=dt, device=dev)
         for a, dt in (("x", torch.float32), ("y", torch.float32),
                       ("cell", torch.int32))]
    nb = torch.from_numpy(np.stack([grid.neighboring_cells_mask(
        0.5, sorted(p.cells)) for p in polys])).to(dev)
    d_k4 = HK.pip_dist(b.x, b.y, *(torch.from_numpy(a).to(dev) for a in
                                   single_query_edges(polys[0])), True)
    point = dict(mode=K.MODE_POINT, num_ids=CS.N_IDS, x=b.x, y=b.y,
                 cell=b.cell, valid=b.valid, n=grid.n,
                 nb_layers=grid.candidate_layers(0.5))
    specs = [
        ("point-k50-q1", 50, dict(point, qx=q[0][:1], qy=q[1][:1],
                                  q_cell=q[2][:1])),
        ("cells-k10-q1", 10, dict(mode=K.MODE_CELLS, num_ids=CS.N_IDS,
                                  cell=b.cell, valid=b.valid,
                                  dists=d_k4[None], nb_mask=nb[:1])),
        ("point-k50-q16", 50, dict(point, qx=q[0], qy=q[1], q_cell=q[2])),
        ("cells-k10-q16", 10, dict(mode=K.MODE_CELLS, num_ids=CS.N_IDS,
                                   cell=b.cell, valid=b.valid,
                                   dists=rows_k4x[:len(polys)].contiguous(),
                                   nb_mask=nb)),
    ]
    for name, k, kw in specs:
        rows.append(ab_case(
            torch, timer, card, f"K2 {name}",
            lambda kw=kw, k=k: old_knn(torch, libs["knn_topk"], oid, k=k,
                                       **kw),
            lambda kw=kw, k=k: K.knn_topk(oid, k=k, **kw)))
    print(card, flush=True)
    print(json.dumps({"ab": rows, "card": card}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
