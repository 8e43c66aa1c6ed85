#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (spatialflink_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py [--seed 0]

Phases (each raises on failure; the script catches nothing; each prints
its wall seconds):

1. Device: the card's name and power limit; build the CUDA kernels from
   ``spatialflink_tpu_torch/csrc`` (one nvcc per source, all started
   together) and print the build time.
2. Kernels against their plain PyTorch versions on the card, bit for bit,
   at the main path's shapes (1,048,576 points over the conf's grid bbox):
   K4 ``pip_dist`` for a 64-edge polygon, a polygon with a hole, the
   conf's linestring, 1,301-, 512- and 513-edge polygons and the empty
   edge set; K1 ``range_mask_stats`` in point and cell-mask mode, exact
   and approximate, and with a query axis of 16 (each row also equal to
   the single-query launch); K4x ``pip_lattice`` for 16 query polygons of
   64 edges plus one linestring, and at the experiment's shape (65,536
   points x 10,240 four-edge rectangles, a 2.7 GB output); K2 ``knn_topk``
   with 100,000 object ids at k = 50 and k = 10: point mode, cell mode
   over K4 distances, 16 queries in both modes, ties at the k-th place,
   and nothing eligible. Times are CUDA-event medians of 25 launches
   queued behind a sleep kernel (so the host's launch cost is not timed),
   with the 50 MB L2 evicted before each; the bound is max(operations /
   67 TFLOP/s, bytes / 3.35 TB/s). Small inputs are also held against
   float64 numpy references (distances, range masks, kNN lists).
3. Main path: over a seeded 2,097,152-point CSV stream spanning 20 s (the
   conf's 10 s / 5 s sliding windows: full windows of 1,048,576 points),
   through ``driver.run_option`` on device="cuda": options 6, 1, 11, 51
   (k = 50), 56 and 61, then with multiQuery options 1 and 51 (16 query
   points), 6 and 56 (16 query polygons) and 11 (4 linestrings). The
   launch counters are zeroed before each run and read after it, and must
   be non-zero for every kernel of that run's path; each run is repeated
   with every kernel swapped for its plain version, and the per-window
   results must be equal (selections, and kNN (objID, distance) lists in
   order). Then options 6's and 51's stages (CSV decode, window assembly,
   batch build and copy, device ops, readback and selection) are timed one
   after another, option 51 runs once more under torch.profiler (device
   time by kind and the device's busy share), and the CLI runs options 6
   and 51 on a 65,536-row CSV.
4. Output: the card line, one JSON ``kernels`` line, and as the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero without a result line when CUDA is not available or the
package is not beside the script.
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CONF = os.path.join(ROOT, "conf", "spatialflink-conf.yml")
BBOX = (115.5, 39.6, 117.6, 41.1)  # the conf's gridBBox
N_KERNEL = 1 << 20                # points per kernel case (a full window)
N_STREAM = 1 << 21                # points in the main-path stream
N_CLI = 1 << 16                   # rows of the CLI's CSV
N_IDS = 100_000                   # distinct object ids in every stream
N_QUERIES = 16                    # query points / polygons under multiQuery
SPAN_MS = 20_000                  # event-time span of the stream
T0 = 1_700_000_000_000            # stream start, aligned to the 5 s slide
PEAK_FLOPS = 67e12                # H100 SXM f32, outside the tensor cores
PEAK_BYTES = 3.35e12              # H100 SXM HBM3
REPS = 25
SLEEP_CYCLES = 100_000_000        # ~50 ms hold while timed launches queue
NO_LIB = "no single PyTorch call computes this function"


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def ring(k: int, r: float, cx: float = 116.6, cy: float = 40.55,
         wobble: float = 0.1):
    """k vertices of a star-ish closed ring (radius modulated by 5 lobes)."""
    th = np.linspace(0.0, 2.0 * np.pi, k, endpoint=False)
    rr = r * (1.0 + wobble * np.sin(5.0 * th))
    pts = [(float(cx + a * np.cos(t)), float(cy + a * np.sin(t)))
           for a, t in zip(rr, th)]
    return pts + [pts[0]]


def query_points():
    """16 query points: the conf's first, then a seeded spread."""
    rng = np.random.default_rng(101)
    return [(116.5, 40.5)] + [
        (float(x), float(y)) for x, y in zip(
            rng.uniform(115.8, 117.3, N_QUERIES - 1),
            rng.uniform(39.8, 40.9, N_QUERIES - 1))]


def query_polygons():
    """16 query polygons of 64 edges: ring(64, 0.35) (the single-query
    runs' polygon), then smaller rings spread over the bbox."""
    rng = np.random.default_rng(102)
    return [ring(64, 0.35)] + [
        ring(64, float(r), float(x), float(y)) for x, y, r in zip(
            rng.uniform(115.8, 117.3, N_QUERIES - 1),
            rng.uniform(39.8, 40.9, N_QUERIES - 1),
            rng.uniform(0.05, 0.2, N_QUERIES - 1))]


def query_linestrings(conf_lines):
    """4 linestrings: the conf's, then three more."""
    return list(conf_lines) + [
        [(115.7, 39.8), (116.4, 40.3), (117.4, 40.1)],
        [(116.0, 41.0), (116.1, 40.0)],
        [(116.8, 40.2), (117.2, 40.6), (116.9, 41.0), (117.5, 40.9)]]


class Timer:
    """Device time of one call: CUDA events around each of ``reps``
    launches, queued behind a sleep kernel so that the host's launch cost
    overlaps the wait, with L2 evicted (a 128 MB write) before each
    launch."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(32 << 20, dtype=torch.float32,
                                 device="cuda")

    def ms(self, fn, reps: int = REPS) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        evs = [(torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        torch.cuda._sleep(SLEEP_CYCLES)
        for s, e in evs:
            self.flush.zero_()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in evs]))


def bound_ms(ops: float, nbytes: float):
    t_ops, t_bytes = ops / PEAK_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def compare(torch, got, want, what: str) -> float:
    """Bit-for-bit equality of two result tuples; returns the max abs
    difference over finite float entries (0.0 when equal)."""
    err = 0.0
    for g, w in zip(got, want):
        if g.dtype.is_floating_point:
            fin = torch.isfinite(g) & torch.isfinite(w)
            if fin.any():
                err = max(err, float((g - w)[fin].abs().max()))
        if not torch.equal(g, w):
            bad = int((g != w).sum()) if g.shape == w.shape else -1
            raise AssertionError(f"{what}: kernel != plain version "
                                 f"({bad} entries differ, max abs {err})")
    return err


def kernel_case(timer, torch, name, kern, plain, ops, nbytes, what,
                plain_reps=REPS, **extra):
    """Run, compare and time one kernel case against its plain version."""
    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = compare(torch, got, want, f"{what} {name}")
    b_ms, b_by = bound_ms(ops, nbytes)
    case = {"case": name, **extra, "identical": True, "max_abs_err": err,
            "ms": timer.ms(kern),
            "plain_ms": timer.ms(plain, reps=plain_reps),
            "bound_ms": b_ms, "bound_by": b_by}
    log(what, json.dumps(case))
    return case, got


def _grid():
    from spatialflink_tpu_torch.index import UniformGrid

    return UniformGrid(BBOX[0], BBOX[2], BBOX[1], BBOX[3],
                       num_grid_partitions=100)


# ------------------------------------------------------------------------ #
# phase 2: kernels against their plain versions


def kernel_phase(torch, seed: int, timer: Timer):
    """K4 and K1 with one query."""
    from spatialflink_tpu_torch.models import (LineString, PointBatch,
                                                Polygon, single_query_edges)
    from spatialflink_tpu_torch.ops import hopper_kernels as HK
    from spatialflink_tpu_torch.ops import range as R

    dev = torch.device("cuda")
    grid = _grid()
    rng = np.random.default_rng(seed)
    b = PointBatch.from_arrays(rng.uniform(BBOX[0], BBOX[2], N_KERNEL),
                               rng.uniform(BBOX[1], BBOX[3], N_KERNEL),
                               device=dev, grid=grid)
    torch.cuda.synchronize()
    n = b.capacity
    geoms = {
        "polygon-64": Polygon.create([ring(64, 0.35)], grid),
        "polygon-hole": Polygon.create(
            [ring(48, 0.5), ring(24, 0.2, wobble=0.0)], grid),
        "linestring": LineString.create(
            [(116.2, 40.2), (117.0, 40.2), (117.0, 40.9)], grid),
        "polygon-1301": Polygon.create([ring(1301, 0.45)], grid),
        "polygon-512": Polygon.create([ring(512, 0.4)], grid),
        "polygon-513": Polygon.create([ring(513, 0.4)], grid),
        "empty": None,
    }
    k4_cases = []
    dists64 = None
    for name, g in geoms.items():
        if g is None:
            e = torch.zeros((0, 4), dtype=torch.float32, device=dev)
            m = torch.zeros(0, dtype=torch.bool, device=dev)
            areal, n_valid = True, 0
        else:
            e_np, m_np = single_query_edges(g)
            e, m = torch.from_numpy(e_np).to(dev), torch.from_numpy(m_np).to(dev)
            areal, n_valid = isinstance(g, Polygon), int(m_np.sum())
        ep = HK.bucket_edges(e.shape[0])
        case, got = kernel_case(
            timer, torch, name,
            lambda e=e, m=m, a=areal: (HK.pip_dist(b.x, b.y, e, m, a),),
            lambda e=e, m=m, a=areal: (HK.pip_dist_plain(b.x, b.y, e, m, a),),
            n * n_valid * HK.OPS_PER_PAIR, n * 12 + ep * 17, "K4",
            edges=n_valid, edges_padded=ep)
        if got[0].shape != (n,) or bool(torch.isnan(got[0]).any()):
            raise AssertionError(f"pip_dist {name}: bad output")
        k4_cases.append(case)
        if name == "polygon-64":
            dists64 = got[0]
    if HK.pip_dist.launches <= 0:
        raise AssertionError("pip_dist launched no kernel")

    q = (116.5, 40.5)
    qc = int(grid.assign_cell(*q)[0])
    r = 0.5
    gl, cl = grid.guaranteed_layers(r), grid.candidate_layers(r)
    cells = sorted(geoms["polygon-64"].cells)
    gn = torch.from_numpy(grid.guaranteed_cells_mask(r, cells)).to(dev)
    cn = torch.from_numpy(grid.candidate_cells_mask(r, cells)).to(dev)
    k1_cases = []
    for mode in ("point", "masks"):
        for approx in (False, True):
            if mode == "point":
                def kern(a=approx):
                    return R.range_filter_point_stats(
                        b, q[0], q[1], qc, r, gl, cl, n=grid.n, approximate=a)

                def plain(a=approx):
                    return R.range_filter_point_stats_plain(
                        b, q[0], q[1], qc, r, gl, cl, n=grid.n, approximate=a)
                ops = n * R.OPS_PER_POINT[R.MODE_POINT]
                nbytes = n * (4 + 4 + 4 + 1) + n * (1 + 4) + 8
            else:
                def kern(a=approx):
                    return R.range_filter_masks_stats(b, gn, cn, dists64, r,
                                                      approximate=a)

                def plain(a=approx):
                    return R.range_filter_masks_stats_plain(
                        b, gn, cn, dists64, r, approximate=a)
                ops = n * R.OPS_PER_POINT[R.MODE_MASKS]
                nbytes = n * (4 + 1 + 4) + 2 * gn.numel() + n + 8
            case, got = kernel_case(
                timer, torch, f"{mode}-{'approx' if approx else 'exact'}",
                kern, plain, ops, nbytes, "K1")
            case["selected"] = int(got[0].sum())
            case["counts"] = [int(c) for c in got[-2:]]
            k1_cases.append(case)
    if R.range_mask_stats.launches <= 0:
        raise AssertionError("range_mask_stats launched no kernel")
    return k4_cases, k1_cases, b


def lattice_phase(torch, timer: Timer, b):
    """K4x at the main path's shape (the 16 query polygons of the
    multiQuery runs plus one linestring) and at the experiment's shape;
    returns the cases and the 16 polygons' (16, N) distance rows."""
    from spatialflink_tpu_torch.models import (EdgeGeomBatch, LineString,
                                                Polygon)
    from spatialflink_tpu_torch.ops import hopper_kernels as HK

    dev = torch.device("cuda")
    grid = _grid()
    cases = []

    def case(name, px, py, gb, plain_reps=REPS):
        n = px.shape[0]
        g, e = gb.edges.shape[0], gb.edges.shape[1]
        valid_edges = int(gb.edge_mask.sum())
        args = (px, py, gb.edges, gb.edge_mask, gb.is_areal)
        c, got = kernel_case(
            timer, torch, name, lambda: (HK.pip_lattice(*args),),
            lambda: (HK.pip_lattice_plain(*args).T,),
            n * valid_edges * HK.OPS_PER_PAIR,
            n * 8 + g * e * 17 + g + g * n * 4, "K4x",
            plain_reps=plain_reps, points=n, geometries=g,
            edges_padded=e, valid_edges=valid_edges)
        cases.append(c)
        return got[0]

    polys = [Polygon.create([rg], grid) for rg in query_polygons()]
    main = EdgeGeomBatch.from_objects(
        polys + [LineString.create([(116.2, 40.2), (117.0, 40.2),
                                    (117.0, 40.9)], grid)],
        device=dev, pad=len(polys) + 1)
    rows = case(f"{b.capacity}x{len(polys)}polygons+1linestring", b.x, b.y,
                main)
    # each row equals K4 on that geometry alone
    for gi in (0, len(polys)):
        one = HK.pip_dist(b.x, b.y, main.edges[gi], main.edge_mask[gi],
                          bool(main.is_areal[gi]))
        if not torch.equal(rows[gi], one):
            raise AssertionError(f"pip_lattice row {gi} != pip_dist")
    rows = rows[:len(polys)].contiguous()

    # benchmarks/exp_pip_lattice.py:136-146: 65,536 points x 10,240
    # rectangles of half-sizes 0.01-0.05 inside the bbox
    rng = np.random.default_rng(3)
    rects = []
    for _ in range(10_240):
        cx = rng.uniform(BBOX[0] + 0.1, BBOX[2] - 0.1)
        cy = rng.uniform(BBOX[1] + 0.1, BBOX[3] - 0.1)
        w, h = rng.uniform(0.01, 0.05, 2)
        rects.append(Polygon.create(
            [[(cx - w, cy - h), (cx + w, cy - h), (cx + w, cy + h),
              (cx - w, cy + h), (cx - w, cy - h)]], grid))
    gb = EdgeGeomBatch.from_objects(rects, device=dev, pad=len(rects))
    px = torch.from_numpy(rng.uniform(BBOX[0], BBOX[2], 65_536)
                          .astype(np.float32)).to(dev)
    py = torch.from_numpy(rng.uniform(BBOX[1], BBOX[3], 65_536)
                          .astype(np.float32)).to(dev)
    case("65536x10240rectangles", px, py, gb, plain_reps=3)
    torch.cuda.empty_cache()
    if HK.pip_lattice.launches <= 0:
        raise AssertionError("pip_lattice launched no kernel")
    return cases, rows


def k1_query_axis_phase(torch, timer: Timer, b, lattice_rows):
    """K1 with a query axis of 16: point mode (16 query points) and cell
    mask mode (the 16 query polygons' masks and K4x distance rows); every
    row also equals its single-query launch."""
    from spatialflink_tpu_torch.models import Point, Polygon
    from spatialflink_tpu_torch.ops import range as R

    dev = torch.device("cuda")
    grid = _grid()
    r = 0.5
    gl, cl = grid.guaranteed_layers(r), grid.candidate_layers(r)
    pts = [Point.create(x, y, grid) for x, y in query_points()]
    qx = torch.tensor([p.x for p in pts], dtype=torch.float32, device=dev)
    qy = torch.tensor([p.y for p in pts], dtype=torch.float32, device=dev)
    qc = torch.tensor([p.cell for p in pts], dtype=torch.int32, device=dev)
    polys = [Polygon.create([rg], grid) for rg in query_polygons()]
    gn = torch.from_numpy(np.stack([grid.guaranteed_cells_mask(
        r, sorted(p.cells)) for p in polys])).to(dev)
    cn = torch.from_numpy(np.stack([grid.candidate_cells_mask(
        r, sorted(p.cells)) for p in polys])).to(dev)
    n, q = b.capacity, len(pts)
    cases = []
    for approx in (False, True):
        c, got = kernel_case(
            timer, torch, f"point-q{q}-{'approx' if approx else 'exact'}",
            lambda a=approx: R.range_filter_point_multi_masks(
                b, qx, qy, qc, r, gl, cl, n=grid.n, approximate=a),
            lambda a=approx: R.range_filter_point_multi_masks_plain(
                b, qx, qy, qc, r, gl, cl, n=grid.n, approximate=a),
            q * n * R.OPS_PER_POINT[R.MODE_POINT],
            n * 13 + q * 12 + q * n + q * 8, "K1", queries=q)
        for row in (0, q - 1):
            one = R.range_filter_point_stats(
                b, pts[row].x, pts[row].y, pts[row].cell, r, gl, cl,
                n=grid.n, approximate=approx)
            if not torch.equal(got[0][row], one[0]):
                raise AssertionError(f"K1 query-axis row {row} != single")
        cases.append(c)
    c, got = kernel_case(
        timer, torch, f"masks-q{q}-exact",
        lambda: R.range_filter_masks_stats(b, gn, cn, lattice_rows, r),
        lambda: R.range_filter_masks_stats_plain(b, gn, cn, lattice_rows, r),
        q * n * R.OPS_PER_POINT[R.MODE_MASKS],
        n * 5 + q * n * 4 + 2 * gn.numel() + q * n + q * 8, "K1", queries=q)
    one = R.range_filter_masks_stats(b, gn[3], cn[3], lattice_rows[3], r)
    if not torch.equal(got[0][3], one[0]):
        raise AssertionError("K1 mask-mode query-axis row 3 != single")
    cases.append(c)
    return cases


def knn_kernel_phase(torch, seed: int, timer: Timer, lattice_rows):
    """K2 at 1,048,576 points and 100,000 object ids."""
    from spatialflink_tpu_torch.models import (Point, PointBatch, Polygon,
                                                single_query_edges)
    from spatialflink_tpu_torch.ops import hopper_kernels as HK
    from spatialflink_tpu_torch.ops import knn as K

    dev = torch.device("cuda")
    grid = _grid()
    rng = np.random.default_rng(seed + 5)
    x = rng.uniform(BBOX[0], BBOX[2], N_KERNEL)
    y = rng.uniform(BBOX[1], BBOX[3], N_KERNEL)
    oid = rng.integers(0, N_IDS, N_KERNEL).astype(np.int32)
    # ties: 200 distinct objects at the same point 0.001 east of the query
    # of the ties case, so that the k-th place is an exact tie
    tq = (116.9, 40.2)
    x[:200], y[:200] = tq[0] + 0.001, tq[1]
    oid[:200] = np.arange(200, dtype=np.int32) * 37
    b = PointBatch.from_arrays(x, y, device=dev, grid=grid, obj_id=oid)
    n = b.capacity
    nb_layers = grid.candidate_layers(0.5)
    pts = [Point.create(px_, py_, grid) for px_, py_ in query_points()]
    polys = [Polygon.create([rg], grid) for rg in query_polygons()]
    nb = torch.from_numpy(np.stack([grid.neighboring_cells_mask(
        0.5, sorted(p.cells)) for p in polys])).to(dev)
    d_k4 = HK.pip_dist(b.x, b.y, *(torch.from_numpy(a).to(dev) for a in
                                   single_query_edges(polys[0])), True)

    def qarr(ps):
        return (torch.tensor([p.x for p in ps], dtype=torch.float32,
                             device=dev),
                torch.tensor([p.y for p in ps], dtype=torch.float32,
                             device=dev),
                torch.tensor([p.cell for p in ps], dtype=torch.int32,
                             device=dev))

    q1, q16 = qarr(pts[:1]), qarr(pts)
    tie = qarr([Point.create(*tq, grid)])
    outside = (q1[0], q1[1], torch.tensor([-1], dtype=torch.int32,
                                           device=dev))
    point_kw = dict(mode=K.MODE_POINT, num_ids=N_IDS, x=b.x, y=b.y,
                    cell=b.cell, valid=b.valid, n=grid.n)
    specs = [  # name, k, keyword arguments of the kernel call
        ("point-k50", 50, dict(point_kw, qx=q1[0], qy=q1[1], q_cell=q1[2],
                               nb_layers=nb_layers)),
        ("point-k10", 10, dict(point_kw, qx=q1[0], qy=q1[1], q_cell=q1[2],
                               nb_layers=nb_layers)),
        ("point-radius0-k50", 50, dict(point_kw, qx=q1[0], qy=q1[1],
                                       q_cell=q1[2], nb_layers=grid.n)),
        ("point-q16-k50", 50, dict(point_kw, qx=q16[0], qy=q16[1],
                                   q_cell=q16[2], nb_layers=nb_layers)),
        ("ties-k50", 50, dict(point_kw, qx=tie[0], qy=tie[1], q_cell=tie[2],
                              nb_layers=nb_layers)),
        ("none-eligible-k50", 50, dict(point_kw, qx=outside[0],
                                       qy=outside[1], q_cell=outside[2],
                                       nb_layers=nb_layers)),
        ("cells-k10", 10, dict(mode=K.MODE_CELLS, num_ids=N_IDS, cell=b.cell,
                               valid=b.valid, dists=d_k4[None],
                               nb_mask=nb[:1])),
        ("cells-q16-k10", 10, dict(mode=K.MODE_CELLS, num_ids=N_IDS,
                                   cell=b.cell, valid=b.valid,
                                   dists=lattice_rows, nb_mask=nb)),
        ("cells-none-eligible-k10", 10, dict(
            mode=K.MODE_CELLS, num_ids=N_IDS, cell=b.cell, valid=b.valid,
            dists=d_k4[None], nb_mask=torch.zeros_like(nb[:1]))),
    ]
    cases = []
    for name, k, kw in specs:
        q = kw["qx"].shape[0] if "qx" in kw else kw["dists"].shape[0]
        mode = kw["mode"]
        in_bytes = n * (4 + 4 + 1) + (n * 8 + q * 12 if mode == K.MODE_POINT
                                      else q * n * 4 + kw["nb_mask"].numel())
        c, got = kernel_case(
            timer, torch, name,
            lambda kw=kw, k=k: K.knn_topk(b.obj_id, k=k, **kw),
            lambda kw=kw, k=k: K.knn_topk_plain(b.obj_id, k=k, **kw),
            q * n * K.OPS_PER_SLOT[mode] + q * N_IDS,
            in_bytes + q * k * 9 + q * 4, "K2", queries=q, k=k,
            object_ids=N_IDS)
        c["eligible"] = [int(v) for v in got[3][:2]]
        c["valid_slots"] = int(got[2][0].sum())
        if name.startswith(("none", "cells-none")):
            if bool(got[2].any()) or int(got[3].sum()) != 0:
                raise AssertionError(f"K2 {name}: found a neighbour")
        elif not bool(got[2][:, :k].all()):
            raise AssertionError(f"K2 {name}: fewer than k neighbours")
        if name == "ties-k50":
            # the tied objects fill the list's tail in ascending id order
            ids = got[0][0].cpu().numpy()
            dist = got[1][0].cpu().numpy()
            tied = ids[dist == dist[-1]]
            if not (len(tied) >= 40 and np.all(np.diff(tied) > 0)
                    and set(tied.tolist()) <= set(oid[:200].tolist())):
                raise AssertionError(f"K2 ties order: {ids[:8]}")
            c["tied_in_list"] = int(len(tied))
        cases.append(c)
    if K.knn_topk.launches <= 0:
        raise AssertionError("knn_topk launched no kernel")
    return cases


def reference_phase(torch, seed: int) -> None:
    """Small inputs against independent float64 numpy references:
    distances within 1e-4 degrees, masks equal away from the radius, kNN
    lists equal where the float64 minima are more than 1e-6 apart."""
    from spatialflink_tpu_torch.models import (PointBatch, Polygon,
                                                single_query_edges)
    from spatialflink_tpu_torch.ops import hopper_kernels as HK
    from spatialflink_tpu_torch.ops import knn as K
    from spatialflink_tpu_torch.ops import range as R

    dev = torch.device("cuda")
    grid = _grid()
    rng = np.random.default_rng(seed + 1)
    x = rng.uniform(BBOX[0], BBOX[2], 4096)
    y = rng.uniform(BBOX[1], BBOX[3], 4096)
    oid = rng.integers(0, 900, 4096).astype(np.int32)
    b = PointBatch.from_arrays(x, y, device=dev, grid=grid, obj_id=oid)
    xf = b.x.cpu().numpy()[:4096].astype(np.float64)
    yf = b.y.cpu().numpy()[:4096].astype(np.float64)
    poly = Polygon.create([ring(64, 0.35)], grid)
    e_np, m_np = single_query_edges(poly)
    d = HK.pip_dist(b.x, b.y, torch.from_numpy(e_np).to(dev),
                    torch.from_numpy(m_np).to(dev), True).cpu().numpy()[:4096]
    e = e_np[m_np].astype(np.float64)
    x1, y1, x2, y2 = (e[:, k][None, :] for k in range(4))
    px, py = xf[:, None], yf[:, None]
    cx, cy = x2 - x1, y2 - y1
    t = np.clip(((px - x1) * cx + (py - y1) * cy) / (cx * cx + cy * cy), 0, 1)
    bd = np.sqrt(((x1 + t * cx - px) ** 2 + (y1 + t * cy - py) ** 2).min(1))
    with np.errstate(divide="ignore", invalid="ignore"):
        xat = x1 + (py - y1) * cx / (y2 - y1)
    inside = (((y1 > py) != (y2 > py)) & (px < xat)).sum(1) % 2 == 1
    want = np.where(inside, 0.0, bd)
    ok = np.abs(bd) > 1e-4  # away from the boundary the inside flag is sure
    if not np.allclose(d[ok], want[ok], atol=1e-4, rtol=0):
        raise AssertionError("pip_dist disagrees with the float64 reference")
    q = (116.5, 40.5)
    mask = R.range_filter_point_stats(
        b, q[0], q[1], int(grid.assign_cell(*q)[0]), 0.5,
        grid.guaranteed_layers(0.5), grid.candidate_layers(0.5),
        n=grid.n)[0].cpu().numpy()[:4096]
    dq = np.hypot(xf - q[0], yf - q[1])
    sure = np.abs(dq - 0.5) > 1e-4
    if not np.array_equal(mask[sure], (dq <= 0.5)[sure]):
        raise AssertionError("range mask disagrees with the float64 reference")
    # kNN, radius 0 (every cell): per-object float64 minimum, then top 50
    res, evals = K.knn_point_stats(b, q[0], q[1], int(grid.assign_cell(*q)[0]),
                                   grid.n, n=grid.n, k=50, num_ids=900)
    best = np.full(900, np.inf)
    np.minimum.at(best, oid, dq)
    order = np.argsort(best, kind="stable")[:50]
    gaps = np.diff(best[np.argsort(best)][:51])
    got_ids = res.obj_id.cpu().numpy()
    got_d = res.dist.cpu().numpy()
    if int(evals) != 4096 or not bool(res.valid.all()):
        raise AssertionError("kNN candidate count / validity is wrong")
    if np.all(gaps > 1e-6) and not np.array_equal(got_ids, order):
        raise AssertionError("kNN list disagrees with the float64 reference")
    if not np.allclose(got_d, best[got_ids], rtol=1e-6, atol=0):
        raise AssertionError("kNN distances disagree with float64")
    log(f"reference: {int(ok.sum())} distances, {int(sure.sum())} mask "
        "entries and a 50-NN list agree with float64 numpy")


# ------------------------------------------------------------------------ #
# phase 3: the main path

#: (option, multiQuery, k or None for the conf's, kernels its path runs)
RUNS = [
    (6, False, None, ("pip_dist", "range_mask_stats")),
    (1, False, None, ("range_mask_stats",)),
    (11, False, None, ("pip_dist", "range_mask_stats")),
    (51, False, 50, ("knn_topk",)),
    (56, False, None, ("pip_dist", "knn_topk")),
    (61, False, None, ("pip_dist", "knn_topk")),
    (1, True, None, ("range_mask_stats",)),
    (51, True, 50, ("knn_topk",)),
    (6, True, None, ("pip_lattice", "range_mask_stats")),
    (56, True, None, ("pip_lattice", "knn_topk")),
    (11, True, None, ("pip_lattice", "range_mask_stats")),
]
KERNELS = ("pip_dist", "range_mask_stats", "knn_topk", "pip_lattice")


def stream_lines(seed: int, n: int):
    """n CSV rows 'oid,ts,x,y' uniform over the bbox, timestamps spread
    evenly over SPAN_MS from T0 (each 10 s window holds exactly n/2)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(BBOX[0], BBOX[2], n)
    y = rng.uniform(BBOX[1], BBOX[3], n)
    ts = T0 + (np.arange(n, dtype=np.int64) * SPAN_MS) // n
    oid = rng.integers(0, N_IDS, n)
    return [f"o{o},{t},{a!r},{c!r}" for o, t, a, c in
            zip(oid.tolist(), ts.tolist(), x.tolist(), y.tolist())]


def _payload(recs):
    """One query's window result in comparable form: the selected records'
    (x, y, ts, oid) columns, or the kNN (objID, distance) list."""
    cols = getattr(recs, "columns", None)
    return list(cols()[:4]) if cols is not None else list(recs)


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    if isinstance(a, list):
        return (isinstance(b, list) and len(a) == len(b)
                and all(_equal(u, v) for u, v in zip(a, b)))
    return a == b


def _selected(payload) -> int:
    if payload and isinstance(payload[0], np.ndarray):
        return int(payload[0].size)
    return len(payload)


def run_pipeline(params, lines):
    """One run of run_option on the card: per-window (start, end, [one
    payload per query]), per-window latencies (ms) and wall seconds."""
    import torch

    from spatialflink_tpu_torch.driver import run_option

    torch.cuda.synchronize()
    t_start = time.perf_counter()
    it = iter(run_option(params, lines, device="cuda"))
    wins, lat = [], []
    while True:
        t0 = time.perf_counter()
        try:
            w = next(it)
        except StopIteration:
            break
        lat.append((time.perf_counter() - t0) * 1e3)
        per_query = w.records if "queries" in w.extras else [w.records]
        wins.append((w.window_start, w.window_end,
                     [_payload(r) for r in per_query]))
    return wins, lat, time.perf_counter() - t_start


def base_params():
    from spatialflink_tpu_torch.config import Params

    base = Params.from_yaml(CONF)
    base = dataclasses.replace(
        base, input1=dataclasses.replace(base.input1, format="CSV"))
    base.query.query_points = query_points()
    base.query.query_polygons = query_polygons()
    base.query.query_linestrings = query_linestrings(
        base.query.query_linestrings)
    return base


def main_path_phase(card: str, seed: int):
    import torch

    from spatialflink_tpu_torch.ops import hopper_kernels as HK
    from spatialflink_tpu_torch.ops import knn as K
    from spatialflink_tpu_torch.ops import range as R

    t0 = time.perf_counter()
    lines = stream_lines(seed, N_STREAM)
    log(f"stream: {len(lines)} CSV rows over {SPAN_MS} ms "
        f"({time.perf_counter() - t0:.1f} s to generate)")
    base = base_params()
    counters = {"pip_dist": HK.pip_dist, "range_mask_stats":
                R.range_mask_stats, "knn_topk": K.knn_topk,
                "pip_lattice": HK.pip_lattice}
    plain_ops = {
        (R, "range_filter_point_stats"): R.range_filter_point_stats_plain,
        (R, "range_filter_masks_stats"): R.range_filter_masks_stats_plain,
        (R, "range_filter_point_multi_masks"):
            R.range_filter_point_multi_masks_plain,
        (HK, "pip_dist"): HK.pip_dist_plain,
        (HK, "pip_lattice"):
            lambda *a: HK.pip_lattice_plain(*a).T.contiguous(),
        (K, "knn_topk"): K.knn_topk_plain,
    }
    launches = dict.fromkeys(KERNELS, 0)
    report = []
    for opt, multi, k, path in RUNS:
        query = dataclasses.replace(base.query, option=opt, multi_query=multi,
                                    k=k or base.query.k)
        params = dataclasses.replace(base, query=query)
        label = f"{opt}{'-multi' if multi else ''}"
        for fn in counters.values():
            fn.launches = 0
        wins, lat, wall = run_pipeline(params, lines)
        got = {name: fn.launches for name, fn in counters.items()}
        for name in KERNELS:
            launches[name] += got[name]
        if any(got[name] <= 0 for name in path):
            raise AssertionError(f"option {label}: kernels of its path not "
                                 f"launched {got}")
        saved = {key: getattr(*key) for key in plain_ops}
        try:
            for (mod, name), fn in plain_ops.items():
                setattr(mod, name, fn)
            pwins, _, pwall = run_pipeline(params, lines)
        finally:
            for (mod, name), fn in saved.items():
                setattr(mod, name, fn)
        if {name: fn.launches for name, fn in counters.items()} != got:
            raise AssertionError("the plain run launched a kernel")
        if len(wins) != len(pwins) or not wins:
            raise AssertionError(f"option {label}: {len(wins)} windows vs "
                                 f"{len(pwins)} with the plain versions")
        for a, p in zip(wins, pwins):
            if a[:2] != p[:2] or not _equal(a[2], p[2]):
                raise AssertionError(f"option {label} window {a[:2]}: "
                                     "result differs from the plain run")
            if sum(_selected(q) for q in a[2]) == 0:
                raise AssertionError(f"option {label} window {a[:2]} empty")
        row = {"option": opt, "multi_query": multi,
               "queries": len(wins[0][2]), "k": query.k
               if opt >= 51 else None, "windows": len(wins),
               "selected": [[_selected(q) for q in w[2]] for w in wins],
               "points_per_s": N_STREAM / wall, "wall_s": wall,
               "plain_wall_s": pwall,
               "median_window_ms": float(np.median(lat)),
               "launches": {name: got[name] for name in KERNELS
                            if got[name]}, "card": card}
        if opt >= 51:
            row["first_list"] = wins[2][2][0][:3]
        log("main-path", json.dumps(row))
        report.append(row)
        torch.cuda.empty_cache()
    return launches, report, lines


def breakdown_phase(lines) -> dict:
    """Where options 6's and 51's time goes: the main path's stages run one
    after another over the same stream, each timed on the host clock with
    the device synchronised at its end (the pipelined run overlaps them)."""
    import torch

    from spatialflink_tpu_torch.driver import (ChunkedStream, _query_conf,
                                               decode_chunks)
    from spatialflink_tpu_torch.models import Point, Polygon
    from spatialflink_tpu_torch.operators import (PointGeomRangeQuery,
                                                  PointPointKNNQuery)

    params = base_params()
    grid = params.grids()[0]
    out = {}
    t0 = time.perf_counter()
    chunks = list(decode_chunks(lines, params.input1, grid))
    decode_s = time.perf_counter() - t0
    conf = _query_conf(params)
    for opt in (6, 51):
        if opt == 6:
            op = PointGeomRangeQuery(conf, grid, device="cuda")
            mask_stats = op._mask_stats_fn(
                Polygon.create([ring(64, 0.35)], grid), params.query.radius)

            def device_ops(batch, _recs):
                mask, gn_c, evals = mask_stats(batch)
                return op._defer_mask_select(mask, _recs, (gn_c, evals))
        else:
            op = PointPointKNNQuery(conf, grid, device="cuda")
            local = op._knn_result([Point.create(116.5, 40.5, grid)],
                                   params.query.radius, 50, single=True)

            def device_ops(batch, recs):
                res, evals = local(batch, len(recs.interner))
                return op._defer_knn(res, recs.interner, evals)
        stages = {"decode_s": decode_s, "assemble_s": 0.0,
                  "batch_h2d_s": 0.0, "device_ops_s": 0.0,
                  "readback_select_s": 0.0}
        t0 = time.perf_counter()
        wins = list(op._windows(ChunkedStream(iter(chunks))))
        stages["assemble_s"] = time.perf_counter() - t0
        for start, _end, recs in wins:
            t0 = time.perf_counter()
            batch = op._point_batch(recs, start)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            dfd = device_ops(batch, recs)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            dfd.finish()
            t3 = time.perf_counter()
            stages["batch_h2d_s"] += t1 - t0
            stages["device_ops_s"] += t2 - t1
            stages["readback_select_s"] += t3 - t2
        stages["windows"] = len(wins)
        stages["total_s"] = sum(v for key, v in stages.items()
                                if key.endswith("_s"))
        log("breakdown", opt, json.dumps(stages))
        out[str(opt)] = stages
    return out


def profile_phase(lines) -> dict:
    """Option 51 (k = 50) over the stream once more under torch.profiler
    (CPU and CUDA activities): the device time by kind (kernels, copies,
    memsets) from the trace's events, and the device's busy share of the
    run's wall time. A trace without device events reports device_ms 0."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    params = base_params()
    params.query.option, params.query.k = 51, 50
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, wall = run_pipeline(params, lines)
        torch.cuda.synchronize()
    by_kind = {"kernel_ms": 0.0, "memcpy_ms": 0.0, "memset_ms": 0.0}
    top = {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        name = ev.name.lower()
        kind = ("memcpy_ms" if "memcpy" in name else
                "memset_ms" if "memset" in name else "kernel_ms")
        ms = ev.device_time_total / 1e3 if hasattr(ev, "device_time_total") \
            else ev.cuda_time_total / 1e3
        by_kind[kind] += ms
        top[ev.name] = top.get(ev.name, 0.0) + ms
    device_ms = sum(by_kind.values())
    out = {"option": 51, "k": 50, "wall_s": wall, **by_kind,
           "device_ms": device_ms,
           "busy_share": device_ms / (wall * 1e3),
           "top": sorted(top.items(), key=lambda kv: -kv[1])[:6]}
    log("profile", json.dumps(out))
    return out


def cli_phase(seed: int) -> None:
    """The CLI on a CSV file: options 6 and 51 (k from the conf) with the
    conf's own query objects; stdout, extras included, must equal an
    in-process run's lines."""
    from spatialflink_tpu_torch.config import Params
    from spatialflink_tpu_torch.driver import _emit, run_option

    class Lines:
        def __init__(self):
            self.out = io.StringIO()

        def emit(self, record):
            print(record, file=self.out)

    build = os.path.join(ROOT, "spatialflink_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    lines = stream_lines(seed + 2, N_CLI)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = os.path.join(tmp, "points.csv")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        for opt in (6, 51):
            proc = subprocess.run(
                [sys.executable, "-m", "spatialflink_tpu_torch.driver",
                 "--config", CONF, "--option", str(opt), "--input1", path,
                 "--format", "CSV", "--device", "cuda"],
                cwd=ROOT, capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                raise AssertionError(f"CLI exit {proc.returncode}: "
                                     f"{proc.stderr}")
            params = Params.from_yaml(CONF)
            params = dataclasses.replace(
                params, input1=dataclasses.replace(params.input1,
                                                   format="CSV"))
            params.query.option = opt
            sink = Lines()
            for w in run_option(params, lines, device="cuda"):
                _emit(w, sink)
            want = sink.out.getvalue()
            if proc.stdout != want or not want:
                raise AssertionError(f"CLI option {opt} stdout "
                                     f"{proc.stdout[:200]!r} != in-process "
                                     f"{want[:200]!r}")
            first = want.splitlines()[0]
            log(f"cli: option {opt} over {N_CLI} CSV rows -> "
                f"{want.count(chr(10))} windows, stdout equals the "
                f"in-process run ({first})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    try:
        from spatialflink_tpu_torch.ops import native
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2

    t_all = time.perf_counter()
    card = card_line()
    log(f"card: {card}; torch.cuda: {torch.cuda.get_device_name(0)}; "
        f"torch {torch.__version__} CUDA {torch.version.cuda}")
    phases = {}

    def phase(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        phases[name] = time.perf_counter() - t0
        log(f"phase {name}: {phases[name]:.1f} s wall")
        return out

    compile_s = phase("build", native.build)
    log(f"build: per source {json.dumps(compile_s)}")
    timer = Timer(torch)
    k4_cases, k1_cases, batch = phase("kernels-k4-k1", kernel_phase, torch,
                                      args.seed, timer)
    k4x_cases, rows = phase("kernels-k4x", lattice_phase, torch, timer, batch)
    k1q_cases = phase("kernels-k1-query-axis", k1_query_axis_phase, torch,
                      timer, batch, rows)
    k2_cases = phase("kernels-k2", knn_kernel_phase, torch, args.seed, timer,
                     rows)
    del batch, rows
    torch.cuda.empty_cache()
    phase("reference", reference_phase, torch, args.seed)
    launches, report, lines = phase("main-path", main_path_phase, card,
                                    args.seed)
    breakdown = phase("breakdown", breakdown_phase, lines)
    prof = phase("profile", profile_phase, lines)
    del lines
    phase("cli", cli_phase, args.seed)

    def entry(name, source, replaces, cases, main_case, shape):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": max(c["max_abs_err"] for c in cases),
                "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
                "bound_ms": main_case["bound_ms"],
                "bound_by": main_case["bound_by"],
                "library_ms": None, "library_note": NO_LIB,
                "shape": shape, "cases": cases}

    kernels = [
        entry("pip_dist", "spatialflink_tpu_torch/csrc/pip_dist.cu",
              "spatialflink_tpu/ops/pallas_kernels.py:195", k4_cases,
              k4_cases[0], f"{N_KERNEL} points x 64 edges"),
        entry("range_mask_stats", "spatialflink_tpu_torch/csrc/range_mask.cu",
              "spatialflink_tpu/ops/range.py:72", k1_cases + k1q_cases,
              k1_cases[0], f"{N_KERNEL} points, point query"),
        entry("knn_topk", "spatialflink_tpu_torch/csrc/knn_topk.cu",
              "spatialflink_tpu/ops/knn.py:384", k2_cases, k2_cases[0],
              f"{N_KERNEL} points, {N_IDS} object ids, k=50, point query"),
        entry("pip_lattice", "spatialflink_tpu_torch/csrc/pip_lattice.cu",
              "benchmarks/exp_pip_lattice.py:112", k4x_cases, k4x_cases[0],
              f"{N_KERNEL} points x {N_QUERIES} polygons of 64 edges + 1 "
              "linestring"),
    ]
    kernels[2]["library_note"] = (
        "no single PyTorch call computes the per-object dedup and the "
        "top-k; torch.topk without the dedup is a different function")
    kernels[3]["library_note"] = (
        "no single PyTorch call computes the point x geometry lattice")
    phases["total"] = time.perf_counter() - t_all
    print(card, flush=True)
    print(json.dumps({"kernels": kernels, "card": card,
                      "main_path": report, "breakdown": breakdown,
                      "profile": prof, "phases_s": phases}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
