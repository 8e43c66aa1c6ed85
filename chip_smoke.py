#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (spatialflink_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py [--seed 0]

Phases (each raises on failure; the script catches nothing; each prints
its wall seconds):

1. Device: the card's name and power limit; build the CUDA kernels from
   ``spatialflink_tpu_torch/csrc`` (one nvcc per source, all started
   together, with the native point ingest ``native/ingest.cpp`` by g++)
   and print the build times; each kernel's registers, shared memory and
   spills (``-Xptxas -v``) are printed before the result.
2. Kernels against their plain PyTorch versions on the card, bit for bit,
   at the main path's shapes (1,048,576 points over the conf's grid bbox):
   K4 ``pip_dist`` for a 64-edge polygon, a polygon with a hole, the
   conf's linestring, 1,301-, 512- and 513-edge polygons and the empty
   edge set, each in the dense fold and, where ``pip_table``'s gate gives
   it one (16 to 512 edges, a short mean cell list), with its per-cell
   edge table, as the main path calls them (with the share of the dense
   fold's pairs the table leaves; the table form's bound counts only
   those pairs, and the dense pairs' bound stands beside it); K1
   ``range_mask_stats`` in point mode without distances (the main path's
   form) and with them, and in cell-mask mode, exact and approximate, and
   with a query axis of 16
   (each row also equal to the single-query launch); K4x ``pip_lattice``
   for 16 query polygons of 64 edges plus one linestring (in cell order,
   as the main path calls it, and in stream order), its cell order alone, its pruning edge cases
   (points on edges and vertices, at vertex y values, a cell of points
   within a few margins of an edge, outside the grid; a polygon larger
   than the bbox, 1,301- and 513-edge rings), and at the experiment's
   shape (65,536 points x 10,240 four-edge rectangles, a 2.7 GB output);
   K2 ``knn_topk`` with 100,000 object ids at k = 50 and k = 10: point
   mode, cell mode over K4 distances, 16 queries in both modes, ties at
   the k-th place (1 and 16 queries), nothing eligible, every object at
   one distance (k = 1,024), 3,000 objects at one distance (k = 50) and
   30 ids (k = 50). Then every kernel of the realtime path at one
   micro-batch of 512 points (K4 with its table and dense, the
   linestring; K1 point and mask mode; K2 point and cell mode over the
   batch's compacted ids, each also equal to the call over the interned
   ids; K4x in cell order), with its launch-to-completion time on the host
   clock beside the CUDA-event time. Times are CUDA-event medians of 25
   launches queued behind a sleep kernel (so the host's launch cost is not
   timed), with the 50 MB L2 evicted before each; the bound is
   max(operations / 67 TFLOP/s, bytes / 3.35 TB/s). Small inputs are also
   held against float64 numpy references (distances, range masks, kNN
   lists).
3. Main path: over a seeded 524,288-point CSV stream spanning 20 s (the
   conf's 10 s / 5 s sliding windows: full windows of 262,144 points),
   through ``driver.run_option`` on device="cuda": options 6, 1, 11, 51
   (k = 50), 56 and 61, then with multiQuery options 1 and 51 (16 query
   points), 6 and 56 (16 query polygons) and 11 (4 linestrings). The
   launch counters are zeroed before each run and read after it, and must
   be non-zero for every kernel of that run's path (and every K4 launch of
   a single-geometry run must take the per-cell table form where the
   query's table passes the gate, as for 6 and 56, and none where it
   does not, as for the 2-edge linestring of 11 and 61); each run is
   repeated with every kernel swapped for its plain version, and the
   per-window results must be equal (selections, and kNN (objID,
   distance) lists in order). The realtime runs follow over the same
   stream (1,024 micro-batches of 512): options 2, 7, 12, 52 (k = 50), 57
   and 62, the windowed latency variants 8 and 58 and the realtime
   latency variants 9 and 59; over its first 262,144 points (512
   micro-batches), multiQuery 2 and 52 (16 points), 7 and 57 (16
   polygons) and 12 (4 linestrings); over its first 262,144 points,
   options 1 and 51 (k = 50) under count windows of 262,144 records every
   131,072. Each the same way, with points/s, the median and p99 wall
   time per emitted window or micro-batch, and the records' latency_ms
   for 8 and 9. Every run must parse its CSV through the native parser,
   one call per decode chunk. Then the stages of options 6, 51, 2 and 52
   (native CSV decode, split into the parser call, id interning, cell
   assignment and the rest; window assembly or micro-batch cut, batch
   build and copy, device ops, readback and selection) are timed one
   after another, options 51 (whole stream) and 52 (first 262,144 points)
   run once more under torch.profiler (device time by kind and the
   device's busy share), and the CLI runs options 6 and 51 on a
   65,536-row CSV. (The point stream was cut from 2,097,152 points to
   make room for the geometry phase within the time limit.)
4. The polygon and linestring streams: two seeded streams of 262,144
   GeoJSON geometries over 20 s with 100,000 object ids (polygon rings of
   4-32 vertices with radii 0.002-0.02 degrees; linestring walks of 2-16
   segments), each decoded once through ``driver.decode_chunks`` (the
   per-record parse, timed per record). K5 ``geom_stream_dist`` against
   its plain version bit for bit at one 10 s window (131,072 polygons)
   for the conf's point, the conf's polygon, the 16 query polygons and
   the conf's linestring (over linestrings), in range and kNN mode and
   once approximate, and at one 512-geometry micro-batch, each with its
   CUDA-event time, launch-to-completion time and bound. Then options 16,
   21, 41, 66, 71 and 91, multiQuery 21 and 71 and realtime 22 and 72
   over the whole parsed stream, and the other 16 geometry options over
   its first 65,536 geometries, each through ``run_option`` over the
   parsed objects and again with K5 and K2 swapped for their plain
   versions (equal results; K5, and K2 for kNN, launched). The parse
   runs once per stream: at ~150 us per polygon record on the host of an
   H100 machine, parsing in every run would not fit the time limit;
   option 21 runs once more from the polygon stream's lines (the whole
   path) and must give the windows of its run over the parsed objects.
   Option 71 once more under torch.profiler, and the CLI runs option 21
   from a 16,384-line GeoJSON file against an in-process run over the
   same lines.
5. Output: the build report, the card line, one JSON ``kernels`` line
   (K4x's entry holds the cell order under ``helpers``; K5's the window
   cases and its micro-batch cases), and as the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero without a result line when CUDA is not available or the
package is not beside the script.
"""

from __future__ import annotations

import argparse
import contextlib
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
N_MICRO = 512                     # points per realtime micro-batch
N_STREAM = 1 << 19                # points in the main-path stream
N_SHORT = 1 << 18                 # points of the shorter realtime runs
COUNT_SIZE, COUNT_SLIDE = 1 << 18, 1 << 17  # count windows, in records
N_GEOM = 1 << 18                  # geometries in each geometry stream
WINDOW_GEOMS = N_GEOM // 2        # geometries of one 10 s window
N_GEOM_OTHER = 1 << 16            # geometries of the options run once
N_GEOM_CLI = 1 << 14              # polygons of the CLI's GeoJSON file
N_CLI = 1 << 16                   # rows of the CLI's CSV
N_IDS = 100_000                   # distinct object ids in every stream
N_QUERIES = 16                    # query points / polygons under multiQuery
N_EDGE_CASES = 1 << 17            # random points beside K4x's edge cases
EXP_POINTS, EXP_RECTS = 65_536, 10_240  # the Pallas experiment's shape
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
        if g is None or w is None:  # an output neither side wrote
            if g is not w:
                raise AssertionError(f"{what}: one side wrote no output")
            continue
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
        # the dense fold, then (up to one staged chunk) the per-cell table
        # form that the main path runs. Each form's bound counts the pairs
        # it folds for these points (the table's: its fold share of this
        # run's cells) and the bytes it reads (the table's: cell ids and
        # the table too); the dense pairs' bound stays beside it as the
        # yardstick of earlier runs
        dense_pairs = n * n_valid
        t = HK.pip_table(e, m, areal, grid)
        # the dense form gets the edges padded once, as the operators pass
        # them (pip_table pads them with or without a table)
        forms = [("", (t.edges, t.edge_mask), {}, None, 0)]
        if t.bits is not None:
            forms.append(("-table", (t.edges, t.edge_mask),
                          dict(cell=b.cell, table=t),
                          HK.pip_table_fold_share(b.cell, t),
                          n * 4 + table_read_bytes(b.cell, t)))
        for suffix, (fe, fm), kw, share, extra in forms:
            pairs = dense_pairs * (1.0 if share is None
                                   else share["pair_share"])
            case, got = kernel_case(
                timer, torch, name + suffix,
                lambda fe=fe, fm=fm, a=areal, kw=kw: (
                    HK.pip_dist(b.x, b.y, fe, fm, a, **kw),),
                lambda e=e, m=m, a=areal: (
                    HK.pip_dist_plain(b.x, b.y, e, m, a),),
                pairs * HK.OPS_PER_PAIR, n * 12 + ep * 17 + extra,
                "K4", edges=n_valid, edges_padded=ep, fold_share=share,
                dense_bound_ms=bound_ms(dense_pairs * HK.OPS_PER_PAIR,
                                        n * 12 + ep * 17)[0])
            if got[0].shape != (n,) or bool(torch.isnan(got[0]).any()):
                raise AssertionError(f"pip_dist {name}{suffix}: bad output")
            k4_cases.append(case)
        if name == "polygon-64":
            dists64 = got[0]
    if HK.pip_dist.launches <= 0 or HK.pip_dist.table_launches <= 0:
        raise AssertionError("pip_dist launched no kernel (or no table)")

    q = (116.5, 40.5)
    qc = int(grid.assign_cell(*q)[0])
    r = 0.5
    gl, cl = grid.guaranteed_layers(r), grid.candidate_layers(r)
    cells = sorted(geoms["polygon-64"].cells)
    gn = torch.from_numpy(grid.guaranteed_cells_mask(r, cells)).to(dev)
    cn = torch.from_numpy(grid.candidate_cells_mask(r, cells)).to(dev)
    k1_cases = []
    for mode in ("point-nodists", "point", "masks"):
        for approx in (False, True):
            if mode == "point-nodists" and approx:
                continue
            if mode.startswith("point"):
                kw = dict(n=grid.n, return_dists=mode == "point")

                def kern(a=approx, kw=kw):
                    return R.range_filter_point_stats(
                        b, q[0], q[1], qc, r, gl, cl, approximate=a, **kw)

                def plain(a=approx, kw=kw):
                    return R.range_filter_point_stats_plain(
                        b, q[0], q[1], qc, r, gl, cl, approximate=a, **kw)
                ops = n * R.OPS_PER_POINT[R.MODE_POINT]
                # the main path (nodists) writes a mask byte, no distance
                nbytes = n * (4 + 4 + 4 + 1) + n * (
                    1 if mode == "point-nodists" else 1 + 4) + 8
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
            if mode == "point-nodists" and got[1] is not None:
                raise AssertionError("K1: distances written unasked")
            k1_cases.append(case)
    if R.range_mask_stats.launches <= 0:
        raise AssertionError("range_mask_stats launched no kernel")
    return k4_cases, k1_cases, b


def lattice_phase(torch, timer: Timer, b):
    """K4x at the main path's shape (the 16 query polygons of the
    multiQuery runs plus one linestring, in cell order as the main path
    calls it, and in stream order), the cell order alone, the pruning edge
    cases, and the experiment's shape; returns the cases, the cell order's
    case and the 16 polygons' (16, N) distance rows."""
    from spatialflink_tpu_torch.models import (EdgeGeomBatch, LineString,
                                                PointBatch, Polygon)
    from spatialflink_tpu_torch.ops import hopper_kernels as HK

    dev = torch.device("cuda")
    grid = _grid()
    cases = []

    def case(name, pb, gb, plain_reps=REPS, ordered=True, x=None, y=None):
        px, py = (pb.x, pb.y) if pb is not None else (x, y)
        n = px.shape[0]
        g, e = gb.edges.shape[0], gb.edges.shape[1]
        valid_edges = int(gb.edge_mask.sum())
        args = (px, py, gb.edges, gb.edge_mask, gb.is_areal)
        kw = dict(cell=pb.cell, num_cells=grid.num_cells) if ordered else {}
        c, got = kernel_case(
            timer, torch, name, lambda: (HK.pip_lattice(*args, **kw),),
            lambda: (HK.pip_lattice_plain(*args).T,),
            n * valid_edges * HK.OPS_PER_PAIR,
            n * (12 if ordered else 8) + g * e * 17 + g + g * n * 4, "K4x",
            plain_reps=plain_reps, points=n, geometries=g, edges_padded=e,
            valid_edges=valid_edges, order="cell" if ordered else "stream",
            write_bound_ms=g * n * 4 / PEAK_BYTES * 1e3)
        cases.append(c)
        return got[0]

    polys = [Polygon.create([rg], grid) for rg in query_polygons()]
    line = LineString.create([(116.2, 40.2), (117.0, 40.2), (117.0, 40.9)],
                             grid)
    main = EdgeGeomBatch.from_objects(polys + [line], device=dev,
                                      pad=len(polys) + 1)
    shape = f"{b.capacity}x{len(polys)}polygons+1linestring"
    rows = case(shape, b, main)
    # each row equals K4 on that geometry alone
    for gi in (0, len(polys)):
        one = HK.pip_dist(b.x, b.y, main.edges[gi], main.edge_mask[gi],
                          bool(main.is_areal[gi]))
        if not torch.equal(rows[gi], one):
            raise AssertionError(f"pip_lattice row {gi} != pip_dist")
    rows = rows[:len(polys)].contiguous()
    case(shape, b, main, plain_reps=3, ordered=False)
    n = b.capacity
    order_case, _ = kernel_case(
        timer, torch, f"{n}points",
        lambda: HK.cell_order(b.cell, grid.num_cells, b.x, b.y),
        lambda: HK.cell_order_plain(b.cell, grid.num_cells, b.x, b.y),
        0, n * 12 + n * 12, "cell_order", points=n, cells=grid.num_cells)

    # pruning edge cases at the conf's coordinates: points on edges and
    # vertices, at vertex y values, 2,048 points of one cell within a few
    # margins of an edge, and outside the grid (cell -1); a polygon larger
    # than the bbox and 1,301- and 513-edge rings beside the main geometries
    rng = np.random.default_rng(11)
    ring64 = np.asarray(ring(64, 0.35), np.float32)
    e = np.concatenate([ring64[:-1], ring64[1:]], axis=1)
    t = rng.random((64, 32)).astype(np.float32)
    on_x = (e[:, None, 0] + t * (e[:, None, 2] - e[:, None, 0])).ravel()
    on_y = (e[:, None, 1] + t * (e[:, None, 3] - e[:, None, 1])).ravel()
    vy = np.repeat(ring64[:, 1], 16)
    vx = np.tile(np.linspace(BBOX[0], BBOX[2], 16), len(ring64))
    e0 = e[5]  # one edge; 2,048 points of its midpoint's cell hug it
    nrm = np.array([e0[3] - e0[1], e0[0] - e0[2]], np.float64)
    nrm /= np.hypot(*nrm)
    margin = HK.distance_skip_margin(float(np.abs(e0).max()))
    along = rng.uniform(0.45, 0.55, 2048)
    off = rng.choice([-3, -1, 0, 1, 2, 3, 5], 2048) * margin
    hug_x = e0[0] + along * (e0[2] - e0[0]) + off * nrm[0]
    hug_y = e0[1] + along * (e0[3] - e0[1]) + off * nrm[1]
    out_x = rng.uniform(114.0, 115.4, 512)
    out_y = rng.uniform(39.0, 42.0, 512)
    m = N_EDGE_CASES
    ex = np.concatenate([on_x, ring64[:, 0], vx, hug_x, out_x,
                         rng.uniform(BBOX[0], BBOX[2], m)])
    ey = np.concatenate([on_y, ring64[:, 1], vy, hug_y, out_y,
                         rng.uniform(BBOX[1], BBOX[3], m)])
    eb = PointBatch.from_arrays(ex, ey, device=dev, grid=grid)
    if not bool((eb.cell[:len(ex)] == -1).any()):
        raise AssertionError("edge cases: no point outside the grid")
    big = Polygon.create([[(115.0, 39.0), (118.0, 39.0), (118.0, 42.0),
                           (115.0, 42.0)]], grid)
    edge_geoms = EdgeGeomBatch.from_objects(
        polys + [line, big, Polygon.create([ring(1301, 0.45)], grid),
                 Polygon.create([ring(513, 0.4)], grid)], device=dev)
    case(f"edge-cases-{eb.capacity}x{edge_geoms.capacity}geometries", eb,
         edge_geoms, plain_reps=1)
    del eb, edge_geoms

    # benchmarks/exp_pip_lattice.py:136-146: 65,536 points x 10,240
    # rectangles of half-sizes 0.01-0.05 inside the bbox, in stream order
    # (the experiment's points carry no cells)
    rng = np.random.default_rng(3)
    rects = []
    for _ in range(EXP_RECTS):
        cx = rng.uniform(BBOX[0] + 0.1, BBOX[2] - 0.1)
        cy = rng.uniform(BBOX[1] + 0.1, BBOX[3] - 0.1)
        w, h = rng.uniform(0.01, 0.05, 2)
        rects.append(Polygon.create(
            [[(cx - w, cy - h), (cx + w, cy - h), (cx + w, cy + h),
              (cx - w, cy + h), (cx - w, cy - h)]], grid))
    gb = EdgeGeomBatch.from_objects(rects, device=dev, pad=len(rects))
    px = torch.from_numpy(rng.uniform(BBOX[0], BBOX[2], EXP_POINTS)
                          .astype(np.float32)).to(dev)
    py = torch.from_numpy(rng.uniform(BBOX[1], BBOX[3], EXP_POINTS)
                          .astype(np.float32)).to(dev)
    case(f"{EXP_POINTS}x{EXP_RECTS}rectangles", None, gb, plain_reps=3,
         ordered=False, x=px, y=py)
    del gb
    torch.cuda.empty_cache()
    if HK.pip_lattice.launches <= 0 or HK.cell_order.launches <= 0:
        raise AssertionError("pip_lattice or cell_order launched no kernel")
    return cases, order_case, rows


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
        ("ties-q16-k50", 50, dict(point_kw, qx=torch.cat([tie[0], q16[0][1:]]),
                                  qy=torch.cat([tie[1], q16[1][1:]]),
                                  q_cell=torch.cat([tie[2], q16[2][1:]]),
                                  nb_layers=nb_layers)),
    ]
    # equal minima past one candidate tile: the selection refines on the
    # keys' lower bits. Every object at one point (k = 1,024), and 3,000
    # objects at one point 1e-5 from the query, nearer than any other
    same = PointBatch.from_arrays(
        np.full(N_KERNEL, tq[0] + 0.001), np.full(N_KERNEL, tq[1]),
        device=dev, grid=grid,
        obj_id=(np.arange(N_KERNEL) % N_IDS).astype(np.int32))
    x3, y3, oid3 = x.copy(), y.copy(), oid.copy()
    x3[:3000], y3[:3000] = tq[0] + 1e-5, tq[1]
    oid3[:3000] = np.arange(3000, dtype=np.int32) * 33
    near = PointBatch.from_arrays(x3, y3, device=dev, grid=grid, obj_id=oid3)
    few = PointBatch.from_arrays(x, y, device=dev, grid=grid,
                                 obj_id=(oid % 30).astype(np.int32))
    for name, pb, k, ids in (("same-distance-100000ids-k1024", same, K.MAX_K,
                              N_IDS),
                             ("same-distance-3000ids-k50", near, 50, N_IDS),
                             ("30ids-k50", few, 50, 30)):
        specs.append((name, k, dict(
            mode=K.MODE_POINT, num_ids=ids, x=pb.x, y=pb.y, cell=pb.cell,
            valid=pb.valid, n=grid.n, qx=tie[0], qy=tie[1], q_cell=tie[2],
            nb_layers=grid.n, obj_id=pb.obj_id)))
    cases = []
    for name, k, kw in specs:
        kw = dict(kw)
        ids_t = kw.pop("obj_id", b.obj_id)
        q = kw["qx"].shape[0] if "qx" in kw else kw["dists"].shape[0]
        mode = kw["mode"]
        in_bytes = n * (4 + 4 + 1) + (n * 8 + q * 12 if mode == K.MODE_POINT
                                      else q * n * 4 + kw["nb_mask"].numel())
        ids = kw["num_ids"]
        c, got = kernel_case(
            timer, torch, name,
            lambda kw=kw, k=k, o=ids_t: K.knn_topk(o, k=k, **kw),
            lambda kw=kw, k=k, o=ids_t: K.knn_topk_plain(o, k=k, **kw),
            q * n * K.OPS_PER_SLOT[mode] + q * ids,
            in_bytes + q * k * 9 + q * 4, "K2", queries=q, k=k,
            object_ids=ids)
        c["eligible"] = [int(v) for v in got[3][:2]]
        c["valid_slots"] = int(got[2][0].sum())
        if name.startswith(("none", "cells-none")):
            if bool(got[2].any()) or int(got[3].sum()) != 0:
                raise AssertionError(f"K2 {name}: found a neighbour")
        elif not bool(got[2][:, :min(k, ids)].all()):
            raise AssertionError(f"K2 {name}: fewer than k neighbours")
        if name.startswith("same-distance"):
            # the tied objects fill the list in ascending id order
            tied = got[0][0].cpu().numpy()
            if not np.all(np.diff(tied) > 0):
                raise AssertionError(f"K2 {name}: ids {tied[:8]}")
        if name in ("ties-k50", "ties-q16-k50"):
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


def table_read_bytes(cell, t) -> int:
    """The bytes K4's table form reads of its per-cell table for points in
    ``cell``: the flags byte of each distinct cell they lie in, and that
    cell's row of edge bits unless the cell lies wholly inside an areal
    geometry (the kernel answers those points from the flags alone). At a
    micro-batch the points reach few of the grid's cells."""
    c = cell[(cell >= 0) & (cell < t.num_cells)].unique().long()
    rows = int(((t.flags[c] & 2) == 0).sum()) if t.is_areal else c.numel()
    return c.numel() + rows * t.bits.shape[1] * 8


def launch_ms(torch, fn, reps: int = REPS) -> float:
    """Host-clock median of one call from the wrapper's entry to the
    device's completion (allocation, memsets, launch and run: at a
    micro-batch the launches are the cost)."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def micro_kernel_phase(torch, seed: int, timer: Timer):
    """Every kernel of the realtime path at one micro-batch of N_MICRO
    points (the ids compacted as the realtime kNN path compacts them),
    against its plain version bit for bit, with its CUDA-event time, bound,
    plain time and launch-to-completion time. Returns {kernel: [cases]}."""
    from spatialflink_tpu_torch.models import (EdgeGeomBatch, LineString,
                                                Point, PointBatch, Polygon,
                                                single_query_edges)
    from spatialflink_tpu_torch.ops import hopper_kernels as HK
    from spatialflink_tpu_torch.ops import knn as K
    from spatialflink_tpu_torch.ops import range as R

    dev = torch.device("cuda")
    grid = _grid()
    rng = np.random.default_rng(seed + 9)
    x = rng.uniform(BBOX[0], BBOX[2], N_MICRO)
    y = rng.uniform(BBOX[1], BBOX[3], N_MICRO)
    oid = rng.integers(0, N_IDS, N_MICRO)
    ids, local = np.unique(oid, return_inverse=True)
    b = PointBatch.from_arrays(x, y, device=dev, grid=grid,
                               obj_id=local.reshape(-1))
    full = PointBatch.from_arrays(x, y, device=dev, grid=grid, obj_id=oid)
    n, nid = b.capacity, len(ids)
    r = 0.5
    q = Point.create(116.5, 40.5, grid)
    gl, cl = grid.guaranteed_layers(r), grid.candidate_layers(r)
    poly = Polygon.create([ring(64, 0.35)], grid)
    line = LineString.create([(116.2, 40.2), (117.0, 40.2), (117.0, 40.9)],
                             grid)
    out = {name: [] for name in KERNELS}

    def case(kernel, name, kern, plain, ops, nbytes, **extra):
        c, got = kernel_case(timer, torch, name, kern, plain, ops, nbytes,
                             f"{kernel}-micro", points=n, **extra)
        c["launch_to_completion_ms"] = launch_ms(torch, kern)
        log(f"{kernel}-micro {name}: launch to completion "
            f"{c['launch_to_completion_ms']:.5f} ms")
        out[kernel].append(c)
        return got

    # K4: the 64-edge polygon with its table (options 7, 57, 9, 59) and
    # dense, and the conf's linestring dense (options 12, 62)
    dists = {}
    for gname, geom, areal in (("polygon-64", poly, True),
                               ("linestring", line, False)):
        e, m = (torch.from_numpy(a).to(dev) for a in single_query_edges(geom))
        t = HK.pip_table(e, m, areal, grid)
        n_valid, ep = int(m.sum()), HK.bucket_edges(e.shape[0])
        forms = [("-dense", {}, 1.0, 0)]
        if t.bits is not None:
            share = HK.pip_table_fold_share(b.cell, t)["pair_share"]
            forms.insert(0, ("-table", dict(cell=b.cell, table=t), share,
                             n * 4 + table_read_bytes(b.cell, t)))
        for suffix, kw, share, extra in forms:
            got = case("pip_dist", f"{gname}{suffix}-{n}",
                       lambda kw=kw, t=t, a=areal: (
                           HK.pip_dist(b.x, b.y, t.edges, t.edge_mask, a,
                                       **kw),),
                       lambda e=e, m=m, a=areal: (
                           HK.pip_dist_plain(b.x, b.y, e, m, a),),
                       n * n_valid * share * HK.OPS_PER_PAIR,
                       n * 12 + ep * 17 + extra, edges=n_valid)
            dists.setdefault(gname, got[0])
    # K1: point mode without distances (option 2), mask mode over the
    # polygon's distances (option 7)
    cells = sorted(poly.cells)
    gn = torch.from_numpy(grid.guaranteed_cells_mask(r, cells)).to(dev)
    cn = torch.from_numpy(grid.candidate_cells_mask(r, cells)).to(dev)
    case("range_mask_stats", f"point-nodists-{n}",
         lambda: R.range_filter_point_stats(b, q.x, q.y, q.cell, r, gl, cl,
                                            n=grid.n, return_dists=False),
         lambda: R.range_filter_point_stats_plain(
             b, q.x, q.y, q.cell, r, gl, cl, n=grid.n, return_dists=False),
         n * R.OPS_PER_POINT[R.MODE_POINT], n * 14 + 8)
    case("range_mask_stats", f"masks-{n}",
         lambda: R.range_filter_masks_stats(b, gn, cn, dists["polygon-64"],
                                            r),
         lambda: R.range_filter_masks_stats_plain(
             b, gn, cn, dists["polygon-64"], r),
         n * R.OPS_PER_POINT[R.MODE_MASKS],
         n * (4 + 1 + 4) + 2 * gn.numel() + n + 8)
    # K2 over the compacted ids: point mode k = 50 (option 52), cell mode
    # over K4's distances k = 10 (option 57); each equals the call over
    # the uncompacted ids once its ids are mapped back
    nb = torch.from_numpy(grid.neighboring_cells_mask(r, cells)).to(dev)
    qx, qy, qc = (torch.tensor([v], dtype=dt, device=dev) for v, dt in
                  ((q.x, torch.float32), (q.y, torch.float32),
                   (q.cell, torch.int32)))
    k2 = [("point-k50", 50, dict(mode=K.MODE_POINT, x=b.x, y=b.y,
                                  cell=b.cell, valid=b.valid, qx=qx, qy=qy,
                                  q_cell=qc, n=grid.n, nb_layers=cl),
           n * 8 + 12),
          ("cells-k10", 10, dict(mode=K.MODE_CELLS, cell=b.cell,
                                 valid=b.valid,
                                 dists=dists["polygon-64"][None],
                                 nb_mask=nb[None]), n * 4 + nb.numel())]
    for name, k, kw, in_bytes in k2:
        got = case("knn_topk", f"{name}-{n}-compacted",
                   lambda kw=kw, k=k: K.knn_topk(b.obj_id, k=k, num_ids=nid,
                                                 **kw),
                   lambda kw=kw, k=k: K.knn_topk_plain(
                       b.obj_id, k=k, num_ids=nid, **kw),
                   n * K.OPS_PER_SLOT[kw["mode"]] + nid,
                   n * 9 + in_bytes + k * 9 + 4, object_ids=nid)
        wide = K.knn_topk(full.obj_id, k=k, num_ids=N_IDS, **kw)
        valid = got[2][0].cpu().numpy()
        if not (torch.equal(got[1], wide[1]) and torch.equal(got[2], wide[2])
                and np.array_equal(ids[got[0][0].cpu().numpy()[valid]],
                                   wide[0][0].cpu().numpy()[valid])):
            raise AssertionError(f"K2 {name}: compacted ids differ from the "
                                 "uncompacted call")
    # K4x: the 16 query polygons and the conf's linestring (multiQuery
    # 7 and 57), in cell order as the main path calls it
    gb = EdgeGeomBatch.from_objects(
        [Polygon.create([rg], grid) for rg in query_polygons()] + [line],
        device=dev, pad=N_QUERIES + 1)
    args = (b.x, b.y, gb.edges, gb.edge_mask, gb.is_areal)
    g, e = gb.edges.shape[0], gb.edges.shape[1]
    case("pip_lattice", f"{n}x{N_QUERIES}polygons+1linestring",
         lambda: (HK.pip_lattice(*args, cell=b.cell,
                                 num_cells=grid.num_cells),),
         lambda: (HK.pip_lattice_plain(*args).T,),
         n * int(gb.edge_mask.sum()) * HK.OPS_PER_PAIR,
         n * 12 + g * e * 17 + g + g * n * 4, geometries=g)
    return out


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
    (6, True, None, ("pip_lattice", "cell_order", "range_mask_stats")),
    (56, True, None, ("pip_lattice", "cell_order", "knn_topk")),
    (11, True, None, ("pip_lattice", "range_mask_stats")),
]
#: the realtime runs over the whole stream (micro-batches of 512), with
#: the realtime latency variants 9 and 59, and the windowed latency
#: variants 8 and 58: the same fields as RUNS
REALTIME_RUNS = [
    (2, False, None, ("range_mask_stats",)),
    (7, False, None, ("pip_dist", "range_mask_stats")),
    (12, False, None, ("pip_dist", "range_mask_stats")),
    (52, False, 50, ("knn_topk",)),
    (57, False, None, ("pip_dist", "knn_topk")),
    (62, False, None, ("pip_dist", "knn_topk")),
    (8, False, None, ("pip_dist", "range_mask_stats")),
    (58, False, None, ("pip_dist", "knn_topk")),
    (9, False, None, ("pip_dist", "range_mask_stats")),
    (59, False, None, ("pip_dist", "knn_topk")),
]
#: the multi-query realtime runs, over the stream's first N_SHORT points
#: (1,024 micro-batches): the script keeps within its time limit
SHORT_REALTIME_RUNS = [
    (2, True, None, ("range_mask_stats",)),
    (52, True, 50, ("knn_topk",)),
    (7, True, None, ("pip_lattice", "cell_order", "range_mask_stats")),
    (57, True, None, ("pip_lattice", "cell_order", "knn_topk")),
    (12, True, None, ("pip_lattice", "range_mask_stats")),
]
#: options 1 and 51 under count windows of COUNT_SIZE records every
#: COUNT_SLIDE arrivals, over the stream's first COUNT_SIZE points (two
#: windows, overlapping by COUNT_SIZE - COUNT_SLIDE records)
COUNT_RUNS = [
    (1, False, None, ("range_mask_stats",)),
    (51, False, 50, ("knn_topk",)),
]
KERNELS = ("pip_dist", "range_mask_stats", "knn_topk", "pip_lattice",
           "cell_order", "geom_stream_dist")


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
    payload per query]), per-window latencies (ms), the records'
    ``latency_ms`` (latency variants) and wall seconds."""
    import torch

    from spatialflink_tpu_torch.driver import run_option

    torch.cuda.synchronize()
    t_start = time.perf_counter()
    it = iter(run_option(params, lines, device="cuda"))
    wins, lat, rec_lat = [], [], []
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
        rec_lat.extend(w.extras.get("latency_ms", ()))
    return wins, lat, rec_lat, time.perf_counter() - t_start


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


def _has_table(params, opt: int) -> bool:
    """Whether single-geometry option ``opt``'s query geometry (the first
    polygon or the first linestring) gets a per-cell table from
    ``pip_table``."""
    import torch

    from spatialflink_tpu_torch.driver import CASES
    from spatialflink_tpu_torch.models import Polygon, single_query_edges
    from spatialflink_tpu_torch.ops import hopper_kernels as HK

    grid = _grid()
    geom = (params.query_linestring_objects(grid)
            if CASES[opt].query == "LineString"
            else params.query_polygon_objects(grid))[0]
    e, m = (torch.from_numpy(a) for a in single_query_edges(geom))
    return HK.pip_table(e, m, isinstance(geom, Polygon), grid).bits is not None


def _pct(values, q):
    return float(np.percentile(values, q)) if len(values) else None


def main_path_phase(card: str, lines, runs, window=None):
    """Each run of ``runs`` through run_option on the card, then again with
    every kernel swapped for its plain version: equal per-window results,
    the launch counters non-zero for every kernel of the run's path, and
    one native parser call per decode chunk in both runs. ``window``
    replaces the conf's window block (count windows)."""
    import torch

    from spatialflink_tpu_torch.driver import CASES
    from spatialflink_tpu_torch.ops import hopper_kernels as HK
    from spatialflink_tpu_torch.ops import knn as K
    from spatialflink_tpu_torch.ops import range as R
    from spatialflink_tpu_torch.streams import bulk as B

    base = base_params()
    if window is not None:
        base = dataclasses.replace(base, window=window)
    counters = {"pip_dist": HK.pip_dist, "range_mask_stats":
                R.range_mask_stats, "knn_topk": K.knn_topk,
                "pip_lattice": HK.pip_lattice, "cell_order": HK.cell_order}
    plain_ops = {
        (R, "range_filter_point_stats"): R.range_filter_point_stats_plain,
        (R, "range_filter_masks_stats"): R.range_filter_masks_stats_plain,
        (R, "range_filter_point_multi_masks"):
            R.range_filter_point_multi_masks_plain,
        (HK, "pip_dist"): HK.pip_dist_plain,
        (HK, "pip_lattice"):
            lambda *a, **_: HK.pip_lattice_plain(*a).T.contiguous(),
        (K, "knn_topk"): K.knn_topk_plain,
    }
    launches = dict.fromkeys(KERNELS, 0)
    report = []
    for opt, multi, k, path in runs:
        query = dataclasses.replace(base.query, option=opt, multi_query=multi,
                                    k=k or base.query.k)
        params = dataclasses.replace(base, query=query)
        spec = CASES[opt]
        mode = ("count" if window is not None else spec.mode)
        label = f"{opt}{'-multi' if multi else ''}{'-count' if window else ''}"
        chunk = (N_MICRO if mode == "realtime" else
                 min(4096, COUNT_SLIDE) if mode == "count" else 4096)
        want_calls = -(-len(lines) // chunk)
        for fn in counters.values():
            fn.launches = 0
        HK.pip_dist.table_launches = 0
        calls = B.bulk_parse_csv.calls
        wins, lat, rec_lat, wall = run_pipeline(params, lines)
        got = {name: fn.launches for name, fn in counters.items()}
        table_launches = HK.pip_dist.table_launches
        native_calls = B.bulk_parse_csv.calls - calls
        for name in counters:
            launches[name] += got[name]
        if any(got[name] <= 0 for name in path):
            raise AssertionError(f"option {label}: kernels of its path not "
                                 f"launched {got}")
        if native_calls != want_calls:
            raise AssertionError(f"option {label}: {native_calls} native "
                                 f"CSV parses, {want_calls} chunks")
        # one query geometry: every K4 launch takes the per-cell table form
        # where its table passes pip_table's gate, and none does elsewhere
        if not multi and "pip_dist" in path:
            want = got["pip_dist"] if _has_table(params, opt) else 0
            if table_launches != want:
                raise AssertionError(f"option {label}: {table_launches} of "
                                     f"{got['pip_dist']} K4 launches used "
                                     f"the table, {want} should")
        saved = {key: getattr(*key) for key in plain_ops}
        calls = B.bulk_parse_csv.calls
        try:
            for (mod, name), fn in plain_ops.items():
                setattr(mod, name, fn)
            pwins, _, _, pwall = run_pipeline(params, lines)
        finally:
            for (mod, name), fn in saved.items():
                setattr(mod, name, fn)
        if B.bulk_parse_csv.calls - calls != want_calls:
            raise AssertionError(f"option {label}: the plain run parsed "
                                 "without the native parser")
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
        if spec.latency and opt < 51 and len(rec_lat) != sum(
                _selected(w[2][0]) for w in wins):
            raise AssertionError(f"option {label}: {len(rec_lat)} record "
                                 "latencies for the selected records")
        row = {"option": opt, "mode": mode, "multi_query": multi,
               "queries": len(wins[0][2]), "k": query.k
               if opt >= 51 else None, "points": len(lines),
               "windows": len(wins),
               "points_per_s": len(lines) / wall, "wall_s": wall,
               "plain_wall_s": pwall,
               "median_window_ms": float(np.median(lat)),
               "p99_window_ms": _pct(lat, 99),
               "native_csv_parses": native_calls,
               "launches": {name: v for name, v in got.items() if v},
               "k4_table_launches": table_launches, "card": card}
        if mode == "realtime":
            row["selected_per_window"] = _pct(
                [sum(_selected(q) for q in w[2]) for w in wins], 50)
        else:
            row["selected"] = [[_selected(q) for q in w[2]] for w in wins]
        if spec.latency:
            row["record_latency_ms_p50"] = _pct(rec_lat, 50)
            row["record_latency_ms_p99"] = _pct(rec_lat, 99)
            row["record_latencies"] = len(rec_lat)
        if opt >= 51:
            row["first_list"] = wins[min(2, len(wins) - 1)][2][0][:3]
        log("main-path", json.dumps(row))
        report.append(row)
        torch.cuda.empty_cache()
    return launches, report


@contextlib.contextmanager
def decode_split():
    """Split the decode's time, on the host clock, into the native parser
    call, the interning of its ids (one string per distinct id of a
    chunk), the cell assignment (``PointChunk.build``), and the rest
    (joining and encoding the lines), by timing wrappers around the first
    three while the block runs."""
    from spatialflink_tpu_torch import native as ingest
    from spatialflink_tpu_torch.streams import bulk as B

    split = {"native_parse_s": 0.0, "intern_s": 0.0, "cells_s": 0.0}

    def timed(fn, key):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                split[key] += time.perf_counter() - t0
        return run
    lib = ingest.lib()
    parse, intern = lib.sf_parse_points_csv, B._intern_hashes
    build = B.PointChunk.__dict__["build"]
    lib.sf_parse_points_csv = timed(parse, "native_parse_s")
    B._intern_hashes = timed(intern, "intern_s")
    B.PointChunk.build = staticmethod(timed(build.__func__, "cells_s"))
    try:
        yield split
    finally:
        lib.sf_parse_points_csv = parse
        B._intern_hashes = intern
        B.PointChunk.build = build


def breakdown_phase(lines) -> dict:
    """Where the time goes, for the windowed options 6 and 51 (k = 50) and
    the realtime options 2 and 52 (k = 50): the main path's stages run one
    after another over the same stream, each timed on the host clock with
    the device synchronised at its end (the pipelined run overlaps them):
    the native CSV decode (4,096-row chunks windowed, 512-row realtime),
    window assembly or the micro-batch cut, batch build (with the id
    compaction of realtime kNN) and copy, device ops, readback and
    selection."""
    import torch

    from spatialflink_tpu_torch.driver import (CASES, ChunkedStream,
                                               _query_conf, decode_chunks)
    from spatialflink_tpu_torch.models import Point, Polygon
    from spatialflink_tpu_torch.operators import (PointGeomRangeQuery,
                                                  PointPointKNNQuery,
                                                  PointPointRangeQuery)

    params = base_params()
    grid = params.grids()[0]
    out = {}
    decoded = {}
    for chunk in (4096, N_MICRO):
        t0 = time.perf_counter()
        with decode_split() as split:
            chunks = list(decode_chunks(lines, params.input1, grid, chunk))
        decoded[chunk] = (chunks, time.perf_counter() - t0)
        split["other_s"] = decoded[chunk][1] - sum(split.values())
        log(f"decode split, chunks of {chunk}: {json.dumps(split)}")
        out[f"decode-split-{chunk}"] = split
    q = Point.create(116.5, 40.5, grid)
    for opt in (6, 51, 2, 52):
        conf = _query_conf(params, CASES[opt])
        chunks, decode_s = decoded[N_MICRO if opt in (2, 52) else 4096]
        if opt == 6:
            op = PointGeomRangeQuery(conf, grid, device="cuda")
            mask_stats = op._mask_stats_fn(
                Polygon.create([ring(64, 0.35)], grid), params.query.radius)
        elif opt == 2:
            op = PointPointRangeQuery(conf, grid, device="cuda")
            mask_stats = op._mask_stats_fn(q, params.query.radius)
        else:
            op = PointPointKNNQuery(conf, grid, device="cuda")
            local = op._knn_result([q], params.query.radius, 50, single=True)

        def build(recs, start):
            if opt in (51, 52):
                return op._knn_batch(recs, start)
            return op._point_batch(recs, start), None

        def device_ops(batch, recs, ids):
            if opt in (51, 52):
                res, evals = local(batch, len(ids))
                return op._defer_knn(res, ids, evals)
            mask, gn_c, evals = mask_stats(batch)
            return op._defer_mask_select(mask, recs, (gn_c, evals))
        stages = {"decode_s": decode_s, "assemble_s": 0.0,
                  "batch_h2d_s": 0.0, "device_ops_s": 0.0,
                  "readback_select_s": 0.0}
        t0 = time.perf_counter()
        wins = list(op._windows(ChunkedStream(iter(chunks))))
        stages["assemble_s"] = time.perf_counter() - t0
        for start, _end, recs in wins:
            t0 = time.perf_counter()
            batch, ids = build(recs, start)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            dfd = device_ops(batch, recs, ids)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            dfd.finish()
            t3 = time.perf_counter()
            stages["batch_h2d_s"] += t1 - t0
            stages["device_ops_s"] += t2 - t1
            stages["readback_select_s"] += t3 - t2
        total = sum(stages.values())
        stages.update(mode=conf.query_type.value, windows=len(wins),
                      decode_chunks=len(chunks), total_s=total,
                      decode_rows_per_s=len(lines) / decode_s,
                      shares={key: v / total for key, v in stages.items()
                              if key.endswith("_s")},
                      per_window_ms={key: v * 1e3 / len(wins)
                                     for key, v in stages.items()
                                     if key.endswith("_s")})
        log("breakdown", opt, json.dumps(stages))
        out[str(opt)] = stages
    return out


def profile_phase(lines, option: int) -> dict:
    """Option ``option`` (k = 50) over the stream once more under
    torch.profiler (CPU and CUDA activities): the device time by kind
    (kernels, copies, memsets) from the trace's events, and the device's
    busy share of the run's wall time. A trace without device events
    reports device_ms 0."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    params = base_params()
    params.query.option, params.query.k = option, 50
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, _, wall = run_pipeline(params, lines)
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
    out = {"option": option, "k": 50, "wall_s": wall, **by_kind,
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


# ------------------------------------------------------------------------ #
# the polygon / linestring streams (K5)

#: (option, multiQuery, k or None for the conf's, kernels its path runs)
#: over the whole geometry stream
GEOM_RUNS = [
    (16, False, None, ("geom_stream_dist",)),
    (21, False, None, ("geom_stream_dist",)),
    (41, False, None, ("geom_stream_dist",)),
    (66, False, None, ("geom_stream_dist", "knn_topk")),
    (71, False, None, ("geom_stream_dist", "knn_topk")),
    (91, False, None, ("geom_stream_dist", "knn_topk")),
    (21, True, None, ("geom_stream_dist",)),
    (71, True, None, ("geom_stream_dist", "knn_topk")),
    (22, False, None, ("geom_stream_dist",)),
    (72, False, None, ("geom_stream_dist", "knn_topk")),
]
#: the other polygon/linestring options, over the first N_GEOM_OTHER
#: geometries of their stream
GEOM_OTHER_RUNS = [
    (opt, False, None, ("geom_stream_dist",) if opt < 51
     else ("geom_stream_dist", "knn_topk"))
    for opt in (17, 26, 27, 31, 32, 36, 37, 42, 67, 76, 77, 81, 82, 86, 87,
                92)]


def geom_stream_lines(seed: int, n: int, kind: str):
    """n GeoJSON Features of one stream over the conf's bbox, timestamps
    spread evenly over SPAN_MS from T0, N_IDS object ids: Polygon rings of
    4-32 vertices with radii 0.002-0.02 degrees (building- to block-sized),
    or LineString walks of 2-16 segments with 0.004-degree steps."""
    rng = np.random.default_rng(seed)
    cx = rng.uniform(BBOX[0], BBOX[2], n)
    cy = rng.uniform(BBOX[1], BBOX[3], n)
    ts = (T0 + (np.arange(n, dtype=np.int64) * SPAN_MS) // n).tolist()
    oid = rng.integers(0, N_IDS, n).tolist()
    out = []
    if kind == "Polygon":
        k = rng.integers(4, 33, n)
        r = rng.uniform(0.002, 0.02, n)
        for i in range(n):
            th = np.sort(rng.uniform(0.0, 2.0 * np.pi, k[i]))
            xs = (cx[i] + r[i] * np.cos(th)).tolist()
            ys = (cy[i] + r[i] * np.sin(th)).tolist()
            xs.append(xs[0])
            ys.append(ys[0])
            coords = ", ".join(f"[{a!r}, {b!r}]" for a, b in zip(xs, ys))
            out.append('{"geometry": {"type": "Polygon", "coordinates": '
                       f'[[{coords}]]}}, "properties": {{"oID": '
                       f'"o{oid[i]}", "timestamp": {ts[i]}}}, '
                       '"type": "Feature"}')
        return out
    k = rng.integers(2, 17, n)
    for i in range(n):
        walk = (rng.normal(0.0, 0.004, (k[i] + 1, 2)).cumsum(axis=0)
                + (cx[i], cy[i])).tolist()
        coords = ", ".join(f"[{a!r}, {b!r}]" for a, b in walk)
        out.append('{"geometry": {"type": "LineString", "coordinates": '
                   f'[{coords}]}}, "properties": {{"oID": "o{oid[i]}", '
                   f'"timestamp": {ts[i]}}}, "type": "Feature"}}')
    return out


def geom_params():
    """The geometry phase's config: GeoJSON input, the point stream's query
    sets with the conf's own 4-edge polygon first (the 15 64-edge rings
    after it)."""
    from spatialflink_tpu_torch.config import Params

    base = base_params()
    base = dataclasses.replace(
        base, input1=dataclasses.replace(base.input1, format="GeoJSON"))
    base.query.query_polygons = (
        Params.from_yaml(CONF).query.query_polygons[:1]
        + query_polygons()[1:])
    return base


def decode_geoms(lines, kind: str):
    """The stream's lines through the driver's decode (per-record parse,
    4,096-record chunks): (geometry objects, seconds)."""
    from spatialflink_tpu_torch.driver import decode_chunks

    params = geom_params()
    t0 = time.perf_counter()
    chunks = list(decode_chunks(lines, params.input1, params.grids()[0],
                                4096, geometry=kind))
    objs = [r for c in chunks for r in c.records]
    return objs, time.perf_counter() - t0


def k5_work(gb, dist, kind, grid_cells, queries=None, approximate=False):
    """(operations, bytes) K5 needs for this launch's inputs: the rule
    reads every geometry's cells, validity and kind, the query rows of the
    two cell masks and the queries; the distance reads the consulted
    geometries' edge masks and valid edges (each consulted geometry once,
    whatever the number of queries consulting it) and computes, per
    consulted (query, geometry), its valid edges against the query's
    (point: OPS_PER_POINT_EDGE each; geometry: OPS_PER_EDGE_PAIR per edge
    pair, and the vertex tests against an areal geometry); it writes a flag
    and a distance per (query, geometry) and two counts per query."""
    import torch

    from spatialflink_tpu_torch.ops import geom as G

    consulted = torch.isfinite(dist)  # (Q, G): where a distance was needed
    n_valid = gb.edge_mask.sum(dim=1).double()  # (G,)
    n_q, n_g = dist.shape
    per_q = (consulted.double() * n_valid[None]).sum(dim=1)  # (Q,)
    if approximate:
        ops = float(consulted.sum()) * 10
    elif kind == "point":
        ops = float(per_q.sum()) * G.OPS_PER_POINT_EDGE
    else:
        qv = queries.edge_mask.sum(dim=1).double()
        areal = (consulted.double() * (n_valid * gb.is_areal)[None]) \
            .sum(dim=1)
        ops = float((per_q * qv).sum()) * G.OPS_PER_EDGE_PAIR + \
            float((areal * qv).sum()) * G.OPS_PER_VERTEX_EDGE
    any_c = consulted.any(dim=0)
    nbytes = (n_g * (gb.cells.shape[1] * 5 + 2)
              + float(any_c.sum()) * gb.edge_mask.shape[1]
              + float((any_c.double() * n_valid).sum()) * 16
              + n_q * grid_cells * 2 + n_q * n_g * 5 + n_q * 8)
    if kind == "point":
        nbytes += n_q * 8
    else:
        nbytes += n_q * (queries.edges.shape[1] * 17 + 17)
    return ops, nbytes


def geom_kernel_phase(torch, timer: Timer, polys, lines):
    """K5 against its plain version, bit for bit, at one window of the
    polygon stream (its first WINDOW_GEOMS geometries, the size of a 10 s
    window) and at one realtime micro-batch of N_MICRO, in range and kNN
    mode: the conf's point (options 16/66), the conf's polygon (21/71) and
    16 query polygons (multiQuery 21/71) over polygons, the conf's
    linestring over linestrings (41/91), approximate mode once. Returns
    the cases."""
    from spatialflink_tpu_torch.models import EdgeGeomBatch
    from spatialflink_tpu_torch.ops import geom as G
    from spatialflink_tpu_torch.utils import IdInterner

    dev = torch.device("cuda")
    params = geom_params()
    grid = params.grids()[0]
    r = params.query.radius
    qpoint = params.query_point_objects(grid)[:1]
    qpolys = params.query_polygon_objects(grid)
    qlines = params.query_linestring_objects(grid)[:1]

    def masks(qs):
        cells = [[q.cell] if hasattr(q, "x") else sorted(q.cells)
                 for q in qs]
        return tuple(torch.from_numpy(np.stack([f(r, c) for c in cells]))
                     .to(dev) for f in (grid.guaranteed_cells_mask,
                                        grid.neighboring_cells_mask))

    def batch(objs):
        t0 = time.perf_counter()
        b = EdgeGeomBatch.from_objects(objs, device=dev,
                                       interner=IdInterner())
        torch.cuda.synchronize()
        return b, time.perf_counter() - t0

    window, build_poly = batch(polys[:WINDOW_GEOMS])
    lwin, build_line = batch(lines[:WINDOW_GEOMS])
    micro, _ = batch(polys[:N_MICRO])
    log(f"K5 window batches: {WINDOW_GEOMS} polygons in "
        f"{build_poly:.3f} s ({build_poly / WINDOW_GEOMS * 1e6:.2f} us "
        f"each), linestrings in {build_line:.3f} s; edges "
        f"{tuple(window.edges.shape)} / {tuple(lwin.edges.shape)}")
    cases = []
    setups = [
        ("polygons-x-conf-point", window, qpoint, "point", False, 25),
        ("polygons-x-conf-polygon", window, qpolys[:1], "geometry", False,
         25),
        ("polygons-x-16-polygons", window, qpolys, "geometry", False, 2),
        ("linestrings-x-conf-linestring", lwin, qlines, "geometry", False,
         25),
        ("polygons-x-conf-polygon-approx", window, qpolys[:1], "geometry",
         True, 25),
        ("micro-polygons-x-conf-polygon", micro, qpolys[:1], "geometry",
         False, 25),
        ("micro-polygons-x-conf-point", micro, qpoint, "point", False, 25),
    ]
    for name, gb, qs, kind, approx, plain_reps in setups:
        gn, nb = masks(qs)
        if kind == "point":
            kw = dict(qx=torch.tensor([q.x for q in qs], dtype=torch.float32,
                                      device=dev),
                      qy=torch.tensor([q.y for q in qs], dtype=torch.float32,
                                      device=dev))
        else:
            kw = dict(queries=EdgeGeomBatch.from_objects(qs, device=dev,
                                                         pad=len(qs)))
        for mode, label in ((G.MODE_RANGE, "range"), (G.MODE_KNN, "knn")):
            if approx and mode == G.MODE_KNN:
                continue
            args = dict(mode=mode, nb=nb, gn=gn if mode == G.MODE_RANGE
                        else None, radius=r, approximate=approx, **kw)
            got = G.geom_stream_dist(gb, **args)
            ops, nbytes = k5_work(gb, got[1], kind, nb.shape[1],
                                  kw.get("queries"), approx)
            case, got = kernel_case(
                timer, torch, f"{name}-{label}",
                lambda a=args, gb=gb: G.geom_stream_dist(gb, **a),
                lambda a=args, gb=gb: G.geom_stream_dist_plain(gb, **a),
                ops, nbytes, "K5", plain_reps=plain_reps,
                geometries=int(gb.valid.sum()), queries=len(qs),
                edges_padded=int(gb.edges.shape[1]),
                consulted=int(torch.isfinite(got[1]).sum()),
                counts=[[int(v) for v in row] for row in got[2].cpu()])
            case["launch_to_completion_ms"] = launch_ms(
                torch, lambda a=args, gb=gb: G.geom_stream_dist(gb, **a))
            cases.append(case)
    if G.geom_stream_dist.launches <= 0:
        raise AssertionError("geom_stream_dist launched no kernel")
    return cases, {"window_build_s_polygons": build_poly,
                   "window_build_s_linestrings": build_line}


def geom_main_phase(card: str, streams, runs, limit=None):
    """Each run of ``runs`` through run_option on the card over its
    stream's parsed geometries (the first ``limit``), then again with K5
    and K2 swapped for their plain versions: equal per-window results and
    the launch counters non-zero for every kernel of the run's path."""
    import torch

    from spatialflink_tpu_torch.driver import CASES
    from spatialflink_tpu_torch.ops import geom as G
    from spatialflink_tpu_torch.ops import knn as K

    base = geom_params()
    counters = {"geom_stream_dist": G.geom_stream_dist,
                "knn_topk": K.knn_topk}
    plain_ops = {(G, "geom_stream_dist"): G.geom_stream_dist_plain,
                 (K, "knn_topk"): K.knn_topk_plain}
    launches = dict.fromkeys(counters, 0)
    report = []
    for opt, multi, k, path in runs:
        spec = CASES[opt]
        objs = streams[spec.stream][:limit]
        query = dataclasses.replace(base.query, option=opt, multi_query=multi,
                                    k=k or base.query.k)
        params = dataclasses.replace(base, query=query)
        label = f"{opt}{'-multi' if multi else ''}"
        for fn in counters.values():
            fn.launches = 0
        wins, lat, _, wall = run_pipeline(params, objs)
        got = {name: fn.launches for name, fn in counters.items()}
        for name in counters:
            launches[name] += got[name]
        if any(got[name] <= 0 for name in path):
            raise AssertionError(f"option {label}: kernels of its path not "
                                 f"launched {got}")
        saved = {key: getattr(*key) for key in plain_ops}
        try:
            for (mod, name), fn in plain_ops.items():
                setattr(mod, name, fn)
            pwins, _, _, pwall = run_pipeline(params, objs)
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
        if not sum(_selected(q) for w in wins for q in w[2]):
            raise AssertionError(f"option {label}: nothing selected")
        row = {"option": opt, "stream": spec.stream, "query": spec.query,
               "mode": spec.mode, "multi_query": multi,
               "queries": len(wins[0][2]),
               "k": query.k if opt >= 51 else None, "geometries": len(objs),
               "windows": len(wins), "geometries_per_s": len(objs) / wall,
               "wall_s": wall, "plain_wall_s": pwall,
               "median_window_ms": float(np.median(lat)),
               "p99_window_ms": _pct(lat, 99),
               "launches": {name: v for name, v in got.items() if v},
               "card": card}
        if spec.mode == "realtime":
            row["selected_per_window"] = _pct(
                [sum(_selected(q) for q in w[2]) for w in wins], 50)
        else:
            row["selected"] = [[_selected(q) for q in w[2]] for w in wins]
        if opt >= 51:
            row["first_list"] = wins[min(2, len(wins) - 1)][2][0][:3]
        log("geom-path", json.dumps(row))
        report.append(row)
        torch.cuda.empty_cache()
    return launches, report


def geom_lines_phase(card: str, lines, objs) -> dict:
    """Option 21 once more from the polygon stream's GeoJSON lines (the
    whole path, the per-record parse included) against the run over the
    parsed objects: the same windows."""
    params = geom_params()
    params.query.option = 21
    wins, lat, _, wall = run_pipeline(params, lines)
    owins, _, _, owall = run_pipeline(params, objs)
    if len(wins) != len(owins) or not all(
            a[:2] == b[:2] and len(a[2][0]) == len(b[2][0])
            and all(x.obj_id == y.obj_id and x.timestamp == y.timestamp
                    for x, y in zip(a[2][0], b[2][0]))
            for a, b in zip(wins, owins)):
        raise AssertionError("option 21 from the lines differs from the run "
                             "over the parsed objects")
    row = {"option": 21, "from": "GeoJSON lines", "geometries": len(lines),
           "windows": len(wins), "geometries_per_s": len(lines) / wall,
           "wall_s": wall, "objects_wall_s": owall,
           "median_window_ms": float(np.median(lat)),
           "p99_window_ms": _pct(lat, 99), "card": card}
    log("geom-path", json.dumps(row))
    return row


def geom_profile_phase(objs, option: int) -> dict:
    """Option ``option`` over the parsed polygon stream under
    torch.profiler: device time by kind and the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    params = geom_params()
    params.query.option = option
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, _, wall = run_pipeline(params, objs)
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
    out = {"option": option, "geometries": len(objs), "wall_s": wall,
           **by_kind, "device_ms": device_ms,
           "busy_share": device_ms / (wall * 1e3),
           "top": sorted(top.items(), key=lambda kv: -kv[1])[:6]}
    log("profile", json.dumps(out))
    return out


def geom_cli_phase(lines) -> None:
    """The CLI on a GeoJSON polygon file (option 21, the conf's queries):
    stdout must equal an in-process run over the same lines."""
    from spatialflink_tpu_torch.config import Params
    from spatialflink_tpu_torch.driver import _emit, run_option

    class Lines:
        def __init__(self):
            self.out = io.StringIO()

        def emit(self, record):
            print(record, file=self.out)

    build = os.path.join(ROOT, "spatialflink_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = os.path.join(tmp, "polygons.geojson")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        proc = subprocess.run(
            [sys.executable, "-m", "spatialflink_tpu_torch.driver",
             "--config", CONF, "--option", "21", "--input1", path,
             "--format", "GeoJSON", "--device", "cuda"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"CLI exit {proc.returncode}: {proc.stderr}")
        params = Params.from_yaml(CONF)
        params.query.option = 21
        sink = Lines()
        for w in run_option(params, lines, device="cuda"):
            _emit(w, sink)
        want = sink.out.getvalue()
        if proc.stdout != want or not want:
            raise AssertionError(f"CLI option 21 stdout {proc.stdout[:200]!r}"
                                 f" != in-process {want[:200]!r}")
        log(f"cli: option 21 over {len(lines)} GeoJSON polygons -> "
            f"{want.count(chr(10))} windows, stdout equals the in-process "
            f"run ({want.splitlines()[0]})")


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

    # the kernels (nvcc) and the ingest (g++), all started together
    compile_s = phase("build", native.build,
                      (*native.SOURCES, *native.HOST_SOURCES))
    log(f"build: per source {json.dumps(compile_s)}")
    build_report = {name: native.ptxas_report(native.build_log(name))
                    for name in native.SOURCES}
    timer = Timer(torch)
    k4_cases, k1_cases, batch = phase("kernels-k4-k1", kernel_phase, torch,
                                      args.seed, timer)
    k4x_cases, order_case, rows = phase("kernels-k4x", lattice_phase, torch,
                                        timer, batch)
    k1q_cases = phase("kernels-k1-query-axis", k1_query_axis_phase, torch,
                      timer, batch, rows)
    k2_cases = phase("kernels-k2", knn_kernel_phase, torch, args.seed, timer,
                     rows)
    del batch, rows
    torch.cuda.empty_cache()
    micro = phase("kernels-micro-batch", micro_kernel_phase, torch,
                  args.seed, timer)
    phase("reference", reference_phase, torch, args.seed)
    t0 = time.perf_counter()
    lines = stream_lines(args.seed, N_STREAM)
    log(f"stream: {len(lines)} CSV rows over {SPAN_MS} ms "
        f"({time.perf_counter() - t0:.1f} s to generate)")
    launches, report = phase("main-path", main_path_phase, card, lines, RUNS)
    rt_launches, rt_report = phase("realtime", main_path_phase, card, lines,
                                   REALTIME_RUNS)
    short_launches, short_report = phase(
        "realtime-short", main_path_phase, card, lines[:N_SHORT],
        SHORT_REALTIME_RUNS)
    from spatialflink_tpu_torch.config import WindowConfig
    count_launches, count_report = phase(
        "count-windows", main_path_phase, card, lines[:COUNT_SIZE],
        COUNT_RUNS, WindowConfig(type="COUNT", interval_s=COUNT_SIZE,
                                 step_s=COUNT_SLIDE))
    rt_report += short_report
    breakdown = phase("breakdown", breakdown_phase, lines)
    # option 52's trace over the shorter stream: the profiler's own event
    # processing grows with the 4 launches and 10 copies per micro-batch
    prof = {"51": phase("profile-51", profile_phase, lines, 51),
            "52": phase("profile-52", profile_phase, lines[:N_SHORT], 52)}
    del lines
    phase("cli", cli_phase, args.seed)

    # the polygon and linestring streams
    t0 = time.perf_counter()
    glines = {kind: geom_stream_lines(args.seed + 5 + i, N_GEOM, kind)
              for i, kind in enumerate(("Polygon", "LineString"))}
    log(f"geometry streams: {N_GEOM} GeoJSON polygons and linestrings each "
        f"over {SPAN_MS} ms ({time.perf_counter() - t0:.1f} s to generate)")
    geoms, geom_host = {}, {}
    for kind, kind_lines in glines.items():
        geoms[kind], sec = phase(f"decode-{kind}", decode_geoms, kind_lines,
                                 kind)
        geom_host[f"decode_s_{kind}"] = sec
        geom_host[f"decode_us_per_record_{kind}"] = sec / N_GEOM * 1e6
        log(f"decode {kind}: {len(geoms[kind])} records in {sec:.3f} s "
            f"({sec / N_GEOM * 1e6:.2f} us per record)")
    k5_cases, build = phase("kernels-k5", geom_kernel_phase, torch, timer,
                            geoms["Polygon"], geoms["LineString"])
    geom_host.update(build)
    geom_launches, geom_report = phase("geom-path", geom_main_phase, card,
                                       geoms, GEOM_RUNS)
    other_launches, other_report = phase(
        "geom-other", geom_main_phase, card, geoms, GEOM_OTHER_RUNS,
        N_GEOM_OTHER)
    geom_report.append(phase("geom-lines", geom_lines_phase, card,
                             glines["Polygon"], geoms["Polygon"]))
    prof["71"] = phase("profile-71", geom_profile_phase, geoms["Polygon"], 71)
    phase("cli-geom", geom_cli_phase, glines["Polygon"][:N_GEOM_CLI])
    del glines, geoms
    for more in (rt_launches, short_launches, count_launches, geom_launches,
                 other_launches):
        for name in KERNELS:
            launches[name] += more.get(name, 0)
    micro["geom_stream_dist"] = [c for c in k5_cases
                                 if c["case"].startswith("micro-")]

    def entry(name, source, replaces, cases, main_case, shape):
        """One kernel's entry: its main-path case at the window shape,
        and its micro-batch cases (the realtime path's shape) under
        ``micro_batch``."""
        cases = cases + micro.get(name, [])
        out = {"name": name, "route": "cuda", "source": source,
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": max(c["max_abs_err"] for c in cases),
               "ms": main_case["ms"], "plain_ms": main_case["plain_ms"],
               "bound_ms": main_case["bound_ms"],
               "bound_by": main_case["bound_by"],
               "library_ms": None, "library_note": NO_LIB,
               "shape": shape, "cases": cases}
        if micro.get(name):
            out["micro_batch"] = {
                key: micro[name][0][key] for key in
                ("case", "ms", "launch_to_completion_ms", "plain_ms",
                 "bound_ms", "bound_by")}
        return out

    kernels = [
        entry("pip_dist", "spatialflink_tpu_torch/csrc/pip_dist.cu",
              "spatialflink_tpu/ops/pallas_kernels.py:195", k4_cases,
              k4_cases[1], f"{N_KERNEL} points x 64 edges, per-cell table "
              "(as the main path calls it)"),
        entry("range_mask_stats", "spatialflink_tpu_torch/csrc/range_mask.cu",
              "spatialflink_tpu/ops/range.py:72", k1_cases + k1q_cases,
              k1_cases[0], f"{N_KERNEL} points, point query, no distances "
              "(as the main path calls it)"),
        entry("knn_topk", "spatialflink_tpu_torch/csrc/knn_topk.cu",
              "spatialflink_tpu/ops/knn.py:385", k2_cases, k2_cases[0],
              f"{N_KERNEL} points, {N_IDS} object ids, k=50, point query"),
        entry("pip_lattice", "spatialflink_tpu_torch/csrc/pip_lattice.cu",
              "benchmarks/exp_pip_lattice.py:112", k4x_cases, k4x_cases[0],
              f"{N_KERNEL} points x {N_QUERIES} polygons of 64 edges + 1 "
              "linestring"),
    ]
    # K4's bound counts the pairs its table folds; the dense pairs' bound
    # is the yardstick of the runs before the table
    kernels[0]["fold_share"] = k4_cases[1]["fold_share"]
    kernels[0]["dense_bound_ms"] = k4_cases[1]["dense_bound_ms"]
    kernels[2]["library_note"] = (
        "no single PyTorch call computes the per-object dedup and the "
        "top-k; torch.topk without the dedup is a different function")
    kernels[3]["library_note"] = (
        "no single PyTorch call computes the point x geometry lattice")
    # the cell order is part of K4x: pip_lattice launches it on the main
    # path, and K4x's "ms" includes it
    order = entry("cell_order", "spatialflink_tpu_torch/csrc/cell_order.cu",
                  "benchmarks/exp_pip_lattice.py:112", [order_case],
                  order_case, f"{N_KERNEL} points, "
                  f"{_grid().num_cells} cells")
    order["library_note"] = ("no single PyTorch call: the plain version "
                             "is a torch.where, torch.argsort(stable=True) "
                             "and two gathers")
    kernels[3]["helpers"] = [order]
    window_k5 = [c for c in k5_cases if not c["case"].startswith("micro-")]
    k5 = entry("geom_stream_dist", "spatialflink_tpu_torch/csrc/geom_dist.cu",
               "spatialflink_tpu/ops/geom.py:126", window_k5,
               next(c for c in window_k5
                    if c["case"] == "polygons-x-conf-polygon-range"),
               f"{WINDOW_GEOMS} polygons of 4-32 edges x the conf's polygon, "
               "range mode (option 21's window)")
    k5["library_note"] = ("no single PyTorch call computes the geometry "
                          "distances with the cell rule")
    kernels.append(k5)
    phases["total"] = time.perf_counter() - t_all
    log("build-report", json.dumps(build_report))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels, "card": card,
                      "main_path": report + rt_report + count_report,
                      "geom_path": geom_report + other_report,
                      "geom_host": geom_host, "breakdown": breakdown,
                      "profile": prof, "phases_s": phases}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
