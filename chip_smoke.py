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
   one distance (k = 1,024), 3,000 objects at one distance (k = 50), 30
   ids (k = 50) and k = 2,048 (the list sorted as runs that merge across
   blocks). Then every kernel of the realtime path at one
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
   distance) lists in order). The realtime runs follow over the stream's
   first 262,144 points (512 micro-batches of 512; cut from the whole
   stream to make room for the join kernel cases): options 2, 7, 12, 52
   (k = 50), 57 and 62, the windowed latency variants 8 and 58 and the
   realtime latency variants 9 and 59; over the same points, multiQuery
   2 and 52 (16 points), 7 and 57 (16 polygons) and 12 (4 linestrings);
   over its first 262,144 points,
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
   over the parsed stream's first 131,072 geometries, and the other 16
   geometry options over its first 65,536, each through ``run_option`` over the
   parsed objects and again with K5 and K2 swapped for their plain
   versions (equal results; K5, and K2 for kNN, launched). The parse
   runs once per stream: at ~150 us per polygon record on the host of an
   H100 machine, parsing in every run would not fit the time limit;
   option 21 runs once more from the polygon stream's first 65,536 lines
   (the whole path) and must give the windows of its run over the parsed
   objects. Option 71 once more under torch.profiler, and the CLI runs
   option 21 from a 16,384-line GeoJSON file against an in-process run
   over the same lines.
5. Panes and the standing-query plane. K3 through its parts entry
   ``knn_merge_parts`` (the partials where they lie, as the device merge
   passes them) against its plain version bit for bit at (panes, queries,
   k) = (2, 1, 50) (option 51's window under panes), (2, 16, 50), (10,
   16, 50), (4, 1, 1,024), (60, 1, 100), (16, 2, 1,024) and (10, 1,
   2,048) (rows wider than one block), on ties at the k-th place, 64
   objects over every pane and all-invalid rows, and over partials of
   real K2 launches (option 51's 1 s panes of a 10 s window, 16 queries),
   each with its CUDA-event time, launch-to-completion time and bound.
   Then options 1 and 51 (k = 50) and multiQuery 1 and 51 (16 points)
   over the point stream with ``query.panes``, multiQuery 51 once more at
   10 s / 1 s windows (10 panes a window), 51 at k = 2,048 at 10 s / 1 s
   (K2's and K3's paths for k > 1,024), and options 21 and 71 over 32,768 parsed
   polygons spread over the 20 s (every eighth): each under the device
   merge (K3 launched once per window) and, for kNN, the host merge (no
   K3 launch), and under the device merge with every kernel swapped for
   its plain version, all equal window for window, and equal to the
   panes-off run (the main path's run of the option where there is one;
   kNN identical, range as sets). Then the dynamic plane (``run_dynamic``
   through run_option from a live registry): options 1 and 51 over the
   point stream and 16 and 31 over 32,768 polygons and linestrings spread
   the same way, with five seed queries (bucket 8), three admitted (8),
   one more (16), then six retired (4), each change landing at the window
   it was scripted for; the run equal to its plain-kernel run, and each
   query's windows equal to its dedicated run (a single-query run over
   the same decoded chunks; for a geometry stream the row of one static
   run_multi of the nine queries), with records/s and the median and p99
   wall time per window. Last, the CLI runs option 51 with
   ``--queries-file`` (five queries, one on a ``file:`` route) on the
   65,536-row CSV against an in-process run of the same fleet.
6. The spatial joins at a radius of 0.002 degrees, against four seeded
   query streams over the same 20 s (16,384 and 256 CSV query points:
   8,192 and 128 per window; 1,024 GeoJSON polygons and linestrings
   shaped as the geometry streams: 512 per window). K7 ``join_reduce`` at
   262,144 x 8,192 points (its join index built inside the call), K6
   ``join_lattice`` on the rows K7 finds partners for (over K7's index)
   and at 262,144 x 256 (the sparse stream's capacity, the direct
   branch), the same two with both sides clustered (Gaussian, sigma 0.03
   degrees), K7 at the conf's radius 0.5 and K6 there at 8,192 x 8,192,
   K6 at realtime 102's per-cut shapes (512 x 2,048 and 65,536 x 256)
   (``join_setups``), the join index of the dense and the sparse query
   window (the cell order's sort with its start table) against its plain
   version, K4x at 262,144 points x 512 query polygons and K5
   at 65,536 polygons x 512 query polygons in kNN mode over the queries'
   neighbouring-cells masks (the geometry join's form), each against its
   plain version bit for bit with its CUDA-event time,
   launch-to-completion time and bound (K6 and K7: the distance on the
   pairs inside the cell layers, from a cell histogram, and the join
   index's bytes).
   Then every join option through ``run_option``: 101 over the point
   stream with the dense query points (K7 then K6: more than 2**26
   capacity pairs) and with the sparse ones (K6 alone), 106, 108, 111
   over the point stream, 116, 121, 126, 131, 136 and 141 over the
   geometry streams' first 65,536, and the realtime 102-142 and 109 over
   the point stream's first 65,536 points or the geometry streams' first
   4,096 and the query records of the same span, each again with K6, K7,
   K4x and K5 swapped for their plain versions (the same pairs in every
   window, in order; the launch counters non-zero for the run's path),
   with pairs/s, pairs per window and the median and p99 wall time per
   window. Then option 101's stages one after another, its trace under
   torch.profiler, and the CLI for 101 with ``--input2``.
7. The trajectory queries over T-Drive's taxi count (the stream and
   K8's kernel cases run right after the micro-batch phase, before the
   long torch.profiler traces; the runs here): the port's
   ``SyntheticPointSource`` with 10,357 taxis (T-Drive, Microsoft
   Research's Beijing taxi traces) of 50 points 400 ms apart over the
   conf's grid (517,850 points over 20 s; 1 % up to 2 s late; the event
   time compressed from T-Drive's ~3-minute sampling), as CSV lines, and
   a 320-taxi query stream for tJoin. K8a ``tstats_update`` at the 10 s
   window (258,924 points, fresh 16,384-slot state), at a 512-point cut
   (the state of the 64 cuts before it) and at the one-block limit
   (4,096 points from the cut on), with the ts range the operators pass,
   K8b ``tstats_window_summary`` at a 5 s pane, the cut and the limit
   (with its range too), K8c ``taggregate_group_extents`` at the window,
   the cut and the limit, and K8d ``taggregate_heatmap`` (every
   aggregate, ``torch.Tensor.scatter_reduce_`` beside SUM, MIN and MAX) at
   the window and a cut, each against its plain version bit for bit with
   its CUDA-event time, launch-to-completion time, bound and the kernels
   torch.profiler counts in one call (``launches``; K8a's, K8b's and K8c's
   must be what their key layout says: one at a cut, six at the window or
   the pane; K8d's one). Then
   options 201-212, 2030, 2090, 2011, 208 with SUM and ALL, 206 and 208
   (SUM) with panes, 211/212 under multiQuery (16 points) and 99 through
   ``run_option`` (windowed over the whole stream, realtime over its
   first 65,536 points and the query records of that span; tJoin at
   radius 0.002, tKNN at 0.05), each again with every kernel swapped for
   its plain version (equal results; the runs of 201, 202 and 207 launch
   no kernel and run once), the launch counters non-zero for every
   kernel of the run's path; 206 with panes against 206 (the same
   objects and temporal lengths, spatial lengths within 4 * 2**-23 of
   the window's total), 208 SUM with panes against 208 SUM (equal
   heatmaps); then 206 and 205 under torch.profiler beside their decode
   alone.
8. Output: the build report, the card line, one JSON ``kernels`` line
   (K4x's entry holds the cell order under ``helpers``, with the joins'
   index under its ``join``; K5's the window cases and its micro-batch
   cases; K4x's and K5's their join cases, also under ``join``; K7, K6,
   K3, and K8a-K8d with their 512-point cut under ``micro_batch``), and
   as the last line
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
N_GEOM_RUNS = 1 << 17             # geometries of the GEOM_RUNS and 71's profile
N_GEOM_OTHER = 1 << 16            # geometries of the options run once
N_GEOM_SPREAD = 1 << 15           # geometries of the pane and dynamic runs
N_GEOM_LINES = 1 << 16            # lines of option 21's run from the lines
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


def k2_specs(torch, seed: int, lattice_rows):
    """K2's cases at 1,048,576 points and 100,000 object ids: [(name, k,
    keyword arguments of the kernel call, obj_id included)], and the ids
    of the window's points (the ties case's check reads them)."""
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
        # k > 1,024: the list sorted as runs that merge across blocks
        ("point-k2048", 2048, dict(point_kw, qx=q1[0], qy=q1[1],
                                   q_cell=q1[2], nb_layers=nb_layers)),
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
    for name, pb, k, ids in (("same-distance-100000ids-k1024", same, 1024,
                              N_IDS),
                             ("same-distance-3000ids-k50", near, 50, N_IDS),
                             ("30ids-k50", few, 50, 30)):
        specs.append((name, k, dict(
            mode=K.MODE_POINT, num_ids=ids, x=pb.x, y=pb.y, cell=pb.cell,
            valid=pb.valid, n=grid.n, qx=tie[0], qy=tie[1], q_cell=tie[2],
            nb_layers=grid.n, obj_id=pb.obj_id)))
    return [(name, k, {"obj_id": b.obj_id, **kw}) for name, k, kw in specs], \
        oid


def knn_kernel_phase(torch, seed: int, timer: Timer, lattice_rows):
    """K2 at 1,048,576 points and 100,000 object ids (``k2_specs``)."""
    from spatialflink_tpu_torch.ops import knn as K

    specs, oid = k2_specs(torch, seed, lattice_rows)
    n = specs[0][2]["x"].shape[0]
    cases = []
    for name, k, kw in specs:
        kw = dict(kw)
        ids_t = kw.pop("obj_id")
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
#: (512 micro-batches), as the REALTIME_RUNS: the script keeps within its
#: time limit
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
           "cell_order", "geom_stream_dist", "join_reduce", "join_lattice",
           "knn_merge")


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
    payload per query], the fleet's query ids or None), per-window
    latencies (ms), the records' ``latency_ms`` (latency variants) and
    wall seconds."""
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
                     [_payload(r) for r in per_query],
                     w.extras.get("query_ids")))
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


#: per-window results of the main path's windowed runs over the whole
#: point stream, by (option, multiQuery, k): the pane phase's panes-off
#: references
FULL_WINDOWS: dict = {}


def main_path_phase(card: str, lines, runs, window=None):
    """Each run of ``runs`` through run_option on the card, then again with
    every kernel swapped for its plain version: equal per-window results,
    the launch counters non-zero for every kernel of the run's path, and
    one native parser call per decode chunk in both runs. ``window``
    replaces the conf's window block (count windows). The windowed runs
    over the whole stream are kept in :data:`FULL_WINDOWS`."""
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
        if mode == "window" and len(lines) == N_STREAM:
            FULL_WINDOWS[(opt, multi, query.k)] = wins
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


def trace_device(run) -> dict:
    """``run()`` (which returns its wall seconds) under torch.profiler (CPU
    and CUDA activities): the device time by kind (kernels, copies,
    memsets) from the trace's events, and the device's busy share of the
    run's wall time. A trace without device events reports device_ms 0."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall = run()
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
    return {"wall_s": wall, **by_kind, "device_ms": device_ms,
            "busy_share": device_ms / (wall * 1e3),
            "top": sorted(top.items(), key=lambda kv: -kv[1])[:6]}


def profile_phase(lines, option: int) -> dict:
    """Option ``option`` (k = 50) over the stream once more under
    torch.profiler (:func:`trace_device`)."""
    params = base_params()
    params.query.option, params.query.k = option, 50
    out = {"option": option, "k": 50,
           **trace_device(lambda: run_pipeline(params, lines)[3])}
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
#: over the geometry stream's first N_GEOM_RUNS
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


def k5_setups(torch, polys, lines):
    """K5's cases at the main path's shapes: one 10 s window of the polygon
    stream (its first WINDOW_GEOMS geometries) and of the linestring
    stream, and one realtime micro-batch of N_MICRO polygons; the conf's
    point (options 16/66), the conf's polygon (21/71) and 16 query polygons
    (multiQuery 21/71) over polygons, the conf's linestring over
    linestrings (41/91), approximate mode once; range and kNN mode each.
    Returns ``(cases, window build seconds)``, a case being ``(name, batch,
    geom_stream_dist's keyword arguments, query kind, plain repetitions,
    number of queries)``."""
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
    cases = []
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
            cases.append((f"{name}-{label}", gb, args, kind, plain_reps,
                          len(qs)))
    return cases, {"window_build_s_polygons": build_poly,
                   "window_build_s_linestrings": build_line}


def geom_kernel_phase(torch, timer: Timer, polys, lines):
    """K5 against its plain version, bit for bit, in every case of
    :func:`k5_setups`, with its CUDA-event time, launch-to-completion time
    and bound. Returns the cases."""
    from spatialflink_tpu_torch.ops import geom as G

    setups, build = k5_setups(torch, polys, lines)
    cases = []
    for name, gb, args, kind, plain_reps, n_queries in setups:
        got = G.geom_stream_dist(gb, **args)
        ops, nbytes = k5_work(gb, got[1], kind, args["nb"].shape[1],
                              args.get("queries"), args["approximate"])
        case, got = kernel_case(
            timer, torch, name,
            lambda a=args, gb=gb: G.geom_stream_dist(gb, **a),
            lambda a=args, gb=gb: G.geom_stream_dist_plain(gb, **a),
            ops, nbytes, "K5", plain_reps=plain_reps,
            geometries=int(gb.valid.sum()), queries=n_queries,
            edges_padded=int(gb.edges.shape[1]),
            consulted=int(torch.isfinite(got[1]).sum()),
            counts=[[int(v) for v in row] for row in got[2].cpu()])
        case["launch_to_completion_ms"] = launch_ms(
            torch, lambda a=args, gb=gb: G.geom_stream_dist(gb, **a))
        cases.append(case)
    if G.geom_stream_dist.launches <= 0:
        raise AssertionError("geom_stream_dist launched no kernel")
    return cases, build


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
    torch.profiler (:func:`trace_device`)."""
    params = geom_params()
    params.query.option = option
    out = {"option": option, "geometries": len(objs),
           **trace_device(lambda: run_pipeline(params, objs)[3])}
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


# ------------------------------------------------------------------------ #
# panes (K3) and the standing-query plane

#: (option, multiQuery, k or None for the conf's, window (interval s,
#: step s) or None for the conf's 10 s / 5 s, kernels of its path) of the
#: pane runs over the point stream
PANE_RUNS = [
    (1, False, None, None, ("range_mask_stats",)),
    (51, False, 50, None, ("knn_topk", "knn_merge")),
    (1, True, None, None, ("range_mask_stats",)),
    (51, True, 50, None, ("knn_topk", "knn_merge")),
    (51, True, 50, (10, 1), ("knn_topk", "knn_merge")),
    (51, False, 2048, (10, 1), ("knn_topk", "knn_merge")),
]
#: the pane runs over N_GEOM_SPREAD parsed polygons spread over the 20 s
GEOM_PANE_RUNS = [
    (21, False, None, None, ("geom_stream_dist",)),
    (71, False, None, None, ("geom_stream_dist", "knn_topk", "knn_merge")),
]
#: the K3 cases: (name, panes, queries, k, id pool, distances drawn from
#: (None: uniform; "K2": partials of K2 launches over option 51's panes),
#: share of valid slots)
K3_CASES = [
    ("51-window", 2, 1, 50, N_IDS, None, 1.0),
    ("51-multi-window", 2, N_QUERIES, 50, N_IDS, None, 1.0),
    ("51-multi-10-panes", 10, N_QUERIES, 50, N_IDS, None, 1.0),
    ("k1024", 4, 1, 1024, N_IDS, None, 1.0),
    ("60-panes", 60, 1, 100, N_IDS, None, 1.0),
    ("ties", 10, N_QUERIES, 50, N_IDS, (0.25, 0.5), 1.0),
    ("duplicates", 10, N_QUERIES, 50, 64, None, 1.0),
    ("all-invalid", 4, N_QUERIES, 50, N_IDS, None, 0.0),
    ("two-tiles", 16, 2, 1024, N_IDS, None, 0.9),
    ("k2048", 10, 1, 2048, N_IDS, None, 1.0),
    ("51-k2-partials-10s-1s", 10, N_QUERIES, 50, N_IDS, "K2", 1.0),
]
#: the dynamic fleet: five seed points, then three admitted (bucket 8),
#: one more (bucket 16), then six retired (bucket 4)
DYN_SEEDS = 5
DYN_ADMIT, DYN_ADMIT_MORE, DYN_RETIRE = 3, 1, 6


def k2_partials(torch, seed: int, panes: int, k: int):
    """(P, Q, k) partials of K2 launches as option 51's device merge gets
    them: one launch per 1 s pane of the stream's points (N_STREAM over
    SPAN_MS), the 16 query points, the conf's radius, N_IDS ids."""
    from spatialflink_tpu_torch.models import Point, PointBatch
    from spatialflink_tpu_torch.ops import knn as K

    dev = torch.device("cuda")
    grid = _grid()
    nb_layers = grid.candidate_layers(base_params().query.radius)
    pts = [Point.create(px_, py_, grid) for px_, py_ in query_points()]
    q = [torch.tensor([getattr(p, a) for p in pts], dtype=dt, device=dev)
         for a, dt in (("x", torch.float32), ("y", torch.float32),
                       ("cell", torch.int32))]
    rng = np.random.default_rng(seed + 37)
    per = N_STREAM * 1000 // SPAN_MS
    out = []
    for _ in range(panes):
        b = PointBatch.from_arrays(
            rng.uniform(BBOX[0], BBOX[2], per),
            rng.uniform(BBOX[1], BBOX[3], per), device=dev, grid=grid,
            obj_id=rng.integers(0, N_IDS, per).astype(np.int32))
        out.append(K.knn_topk(b.obj_id, mode=K.MODE_POINT, k=k,
                              num_ids=N_IDS, x=b.x, y=b.y, cell=b.cell,
                              valid=b.valid, qx=q[0], qy=q[1], q_cell=q[2],
                              n=grid.n, nb_layers=nb_layers)[:3])
    return [torch.stack([o[f] for o in out]) for f in range(3)]


def k3_inputs(torch, seed: int, cases=None):
    """[(name, panes, queries, k, [obj_id, dist, valid] (P, Q, k) on the
    card)] of ``cases`` (by default K3_CASES)."""
    from spatialflink_tpu_torch.ops import knn as K

    rng = np.random.default_rng(seed + 31)
    out = []
    for name, p, q, k, ids, dists, share in cases or K3_CASES:
        shape = (p, q, k)
        if dists == "K2":
            out.append((name, p, q, k, k2_partials(torch, seed, p, k)))
            continue
        oid = rng.integers(0, ids, shape).astype(np.int32)
        d = (rng.uniform(0.0, 0.5, shape) if dists is None
             else rng.choice(np.asarray(dists), shape)).astype(np.float32)
        # a K2 partial lists its valid slots first, by distance
        d.sort(axis=2)
        valid = np.arange(k)[None, None, :] < np.round(share * k)
        valid = np.broadcast_to(valid, shape).copy()
        oid = np.where(valid, oid, K._OID_SENTINEL).astype(np.int32)
        d = np.where(valid, d, np.float32(K._BIG)).astype(np.float32)
        out.append((name, p, q, k, [torch.from_numpy(a).cuda()
                                    for a in (oid, d, valid)]))
    return out


def k3_phase(torch, seed: int, timer: Timer):
    """K3 through its parts entry ``knn_merge_parts`` (each pane's
    partial where it lies) against its plain version over the stack, bit
    for bit, at the pane merges' shapes (option 51's window: 2 panes x k =
    50, 1 and 16 queries; 10 panes; k = 1,024; 60 panes of k = 100; rows
    of 16 blocks; k = 2,048), on ties at the k-th place (distances drawn
    from two values: the pane lists come unsorted by key), one object in
    many panes and rows of invalid slots, and over K2's own partials:
    each with its CUDA-event time, launch-to-completion time and bound
    (P*Q*k*9 bytes read, Q*k*9 written). The plain version is timed over
    the stacked partials (the stacks made outside the timed call)."""
    from spatialflink_tpu_torch.ops import knn as K

    cases = []
    for name, p, q, k, args in k3_inputs(torch, seed):
        parts = [K.KnnResult(*(t[i] for t in args)) for i in range(p)]
        n = p * q * k
        case, got = kernel_case(
            timer, torch, name, lambda: K.knn_merge_parts(parts, k),
            lambda: K.merge_topk_stacked_plain(*args, k), 2 * n,
            9 * n + 9 * q * k, "k3", panes=p, queries=q, k=k)
        case["launch_to_completion_ms"] = launch_ms(
            torch, lambda: K.knn_merge_parts(parts, k))
        case["valid_slots"] = int(got.valid.sum())
        cases.append(case)
    return cases


def _plain_kernels():
    """{(module, name): plain version} of every kernel the pane and
    dynamic runs can reach."""
    from spatialflink_tpu_torch.ops import geom as G
    from spatialflink_tpu_torch.ops import hopper_kernels as HK
    from spatialflink_tpu_torch.ops import knn as K
    from spatialflink_tpu_torch.ops import range as R

    return {
        (R, "range_filter_point_stats"): R.range_filter_point_stats_plain,
        (R, "range_filter_point_multi_masks"):
            R.range_filter_point_multi_masks_plain,
        (R, "range_filter_masks_stats"): R.range_filter_masks_stats_plain,
        (HK, "pip_dist"): HK.pip_dist_plain,
        (K, "knn_topk"): K.knn_topk_plain,
        (K, "knn_merge_parts"): K.merge_topk_parts_plain,
        (G, "geom_stream_dist"): G.geom_stream_dist_plain,
    }


def _counters():
    from spatialflink_tpu_torch.ops import geom as G
    from spatialflink_tpu_torch.ops import knn as K
    from spatialflink_tpu_torch.ops import range as R

    return {"range_mask_stats": R.range_mask_stats, "knn_topk": K.knn_topk,
            "knn_merge": K.knn_merge, "geom_stream_dist": G.geom_stream_dist}


def _counted_run(params, records, plain=False):
    """run_pipeline with every launch counter zeroed before and read after
    (and, with ``plain``, every kernel swapped for its plain version):
    (windows, latencies, wall s, launches)."""
    counters = _counters()
    for fn in counters.values():
        fn.launches = 0
    saved = {}
    if plain:
        saved = {key: getattr(*key) for key in _plain_kernels()}
        for (mod, name), fn in _plain_kernels().items():
            setattr(mod, name, fn)
    try:
        wins, lat, _, wall = run_pipeline(params, records)
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    return wins, lat, wall, {n: fn.launches for n, fn in counters.items()}


def _as_set(payload):
    """A range window's selection in an order-free form: the (x, y, ts,
    oid) columns sorted, or the geometry objects' identities sorted."""
    if payload and isinstance(payload[0], np.ndarray):
        order = np.lexsort(payload[::-1])
        return [a[order] for a in payload]
    return sorted(id(r) for r in payload)


def pane_phase(card: str, runs, records, base, full_windows=None):
    """Each run of ``runs`` with ``query.panes`` through run_option on the
    card, under the device merge and (kNN) under the host merge, and
    under the device merge with every kernel swapped for its plain
    version, against the panes-off run (``full_windows``' run of the same
    option over ``records`` where there is one): the device-merge run
    equal to the plain
    and the host-merge runs window for window, and to the panes-off run
    (kNN identical, range as sets); K3 launched once per window under the
    device merge and never under the host merge. A range run has no
    device merge: its panes concatenate on the host either way."""
    import torch

    launches = dict.fromkeys(KERNELS, 0)
    report = []
    for opt, multi, k, window, path in runs:
        query = dataclasses.replace(base.query, option=opt, multi_query=multi,
                                    k=k or base.query.k, panes=True,
                                    pane_device_merge=True)
        params = dataclasses.replace(base, query=query)
        if window is not None:
            params = dataclasses.replace(params, window=dataclasses.replace(
                params.window, interval_s=window[0], step_s=window[1]))
        label = (f"{opt}{'-multi' if multi else ''}-panes"
                 f"{'-%ds/%ds' % window if window else ''}")
        wins, lat, wall, got = _counted_run(params, records)
        for name in got:
            launches[name] += got[name]
        if any(got[name] <= 0 for name in path):
            raise AssertionError(f"{label}: kernels of its path not "
                                 f"launched {got}")
        if opt >= 51 and got["knn_merge"] != len(wins):
            raise AssertionError(f"{label}: {got['knn_merge']} K3 launches "
                                 f"for {len(wins)} windows")
        pwins, _, pwall, pgot = _counted_run(params, records, plain=True)
        if any(pgot.values()):
            raise AssertionError(f"{label}: the plain run launched {pgot}")
        checks = [(pwins, "plain")]
        row = {}
        if opt >= 51:
            query.pane_device_merge = False
            hwins, hlat, hwall, hgot = _counted_run(params, records)
            if hgot["knn_merge"]:
                raise AssertionError(f"{label}: the host merge launched K3")
            checks.append((hwins, "host-merge"))
            row.update(host_merge_wall_s=hwall,
                       host_merge_median_window_ms=float(np.median(hlat)),
                       host_merge_launches={n: v for n, v in hgot.items()
                                            if v})
        owins = (full_windows or {}).get((opt, multi, query.k)) \
            if window is None else None
        if owins is None:
            query.panes = False
            owins, olat, owall, ogot = _counted_run(params, records)
            row.update(panes_off_wall_s=owall,
                       panes_off_median_window_ms=float(np.median(olat)),
                       panes_off_launches={n: v for n, v in ogot.items()
                                           if v})
        for other, what in checks:
            if [w[:2] for w in other] != [w[:2] for w in wins]:
                raise AssertionError(f"{label}: windows differ from the "
                                     f"{what} run")
            for a, b in zip(wins, other):
                if not _equal(a[2], b[2]):
                    raise AssertionError(f"{label} window {a[:2]}: result "
                                         f"differs from the {what} run")
        if [w[:2] for w in owins] != [w[:2] for w in wins]:
            raise AssertionError(f"{label}: windows differ with panes off")
        for a, b in zip(wins, owins):
            same = (_equal(a[2], b[2]) if opt >= 51 else all(
                _equal(_as_set(u), _as_set(v)) for u, v in zip(a[2], b[2])))
            if not same:
                raise AssertionError(f"{label} window {a[:2]}: result "
                                     "differs from the panes-off run")
        if not sum(_selected(q) for w in wins for q in w[2]):
            raise AssertionError(f"{label}: nothing selected")
        row = {"option": opt, "multi_query": multi, "label": label,
               "window_s": list(window or (base.window.interval_s,
                                           base.window.step_s)),
               "queries": len(wins[0][2]),
               "k": query.k if opt >= 51 else None,
               "records": len(records), "windows": len(wins),
               "records_per_s": len(records) / wall, "wall_s": wall,
               "plain_wall_s": pwall,
               "median_window_ms": float(np.median(lat)),
               "p99_window_ms": _pct(lat, 99), **row,
               "panes_off_from_main_path": "panes_off_wall_s" not in row,
               "launches": {n: v for n, v in got.items() if v},
               "selected": [[_selected(q) for q in w[2]] for w in wins],
               "card": card}
        log("panes", json.dumps(row))
        report.append(row)
        torch.cuda.empty_cache()
    return launches, report


def _dyn_points(n):
    """The dynamic fleet's query points: DYN_SEEDS seeds, then the
    admissions, spread over the bbox."""
    rng = np.random.default_rng(103)
    return [(float(x), float(y)) for x, y in zip(
        rng.uniform(115.8, 117.3, n), rng.uniform(39.8, 40.9, n))]


def _dyn_script(n: int, lateness_s: int):
    """(record index, change) of the scripted fleet over ``n`` records
    spread over SPAN_MS: each change one decode chunk after the record
    that seals the window ending at 5, 10 and 15 s (its end plus the
    lateness), so it lands on the next window."""
    def after(end_s):
        return int((end_s + lateness_s) * 1000 / SPAN_MS * n) + 4096

    seeds = DYN_SEEDS
    more = seeds + DYN_ADMIT
    return [(after(5), [("admit", f"q{i}") for i in range(seeds, more)]),
            (after(10), [("admit", f"q{more}")]),
            (after(15), [("retire", f"q{i}") for i in range(DYN_RETIRE)])]


def _fleet_run(params, records, family, points, script, plain=False):
    """One dynamic run through run_option with the scripted fleet:
    (windows, latencies, wall s, launches, the registry)."""
    from spatialflink_tpu_torch.runtime.queryplane import QueryRegistry

    reg = QueryRegistry(family, radius=params.query.radius,
                        k=params.query.k)
    for i in range(DYN_SEEDS):
        reg.admit({"id": f"q{i}", "x": points[i][0], "y": points[i][1]})
    reg.apply()
    params.query_registry = reg
    todo = {at: changes for at, changes in script}

    def churn():
        for i, rec in enumerate(records):
            for op, qid in todo.get(i, ()):
                if op == "admit":
                    j = int(qid[1:])
                    reg.admit({"id": qid, "x": points[j][0],
                               "y": points[j][1]})
                else:
                    reg.retire(qid)
            yield rec

    try:
        wins, lat, wall, got = _counted_run(params, churn(), plain=plain)
    finally:
        del params.query_registry
    return wins, lat, wall, got, reg


def dynamic_phase(card: str, runs, base):
    """Options 1 and 51 over the point stream and 16 and 31 over a
    geometry stream from a live registry (``run_dynamic`` through
    run_option), the fleet scripted as ``_dyn_script`` says: every
    window's fleet as scripted, each query's windows equal to its
    dedicated single-query run (over the same decoded chunks, through the
    operator API) and the whole run equal to one with every kernel
    swapped for its plain version; records/s and the median and p99 wall
    time per window."""
    import torch

    from spatialflink_tpu_torch import operators as ops
    from spatialflink_tpu_torch.driver import (CASES, ChunkedStream,
                                               _query_conf, decode_chunks)
    from spatialflink_tpu_torch.models import Point

    launches = dict.fromkeys(KERNELS, 0)
    report = []
    n_q = DYN_SEEDS + DYN_ADMIT + DYN_ADMIT_MORE
    points = _dyn_points(n_q)
    for opt, records, path in runs:
        spec = CASES[opt]
        query = dataclasses.replace(base.query, option=opt, k=50)
        params = dataclasses.replace(base, query=query)
        script = _dyn_script(len(records), base.query.allowed_lateness_s)
        wins, lat, wall, got, reg = _fleet_run(params, records, spec.family,
                                               points, script)
        for name in got:
            launches[name] += got[name]
        if any(got[name] <= 0 for name in path):
            raise AssertionError(f"dynamic {opt}: kernels of its path not "
                                 f"launched {got}")
        pwins, _, pwall, pgot, _ = _fleet_run(params, records, spec.family,
                                              points, script, plain=True)
        if any(pgot.values()):
            raise AssertionError(f"dynamic {opt}: the plain run launched "
                                 f"{pgot}")
        fleets = [len(w[3] or ()) for w in wins]
        want = [DYN_SEEDS, DYN_SEEDS + DYN_ADMIT, n_q, n_q - DYN_RETIRE,
                n_q - DYN_RETIRE]
        if fleets != want:
            raise AssertionError(f"dynamic {opt}: fleets {fleets}, "
                                 f"scripted {want}")
        if [(w[:2], w[3]) for w in pwins] != [(w[:2], w[3]) for w in wins] \
                or not all(_equal(a[2], b[2]) for a, b in zip(wins, pwins)):
            raise AssertionError(f"dynamic {opt}: differs from the plain "
                                 "run")
        # each query's windows against its dedicated run: a single-query
        # run over the same decoded chunks for a point stream; for a
        # geometry stream one static run_multi of all the queries (its
        # rows are the queries' own runs: K5 computes each row alone)
        t0 = time.perf_counter()
        grid = params.grids()[0]
        chunks = list(decode_chunks(records, params.input1, grid, 4096,
                                    geometry=spec.stream))
        cls = getattr(ops, f"{spec.stream}{spec.query}"
                           f"{'KNN' if spec.family == 'knn' else 'Range'}"
                           "Query")
        extra = (query.k,) if opt >= 51 else ()
        qpts = [Point.create(x, y, grid) for x, y in points]
        if spec.stream == "Point":
            ded = []
            for q in qpts:
                op = cls(_query_conf(params, spec), grid, device="cuda")
                ded.append({w.window_start: _payload(w.records) for w in
                            op.run(ChunkedStream(iter(chunks)), q,
                                   query.radius, *extra)})
        else:
            op = cls(_query_conf(params, spec), grid, device="cuda")
            ded = [{} for _ in qpts]
            for w in op.run_multi(ChunkedStream(iter(chunks)), qpts,
                                  query.radius, *extra):
                for j, recs in enumerate(w.records):
                    ded[j][w.window_start] = _payload(recs)
        for j in range(n_q):
            seen = 0
            for start, _, per_query, ids in wins:
                if f"q{j}" in ids:
                    seen += 1
                    if not _equal(per_query[ids.index(f"q{j}")],
                                  ded[j][start]):
                        raise AssertionError(f"dynamic {opt}: q{j} window "
                                             f"{start} differs from its "
                                             "dedicated run")
            if not seen:
                raise AssertionError(f"dynamic {opt}: q{j} never served")
        ded_s = time.perf_counter() - t0
        row = {"option": opt, "records": len(records), "windows": len(wins),
               "fleet_per_window": fleets,
               "fleet_version": reg.fleet_version,
               "records_per_s": len(records) / wall, "wall_s": wall,
               "plain_wall_s": pwall, "dedicated_check_s": ded_s,
               "median_window_ms": float(np.median(lat)),
               "p99_window_ms": _pct(lat, 99),
               "launches": {n: v for n, v in got.items() if v},
               "selected": [[_selected(q) for q in w[2]] for w in wins],
               "card": card}
        log("dynamic", json.dumps(row))
        report.append(row)
        torch.cuda.empty_cache()
    return launches, report


def queries_cli_phase(seed: int) -> None:
    """The CLI with ``--queries-file`` (option 51, five queries, one on a
    ``file:`` route) on the 65,536-row CSV: stdout equal to an in-process
    run of the same fleet, and the route's JSON lines equal to the
    in-process router's."""
    from spatialflink_tpu_torch.driver import (CASES, _emit, _seed_registry,
                                               run_option)
    from spatialflink_tpu_torch.runtime.queryplane import QueryRouter

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
        out = {}
        for side in ("cli", "in-process"):
            specs = [{"id": f"q{i}", "x": x, "y": y}
                     for i, (x, y) in enumerate(_dyn_points(5))]
            specs[1]["route"] = f"file:{os.path.join(tmp, side)}.jsonl"
            qpath = os.path.join(tmp, f"{side}.json")
            with open(qpath, "w") as f:
                json.dump(specs, f)
            out[side] = qpath
        proc = subprocess.run(
            [sys.executable, "-m", "spatialflink_tpu_torch.driver",
             "--config", CONF, "--option", "51", "--input1", path,
             "--format", "CSV", "--queries-file", out["cli"], "--device",
             "cuda"], cwd=ROOT, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"CLI exit {proc.returncode}: {proc.stderr}")
        params = base_params()
        params.query.option = 51
        params.query_registry = _seed_registry(params, CASES[51],
                                               out["in-process"])
        router = QueryRouter(params.query_registry)
        sink = Lines()
        for w in run_option(params, lines, device="cuda"):
            _emit(w, sink)
            router.route(w)
        router.close()
        want = sink.out.getvalue()
        if proc.stdout != want or "'query_ids': ['q0'" not in want:
            raise AssertionError(f"CLI --queries-file stdout "
                                 f"{proc.stdout[:200]!r} != in-process "
                                 f"{want[:200]!r}")
        routed = [open(os.path.join(tmp, f"{s}.jsonl")).read()
                  for s in ("cli", "in-process")]
        if routed[0] != routed[1] or not routed[0]:
            raise AssertionError("CLI --queries-file: the file: route's "
                                 "lines differ from the in-process run's")
        log(f"cli: option 51 --queries-file over {N_CLI} CSV rows -> "
            f"{want.count(chr(10))} windows, stdout and the file: route "
            f"({routed[0].count(chr(10))} lines) equal the in-process run")


# ------------------------------------------------------------------------ #
# the spatial joins (K7 and K6; K4x and K5 in their join forms)

JOIN_RADIUS = 0.002       # degrees: ~220 m, about one point-stream partner
N_QPOINTS = 1 << 14       # query points of the dense join stream
N_QSPARSE = 256           # query points of the sparse join stream
N_QGEOMS = 1 << 10        # query polygons, and query linestrings
N_JOIN_GEOMS = 1 << 16    # geometries of the windowed geometry joins
N_JOIN_RT = 1 << 16       # points of the realtime point joins
N_JOIN_RT_GEOMS = 1 << 12  # geometries of the realtime geometry joins
JOIN_KERNELS = ("join_reduce", "join_lattice", "pip_lattice", "cell_order",
                "geom_stream_dist")
#: (option, stream 1, query stream, kernels its path launches); stream 1
#: is the point stream's lines or the parsed polygons / linestrings
#: (their first N_JOIN_GEOMS), the query streams are CSV / GeoJSON lines
JOIN_RUNS = [
    (101, "points", "qpoints", ("join_reduce", "join_lattice", "cell_order")),
    (101, "points", "qsparse", ("join_lattice", "cell_order")),
    (106, "points", "qPolygon", ("pip_lattice", "cell_order")),
    (108, "points", "qPolygon", ("pip_lattice", "cell_order")),
    (111, "points", "qLineString", ("pip_lattice", "cell_order")),
    (116, "Polygon", "qsparse", ("pip_lattice", "cell_order")),
    (121, "Polygon", "qPolygon", ("geom_stream_dist",)),
    (126, "Polygon", "qLineString", ("geom_stream_dist",)),
    (131, "LineString", "qsparse", ("pip_lattice", "cell_order")),
    (136, "LineString", "qPolygon", ("geom_stream_dist",)),
    (141, "LineString", "qLineString", ("geom_stream_dist",)),
]
#: the realtime joins over the streams' first N_JOIN_RT points or
#: N_JOIN_RT_GEOMS geometries and the query records of the same time span
JOIN_RT_RUNS = [
    (102, "points", "qpoints", ("join_lattice", "cell_order")),
    (107, "points", "qPolygon", ("pip_lattice",)),
    (109, "points", "qPolygon", ("pip_lattice",)),
    (112, "points", "qLineString", ("pip_lattice",)),
    (117, "Polygon", "qpoints", ("pip_lattice",)),
    (122, "Polygon", "qPolygon", ("geom_stream_dist",)),
    (127, "Polygon", "qLineString", ("geom_stream_dist",)),
    (132, "LineString", "qpoints", ("pip_lattice",)),
    (137, "LineString", "qPolygon", ("geom_stream_dist",)),
    (142, "LineString", "qLineString", ("geom_stream_dist",)),
]


def join_query_streams(seed: int) -> dict:
    """The join's query streams over the same 20 s: 16,384 and 256 CSV
    query points (8,192 and 128 per 10 s window), and 1,024 GeoJSON
    polygons and linestrings (512 per window) shaped as the geometry
    streams are."""
    return {"qpoints": stream_lines(seed + 20, N_QPOINTS),
            "qsparse": stream_lines(seed + 21, N_QSPARSE),
            "qPolygon": geom_stream_lines(seed + 22, N_QGEOMS, "Polygon"),
            "qLineString": geom_stream_lines(seed + 23, N_QGEOMS,
                                             "LineString")}


def join_params(option: int, stream: str, query: str):
    """The conf with the join radius, CSV points and GeoJSON geometries."""
    from spatialflink_tpu_torch.config import Params

    p = Params.from_yaml(CONF)
    p.query.option = option
    p.query.radius = JOIN_RADIUS
    fmt = {"points": "CSV", "qpoints": "CSV", "qsparse": "CSV"}
    return dataclasses.replace(
        p, input1=dataclasses.replace(p.input1,
                                      format=fmt.get(stream, "GeoJSON")),
        input2=dataclasses.replace(p.input2, format=fmt.get(query,
                                                            "GeoJSON")))


def _pair_keys(recs):
    return [(a.obj_id, a.timestamp, b.obj_id, b.timestamp) for a, b in recs]


def run_join(params, s1, s2):
    """One join run on the card: per-window (start, end, pair keys), the
    per-window wall times (ms), the pairs' latency_ms and wall seconds."""
    import torch

    from spatialflink_tpu_torch.driver import run_option

    torch.cuda.synchronize()
    t_start = time.perf_counter()
    it = iter(run_option(params, s1, s2, device="cuda"))
    wins, lat, rec_lat = [], [], []
    while True:
        t0 = time.perf_counter()
        try:
            w = next(it)
        except StopIteration:
            break
        lat.append((time.perf_counter() - t0) * 1e3)
        wins.append((w.window_start, w.window_end, w.records))
        rec_lat.extend(w.extras.get("latency_ms", ()))
    wall = time.perf_counter() - t_start
    return ([(s, e, _pair_keys(r)) for s, e, r in wins], lat, rec_lat,
            wall)


def _join_counters():
    from spatialflink_tpu_torch.ops import geom as G
    from spatialflink_tpu_torch.ops import hopper_kernels as HK
    from spatialflink_tpu_torch.ops import join as J

    return {"join_reduce": J.join_reduce, "join_lattice": J.join_lattice,
            "pip_lattice": HK.pip_lattice, "cell_order": HK.cell_order,
            "geom_stream_dist": G.geom_stream_dist}


@contextlib.contextmanager
def join_plain_versions():
    """Every kernel of the join paths swapped for its plain version."""
    from spatialflink_tpu_torch.ops import geom as G
    from spatialflink_tpu_torch.ops import hopper_kernels as HK
    from spatialflink_tpu_torch.ops import join as J

    # join_pairs_host hands both kernels the window's join index
    plain = {(J, "join_index"): J.join_index_plain,
             (J, "join_reduce"):
                 lambda *a, index=None, **kw: J.join_reduce_plain(*a, **kw),
             (J, "join_lattice"):
                 lambda *a, index=None, **kw: J.join_lattice_plain(*a, **kw),
             (HK, "pip_lattice"):
                 lambda *a, **_: HK.pip_lattice_plain(*a).T.contiguous(),
             (G, "geom_stream_dist"): G.geom_stream_dist_plain}
    saved = {key: getattr(*key) for key in plain}
    try:
        for (mod, name), fn in plain.items():
            setattr(mod, name, fn)
        yield
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def join_main_phase(card: str, streams: dict, runs, realtime=False):
    """Each join run through run_option on the card, then again with every
    kernel swapped for its plain version: the same pairs in each window,
    in order, and the launch counters non-zero for every kernel of the
    run's path (option 101 over the sparse query stream: K6 without K7)."""
    import torch

    from spatialflink_tpu_torch.driver import CASES

    counters = _join_counters()
    launches = dict.fromkeys(counters, 0)
    report = []
    for opt, s_key, q_key, path in runs:
        spec = CASES[opt]
        s1, s2 = streams[s_key], streams[q_key]
        if realtime:  # a prefix of both streams over the same time span
            share = (N_JOIN_RT / N_STREAM if s_key == "points"
                     else N_JOIN_RT_GEOMS / N_GEOM)
            s1 = s1[:N_JOIN_RT if s_key == "points" else N_JOIN_RT_GEOMS]
            s2 = s2[:max(1, int(len(s2) * share))]
        elif s_key != "points":
            s1 = s1[:N_JOIN_GEOMS]
        params = join_params(opt, s_key, q_key)
        for fn in counters.values():
            fn.launches = 0
        wins, lat, rec_lat, wall = run_join(params, s1, s2)
        got = {name: fn.launches for name, fn in counters.items()}
        for name in counters:
            launches[name] += got[name]
        if any(got[name] <= 0 for name in path):
            raise AssertionError(f"join {opt} ({q_key}): kernels of its path "
                                 f"not launched {got}")
        if opt == 101 and q_key == "qsparse" and got["join_reduce"]:
            raise AssertionError("join 101 over the sparse query stream "
                                 "launched K7 below the lattice budget")
        with join_plain_versions():
            pwins, _, _, pwall = run_join(params, s1, s2)
        if {name: fn.launches for name, fn in counters.items()} != got:
            raise AssertionError("the plain run launched a kernel")
        if wins != pwins or not wins:
            raise AssertionError(f"join {opt} ({q_key}): pairs differ from "
                                 "the plain run")
        pairs = [len(w[2]) for w in wins]
        if not sum(pairs):
            raise AssertionError(f"join {opt} ({q_key}): no pair")
        if spec.latency and len(rec_lat) != sum(pairs):
            raise AssertionError(f"join {opt}: {len(rec_lat)} latencies for "
                                 f"{sum(pairs)} pairs")
        row = {"option": opt, "stream": s_key, "query": q_key,
               "mode": spec.mode, "records": len(s1), "query_records":
               len(s2), "windows": len(wins), "pairs": sum(pairs),
               "pairs_per_s": sum(pairs) / wall,
               "records_per_s": len(s1) / wall,
               "median_pairs_per_window": float(np.median(pairs)),
               "median_window_ms": float(np.median(lat)),
               "p99_window_ms": _pct(lat, 99), "wall_s": wall,
               "plain_wall_s": pwall,
               "launches": {name: v for name, v in got.items() if v},
               "card": card}
        if spec.latency:
            row["record_latency_ms_p50"] = _pct(rec_lat, 50)
            row["record_latency_ms_p99"] = _pct(rec_lat, 99)
        log("join-path", json.dumps(row))
        report.append(row)
        torch.cuda.empty_cache()
    return launches, report


def _pairs_in_layers(a, b, layers: int, n: int, rows=None) -> int:
    """The (a, b) pairs of valid points whose cells lie within ``layers``
    of each other (the pairs that reach the distance test), from a cell
    histogram of b and its box sums."""
    import torch

    bc = b.cell[b.valid & (b.cell >= 0)].long()
    hist = torch.bincount(bc, minlength=n * n).reshape(n, n).double()
    s = torch.zeros((n + 1, n + 1), dtype=torch.float64, device=hist.device)
    s[1:, 1:] = hist.cumsum(0).cumsum(1)
    ok = a.valid & (a.cell >= 0)
    ac = a.cell.long()
    if rows is not None:
        sel = torch.zeros_like(ok)
        sel[rows.long()] = True
        ok &= sel
    ac = ac[ok]
    cx, cy = ac // n, ac % n
    x0, x1 = (cx - layers).clamp(0, n), (cx + layers + 1).clamp(0, n)
    y0, y1 = (cy - layers).clamp(0, n), (cy + layers + 1).clamp(0, n)
    return int((s[x1, y1] - s[x0, y1] - s[x1, y0] + s[x0, y0]).sum())


#: bytes of the join index per b point (perm, key, x, y; its start table
#: adds 4 per entry), and the operations that form one key (three
#: compares, two selects, a division, a multiply and an add)
JOIN_INDEX_BYTES = 16
JOIN_INDEX_OPS = 8


def join_setups(torch, grid, dev=None) -> list:
    """The K7 and K6 cases of the join kernel phase and of kernel_ab.py's
    K6/K7 comparison, as dicts (kernel, name, a, b, radius, layers, rows,
    index): option 101's window (262,144 stream points x 8,192 query
    points, uniform over the bbox, radius 0.002): K7 with the index built
    inside it, then K6 on the rows K7 keeps over that index (built once,
    as join_pairs_host shares it); the sparse stream's window (262,144 x
    256, K6 alone, index included); both sides clustered (Gaussian around
    (116.40, 39.90), sigma 0.03 degrees, as taxi traces bunch downtown);
    the conf's radius 0.5 (24 cell layers): K7 at the window and K6 at
    8,192 x 8,192 (a quarter of the pairs pass); realtime 102's per-cut
    shapes (512 new stream points x the 2,048-point query buffer; the
    65,536-point stream buffer x 16 new query points)."""
    from spatialflink_tpu_torch.models import PointBatch
    from spatialflink_tpu_torch.ops import join as J

    dev = torch.device("cuda") if dev is None else dev
    n = grid.n
    rng = np.random.default_rng(31)

    def uniform(k):
        return PointBatch.from_arrays(rng.uniform(BBOX[0], BBOX[2], k),
                                      rng.uniform(BBOX[1], BBOX[3], k),
                                      device=dev, grid=grid)

    def clustered(k):
        return PointBatch.from_arrays(rng.normal(116.40, 0.03, k),
                                      rng.normal(39.90, 0.03, k),
                                      device=dev, grid=grid)

    def head(p, k):
        return type(p)(*(t[:k] for t in p))

    out = []

    def k7_k6(tag, a, b, radius, rows_too=True):
        layers = grid.candidate_layers(radius)
        pre_r = float(np.sqrt(radius * radius + 1e-5))
        out.append(dict(kernel="join_reduce",
                        name=f"{tag}{a.capacity}x{b.capacity}", a=a, b=b,
                        radius=pre_r, layers=layers, rows=None, index=None))
        if rows_too:
            cnt, _, _ = J.join_reduce_plain(a, b, pre_r, layers, n=n)
            rows = torch.nonzero(cnt > 0).reshape(-1).to(torch.int32)
            out.append(dict(kernel="join_lattice",
                            name=f"{tag}rows{rows.numel()}x{b.capacity}",
                            a=a, b=b, radius=radius, layers=layers,
                            rows=rows, index=J.join_index(b, n)))

    def k6(tag, a, b, radius):
        out.append(dict(kernel="join_lattice",
                        name=f"{tag}{a.capacity}x{b.capacity}", a=a, b=b,
                        radius=radius, layers=grid.candidate_layers(radius),
                        rows=None, index=None))

    a, b = uniform(N_STREAM // 2), uniform(N_QPOINTS // 2)
    k7_k6("", a, b, JOIN_RADIUS)
    k6("", a, uniform(N_QSPARSE // 2), JOIN_RADIUS)
    k7_k6("clustered-", clustered(N_STREAM // 2), clustered(N_QPOINTS // 2),
          JOIN_RADIUS)
    k7_k6("r0.5-", a, b, 0.5, rows_too=False)
    k6("r0.5-", head(a, b.capacity), b, 0.5)
    k6("rt102-", uniform(N_MICRO), uniform(2048), JOIN_RADIUS)
    k6("rt102-", uniform(N_JOIN_RT), uniform(16), JOIN_RADIUS)
    return out


def join_calls(torch, grid, s):
    """(kernel call, plain call, operations, bytes, extra) of one
    join_setups case. The bound counts what the inputs need: the distance
    on the pairs inside the cell layers (a cell histogram), each point read
    once, the outputs written once, and the join index's bytes with its
    start table (and its keys' operations where the call builds it)."""
    from spatialflink_tpu_torch.ops import join as J

    n = grid.n
    a, b, radius, layers = s["a"], s["b"], s["radius"], s["layers"]
    rows, index = s["rows"], s["index"]
    nb = b.capacity
    m = a.capacity if rows is None else rows.numel()
    in_layers = _pairs_in_layers(a, b, layers, n, rows=rows)
    starts = J.index_layout(nb, n, J.JOIN_TILE)[3]
    nbytes = (m + nb) * 13 + nb * JOIN_INDEX_BYTES + starts * 4
    ops = 0 if index is not None else nb * JOIN_INDEX_OPS
    extra = dict(pairs_in_layers=in_layers, layers=layers, radius=radius,
                 index="shared" if index is not None else "included")
    if s["kernel"] == "join_reduce":
        return (lambda: J.join_reduce(a, b, radius, layers, n=n),
                lambda: J.join_reduce_plain(a, b, radius, layers, n=n),
                ops + in_layers * J.OPS_K7_DIST, nbytes + m * 12, extra)
    cx, cy = J.grid_center(grid)
    pairs = int(J.join_lattice(a, b, radius, layers, cx, cy, n=n, rows=rows,
                               index=index)[0].numel())
    extra.update(rows=m, pairs=pairs)
    return (lambda: J.join_lattice(a, b, radius, layers, cx, cy, n=n,
                                   rows=rows, index=index),
            lambda: J.join_lattice_plain(a, b, radius, layers, cx, cy, n=n,
                                         rows=rows),
            ops + in_layers * J.OPS_K6_DIST,
            nbytes + (0 if rows is None else m * 4) + pairs * 8, extra)


def join_kernel_phase(torch, timer: Timer, streams: dict, polys):
    """The join index of option 101's dense and sparse query windows, K7
    and K6 at join_setups' cases (option 101's window, the sparse
    stream's, clustered sides, the conf's radius 0.5, realtime 102's
    per-cut shapes), K4x at 262,144 points x 512 query polygons, and K5 at
    65,536 polygons x 512 query polygons in its join form (kNN mode over
    each query's neighbouring-cells mask), each against its plain version
    bit for bit with its CUDA-event time, launch-to-completion time and
    bound."""
    from spatialflink_tpu_torch.models import EdgeGeomBatch
    from spatialflink_tpu_torch.ops import geom as G
    from spatialflink_tpu_torch.ops import hopper_kernels as HK
    from spatialflink_tpu_torch.ops import join as J

    dev = torch.device("cuda")
    grid = _grid()
    n = grid.n
    layers = grid.candidate_layers(JOIN_RADIUS)
    cases = {"join_reduce": [], "join_lattice": [], "pip_lattice": [],
             "geom_stream_dist": [], "cell_order": []}

    def add(kernel, name, kern, plain, ops, nbytes, plain_reps, **extra):
        c, got = kernel_case(timer, torch, name, kern, plain, ops, nbytes,
                             kernel, plain_reps=plain_reps, **extra)
        c["launch_to_completion_ms"] = launch_ms(torch, kern)
        cases[kernel].append(c)
        return got

    setups = join_setups(torch, grid)
    a = setups[0]["a"]  # option 101's stream window, for K4x below
    na = a.capacity
    for bb in (setups[0]["b"], setups[2]["b"]):
        # the join index (cell_order.cu's join_index_launch) of option
        # 101's query window, dense and sparse
        nb = bb.capacity
        starts = J.index_layout(nb, n, J.JOIN_TILE)[3]
        add("cell_order", f"join-index-{nb}",
            lambda bb=bb: tuple(J.join_index(bb, n)[:5]),
            lambda bb=bb: tuple(J.join_index_plain(bb, n)[:5]),
            nb * JOIN_INDEX_OPS, nb * (13 + JOIN_INDEX_BYTES) + starts * 4,
            REPS, points=nb, starts=starts)
    for s in setups:
        kern, plain, ops, nbytes, extra = join_calls(torch, grid, s)
        add(s["kernel"], s["name"], kern, plain, ops, nbytes, 3, **extra)
        del kern, plain
    del setups
    torch.cuda.empty_cache()

    # K4x: the window's points x one window's 512 query polygons
    qb = EdgeGeomBatch.from_objects(polys[:N_QGEOMS // 2], device=dev)
    args = (a.x, a.y, qb.edges, qb.edge_mask, qb.is_areal)
    valid_edges = int(qb.edge_mask.sum())
    g, e = qb.edges.shape[0], qb.edges.shape[1]
    add("pip_lattice", f"join-{na}x{g}polygons",
        lambda: (HK.pip_lattice(*args, cell=a.cell,
                                num_cells=grid.num_cells),),
        lambda: (HK.pip_lattice_plain(*args).T,),
        na * valid_edges * HK.OPS_PER_PAIR,
        na * 12 + g * e * 17 + g + g * na * 4, 1, points=na, geometries=g,
        edges_padded=e, valid_edges=valid_edges, order="cell")

    # K5: one window of the geometry join (the polygon stream's first
    # 65,536 span 5 s: two windows hold all of them) x 512 query
    # polygons, kNN mode over the queries' neighbouring-cells masks
    gb = EdgeGeomBatch.from_objects(streams["Polygon"][:N_JOIN_GEOMS],
                                    device=dev)
    nbm = J.cell_gate_table(qb.cells, qb.cells_mask, layers, n)
    kw = dict(mode=G.MODE_KNN, nb=nbm, queries=qb)
    got = G.geom_stream_dist(gb, **kw)
    ops, nbytes = k5_work(gb, got[1], "geometry", grid.num_cells, qb)
    add("geom_stream_dist", f"join-{gb.capacity}x{qb.capacity}polygons-knn",
        lambda: G.geom_stream_dist(gb, **kw),
        lambda: G.geom_stream_dist_plain(gb, **kw), ops, nbytes, 1,
        geometries=int(gb.valid.sum()), queries=int(qb.valid.sum()),
        consulted=int(torch.isfinite(got[1]).sum()))
    del a, gb, qb, got
    torch.cuda.empty_cache()
    return cases


def join_profile_phase(streams: dict) -> dict:
    """Option 101 over the dense query stream once more under
    torch.profiler: device time by kind and the device's busy share."""
    params = join_params(101, "points", "qpoints")
    out = {"option": 101, "records": len(streams["points"]),
           "query_records": len(streams["qpoints"]),
           **trace_device(lambda: run_join(params, streams["points"],
                                           streams["qpoints"])[3])}
    log("profile", json.dumps(out))
    return out


def join_breakdown_phase(streams: dict) -> dict:
    """Where option 101's time goes over the dense query stream: its
    stages one after another, host clock, device synchronised after each:
    the two decodes, window assembly of both sides, the batch build and
    copy of both sides, the query side's join index, K7 with the row list,
    K6 with the pairs' readback, and the pairs as Python tuples of
    Points."""
    import torch

    from spatialflink_tpu_torch.driver import CASES, _query_conf, \
        decode_chunks
    from spatialflink_tpu_torch.operators import PointPointJoinQuery
    from spatialflink_tpu_torch.operators.join_query import _keep
    from spatialflink_tpu_torch.ops import join as J
    from spatialflink_tpu_torch.runtime import WindowAssembler
    from spatialflink_tpu_torch.runtime.windows import merge_windows

    params = join_params(101, "points", "qpoints")
    u_grid, q_grid = params.grids()
    op = PointPointJoinQuery(_query_conf(params, CASES[101]), u_grid,
                             q_grid, device="cuda")
    st = {}
    t0 = time.perf_counter()
    c1 = list(decode_chunks(streams["points"], params.input1, u_grid))
    st["decode_stream_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    c2 = list(decode_chunks(streams["qpoints"], params.input2, q_grid))
    st["decode_query_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    spec = op.conf.window_spec()
    wins = list(merge_windows(
        *(WindowAssembler(spec, op.conf.allowed_lateness_ms).assemble(c)
          for c in (iter(c1), iter(c2)))))
    st["assemble_s"] = time.perf_counter() - t0
    for key in ("batch_h2d_s", "index_s", "k7_rows_s", "k6_readback_s",
                "pairs_s"):
        st[key] = 0.0
    r = JOIN_RADIUS
    layers = u_grid.candidate_layers(r)
    cx, cy = J.grid_center(u_grid)
    pairs = 0
    for start, _end, ra, rb in wins:
        if ra is None or rb is None:
            continue
        t0 = time.perf_counter()
        ba, bb = op._point_batch(ra, start), op._point_batch(rb, start)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        index = J.join_index(bb, u_grid.n)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        cnt, _, _ = J.join_reduce(ba, bb, float(np.sqrt(r * r + 1e-5)),
                                  layers, n=u_grid.n, index=index)
        rows = torch.nonzero(cnt > 0).reshape(-1).to(torch.int32)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        ai, bi = J.join_lattice(ba, bb, r, layers, cx, cy, n=u_grid.n,
                                rows=rows, index=index)
        ai, bi = (t.cpu().numpy().astype(np.int64) for t in (ai, bi))
        t4 = time.perf_counter()
        recs = list(_keep(ai, bi, ra, rb, None))
        t5 = time.perf_counter()
        pairs += len(recs)
        st["batch_h2d_s"] += t1 - t0
        st["index_s"] += t2 - t1
        st["k7_rows_s"] += t3 - t2
        st["k6_readback_s"] += t4 - t3
        st["pairs_s"] += t5 - t4
    total = sum(st.values())
    st.update(windows=len(wins), pairs=pairs, total_s=total,
              shares={k: v / total for k, v in st.items()
                      if k.endswith("_s")})
    log("join-breakdown", 101, json.dumps(st))
    return st


def join_cli_phase(streams: dict) -> None:
    """The CLI runs option 101 with --input2 on a small CSV pair (16,384
    points, 512 query points); stdout must equal an in-process run."""
    from spatialflink_tpu_torch.driver import _emit, run_option

    class Lines:
        def __init__(self):
            self.out = io.StringIO()

        def emit(self, record):
            print(record, file=self.out)

    s1, s2 = streams["points"][:1 << 14], streams["qpoints"][:512]
    build = os.path.join(ROOT, "spatialflink_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        conf = os.path.join(tmp, "conf.yml")
        with open(CONF) as f, open(conf, "w") as g:
            g.write(f.read().replace("radius: 0.5", f"radius: {JOIN_RADIUS}"))
        paths = []
        for name, lines in (("points.csv", s1), ("queries.csv", s2)):
            paths.append(os.path.join(tmp, name))
            with open(paths[-1], "w") as f:
                f.write("\n".join(lines) + "\n")
        proc = subprocess.run(
            [sys.executable, "-m", "spatialflink_tpu_torch.driver",
             "--config", conf, "--option", "101", "--input1", paths[0],
             "--format", "CSV", "--input2", paths[1], "--format2", "CSV",
             "--device", "cuda"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"CLI exit {proc.returncode}: {proc.stderr}")
        sink = Lines()
        for w in run_option(join_params(101, "points", "qpoints"), s1, s2,
                            device="cuda"):
            _emit(w, sink)
        want = sink.out.getvalue()
        if proc.stdout != want or not want:
            raise AssertionError(f"CLI option 101 stdout {proc.stdout[:200]!r}"
                                 f" != in-process {want[:200]!r}")
        log(f"cli: option 101 over {len(s1)} points x {len(s2)} query "
            f"points -> {want.count(chr(10))} windows, stdout equals the "
            f"in-process run ({want.splitlines()[0]})")


# ------------------------------------------------------------------------ #
# phase 7: the trajectory queries

N_TAXIS = 10_357          # T-Drive's taxis (Microsoft Research, Beijing)
TRAJ_STEPS = 50           # points per taxi, TRAJ_DT_MS apart: 20 s
TRAJ_DT_MS = 400
N_TRAJ = N_TAXIS * TRAJ_STEPS  # 517,850 points
N_TRAJ_RT = 1 << 16       # realtime runs: the first 128 cuts of 512
N_TJOIN_TAXIS = 320       # tJoin's query trajectories: 8,000 per window
TJOIN_RADIUS = 0.002      # degrees: about one partner per query point
TKNN_RADIUS = 0.05        # degrees: ~130 trajectories per window
TRAJ_STATE = 16_384       # K8a's state slots at the stream's 10,357 ids
#: (label, option, query overrides, over the realtime prefix, kernels its
#: path launches); a run without kernels runs once
TRAJ_RUNS = [
    ("201", 201, {}, True, ()),
    ("202", 202, {}, False, ()),
    ("203", 203, {}, True, ("pip_lattice",)),
    ("204", 204, {}, False, ("pip_lattice",)),
    ("2030", 2030, {}, True, ("pip_lattice",)),
    ("205", 205, {}, True, ("tstats_update",)),
    ("206", 206, {}, False, ("tstats_update",)),
    ("206-panes", 206, {"panes": True}, False, ("tstats_window_summary",)),
    ("207", 207, {}, True, ()),
    ("208-SUM", 208, {"aggregate_function": "SUM"}, False,
     ("taggregate_group_extents", "taggregate_heatmap")),
    ("208-ALL", 208, {"aggregate_function": "ALL"}, False,
     ("taggregate_group_extents",)),
    ("208-SUM-panes", 208, {"aggregate_function": "SUM", "panes": True},
     False, ("taggregate_group_extents",)),
    ("209", 209, {"radius": TJOIN_RADIUS}, True, ("join_lattice",)),
    ("210", 210, {"radius": TJOIN_RADIUS}, False,
     ("join_reduce", "join_lattice")),
    ("2090", 2090, {"radius": TJOIN_RADIUS}, True, ("join_lattice",)),
    ("211", 211, {"radius": TKNN_RADIUS}, True, ("knn_topk",)),
    ("212", 212, {"radius": TKNN_RADIUS}, False, ("knn_topk",)),
    ("2011", 2011, {"radius": TKNN_RADIUS}, True, ("knn_topk",)),
    ("211-multi", 211, {"radius": TKNN_RADIUS, "multi_query": True}, True,
     ("knn_topk",)),
    ("212-multi", 212, {"radius": TKNN_RADIUS, "multi_query": True}, False,
     ("knn_topk",)),
    ("99", 99, {}, False, ("pip_lattice", "tstats_update",
                           "taggregate_group_extents", "taggregate_heatmap",
                           "join_lattice", "knn_topk")),
]
K8 = ("tstats_update", "tstats_window_summary", "taggregate_group_extents",
      "taggregate_heatmap")


def traj_stream(seed: int):
    """(lines, columns) of the trajectory stream: the port's
    SyntheticPointSource with T-Drive's 10,357 taxis over the conf's grid,
    50 points each 400 ms apart (20 s), 1 % up to 2 s late; CSV rows
    'traj-i,ts,x,y'. And tJoin's query stream: 320 such taxis (another
    seed), as lines."""
    from spatialflink_tpu_torch.streams.sources import SyntheticPointSource

    grid = _grid()
    cols = SyntheticPointSource(
        grid, num_trajectories=N_TAXIS, steps=TRAJ_STEPS, dt_ms=TRAJ_DT_MS,
        out_of_order_fraction=0.01, out_of_order_max_ms=2_000,
        seed=seed + 30).columns()
    q = SyntheticPointSource(
        grid, num_trajectories=N_TJOIN_TAXIS, steps=TRAJ_STEPS,
        dt_ms=TRAJ_DT_MS, out_of_order_fraction=0.01,
        out_of_order_max_ms=2_000, seed=seed + 31).columns()

    def lines(x, y, ts, traj, prefix):
        return [f"{prefix}{k},{t},{a!r},{b!r}" for a, b, t, k in
                zip(x.tolist(), y.tolist(), ts.tolist(), traj.tolist())]
    return lines(*cols, "traj-"), lines(*q, "q-"), cols


def _traj_form(r):
    """A comparable form of one result record: points and sub-trajectories
    by their fields, selections by their columns, arrays by value."""
    if hasattr(r, "columns"):
        return tuple(tuple(a.tolist()) for a in r.columns()[:4])
    if hasattr(r, "coords_list"):
        return ("L", r.obj_id, r.timestamp, tuple(r.coords_list))
    if hasattr(r, "obj_id") and hasattr(r, "x"):
        return ("P", r.obj_id, r.timestamp, r.x, r.y)
    if isinstance(r, np.ndarray):
        return ("A", str(r.dtype), tuple(r.tolist()))
    if isinstance(r, dict):
        return tuple(sorted((k, _traj_form(v)) for k, v in r.items()))
    if isinstance(r, (set, frozenset)):
        return ("S", tuple(sorted(r)))
    if isinstance(r, (list, tuple)) or type(r).__name__ == "PairRecords":
        return tuple(_traj_form(v) for v in r)
    return r


def run_traj(params, s1, s2):
    """One run of run_option on the card: per-window (start, end, records
    in comparable form, extras in comparable form), per-window wall times
    (ms), records per window and wall seconds."""
    import torch

    from spatialflink_tpu_torch.driver import run_option

    torch.cuda.synchronize()
    t_start = time.perf_counter()
    it = iter(run_option(params, s1, s2, device="cuda"))
    wins, lat, sizes = [], [], []
    while True:
        t0 = time.perf_counter()
        try:
            w = next(it)
        except StopIteration:
            break
        lat.append((time.perf_counter() - t0) * 1e3)
        sizes.append(len(w.records))
        wins.append((w.window_start, w.window_end, w.records, w.extras))
    wall = time.perf_counter() - t_start
    return wins, lat, sizes, wall


def _traj_counters():
    from spatialflink_tpu_torch.ops import hopper_kernels as HK
    from spatialflink_tpu_torch.ops import join as J
    from spatialflink_tpu_torch.ops import knn as K
    from spatialflink_tpu_torch.ops import trajectory as T

    return {"tstats_update": T.tstats_update,
            "tstats_window_summary": T.tstats_window_summary,
            "taggregate_group_extents": T.taggregate_group_extents,
            "taggregate_heatmap": T.taggregate_heatmap,
            "pip_lattice": HK.pip_lattice, "cell_order": HK.cell_order,
            "knn_topk": K.knn_topk, "join_reduce": J.join_reduce,
            "join_lattice": J.join_lattice}


@contextlib.contextmanager
def traj_plain_versions():
    """Every kernel of the trajectory paths swapped for its plain version
    (the joins' through :func:`join_plain_versions`)."""
    from spatialflink_tpu_torch.ops import hopper_kernels as HK
    from spatialflink_tpu_torch.ops import knn as K
    from spatialflink_tpu_torch.ops import trajectory as T

    def lattice(*a, parity=False, **_):
        out = HK.pip_lattice_plain(*a, parity=parity)
        if parity:
            return out[0].T.contiguous(), out[1].T.contiguous()
        return out.T.contiguous()

    plain = {(T, "tstats_update"): T.tstats_update_plain,
             (T, "tstats_window_summary"): T.tstats_window_summary_plain,
             (T, "taggregate_group_extents"):
                 T.taggregate_group_extents_plain,
             (T, "taggregate_heatmap"): T.taggregate_heatmap_plain,
             (K, "knn_topk"): K.knn_topk_plain}
    saved = {key: getattr(*key) for key in plain}
    try:
        for (mod, name), fn in plain.items():
            setattr(mod, name, fn)
        with join_plain_versions():
            saved_hk = HK.pip_lattice
            HK.pip_lattice = lattice
            try:
                yield
            finally:
                HK.pip_lattice = saved_hk
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)


def traj_params(option: int, overrides: dict):
    """The conf over CSV streams (the conf's query point and polygon), with
    the run's query overrides."""
    from spatialflink_tpu_torch.config import Params

    p = Params.from_yaml(CONF)
    p.query.option = option
    for key, value in overrides.items():
        setattr(p.query, key, value)
    if p.query.multi_query:
        p.query.query_points = query_points()
    fmt = dataclasses.replace(p.input1, format="CSV")
    return dataclasses.replace(p, input1=fmt, input2=fmt)


def _tstats_by_object(wins):
    return [(s, e, {r[0]: r[1:] for r in recs}) for s, e, recs, _ in wins]


def traj_main_phase(card: str, lines, qlines):
    """Each trajectory run through run_option on the card (the realtime
    ones over the stream's first N_TRAJ_RT points and the query records of
    the same span), then, where its path launches kernels, again with
    every kernel swapped for its plain version: equal per-window results,
    and the launch counters non-zero for every kernel of the run's path.
    206 with panes against 206 without (same objects and temporal lengths,
    spatial within 4 * 2**-23 of the window's total: the pane stitch adds
    its sums in another order), 208 SUM with panes against 208 SUM
    (equal heatmaps). Returns (launches summed over the runs, report)."""
    import torch

    from spatialflink_tpu_torch.driver import CASES

    counters = _traj_counters()
    launches = dict.fromkeys(counters, 0)
    report, kept = [], {}
    for label, opt, overrides, short, path in TRAJ_RUNS:
        params = traj_params(opt, overrides)
        s1 = lines[:N_TRAJ_RT] if short else lines
        s2 = qlines[:len(qlines) * N_TRAJ_RT // N_TRAJ] if short else qlines
        for fn in counters.values():
            fn.launches = 0
        wins, lat, sizes, wall = run_traj(params, s1, s2)
        got = {name: fn.launches for name, fn in counters.items()}
        for name in counters:
            launches[name] += got[name]
        if any(got[name] <= 0 for name in path):
            raise AssertionError(f"trajectory {label}: kernels of its path "
                                 f"not launched {got}")
        if not path and any(got.values()):
            raise AssertionError(f"trajectory {label} launched {got}")
        if not wins or not sum(sizes) and not any(
                "heatmap" in w[3] for w in wins):
            raise AssertionError(f"trajectory {label}: no result")
        form = [(s, e, _traj_form(r), _traj_form(x)) for s, e, r, x in wins]
        pwall = None
        if path:
            with traj_plain_versions():
                pwins, _, _, pwall = run_traj(params, s1, s2)
            if {name: fn.launches for name, fn in counters.items()} != got:
                raise AssertionError("the plain run launched a kernel")
            pform = [(s, e, _traj_form(r), _traj_form(x))
                     for s, e, r, x in pwins]
            if form != pform:
                raise AssertionError(f"trajectory {label}: results differ "
                                     "from the plain run")
        if label in ("206", "206-panes", "208-SUM", "208-SUM-panes"):
            kept[label] = wins
        row = {"run": label, "option": opt, "mode": CASES[opt].mode,
               "records": len(s1) if opt != 99 else None,
               "query_records": len(s2) if opt in (209, 210, 2090)
               else None, "windows": len(wins),
               "records_per_s": len(s1) / wall if opt != 99 else None,
               "results": int(sum(sizes)), "wall_s": wall,
               "plain_wall_s": pwall,
               "median_window_ms": float(np.median(lat)),
               "p99_window_ms": _pct(lat, 99),
               "launches": {name: v for name, v in got.items() if v},
               "card": card}
        log("traj-path", json.dumps(row))
        report.append(row)
        torch.cuda.empty_cache()
    # panes against the whole windows
    whole, panes = (_tstats_by_object(kept[k]) for k in ("206", "206-panes"))
    if [w[:2] for w in whole] != [w[:2] for w in panes]:
        raise AssertionError("206: pane windows differ")
    worst = 0.0
    for (_, _, a), (_, _, b) in zip(whole, panes):
        if a.keys() != b.keys() or any(a[o][1] != b[o][1] for o in a):
            raise AssertionError("206: objects or temporal lengths differ "
                                 "with panes")
        bound = 4 * 2.0 ** -23 * sum(v[0] for v in a.values())
        err = max((abs(a[o][0] - b[o][0]) for o in a), default=0.0)
        worst = max(worst, err / bound if bound else 0.0)
        if err > bound:
            raise AssertionError(f"206: spatial {err} beyond {bound} with "
                                 "panes")
    hm = [w[3]["heatmap"] for w in kept["208-SUM"]]
    phm = [w[3]["heatmap"] for w in kept["208-SUM-panes"]]
    if len(hm) != len(phm) or not all(np.array_equal(a, b)
                                      for a, b in zip(hm, phm)):
        raise AssertionError("208 SUM: heatmaps differ with panes")
    log("traj-panes", json.dumps({"tstats_spatial_err_share_of_bound":
                                  worst}))
    return launches, report, worst


def traj_profile_phase(lines) -> dict:
    """Where a trajectory run's time goes: options 206 (the whole stream)
    and 205 (the realtime prefix) under torch.profiler
    (:func:`trace_device`), beside the decode alone of the same lines
    (``driver.decode_chunks`` in the run's chunk size)."""
    from spatialflink_tpu_torch.driver import decode_chunks

    out = {}
    for opt, recs, chunk in ((206, lines, 4096),
                             (205, lines[:N_TRAJ_RT], N_MICRO)):
        params = traj_params(opt, {})
        t0 = time.perf_counter()
        for _ in decode_chunks(recs, params.input1, _grid(), chunk):
            pass
        decode_s = time.perf_counter() - t0
        row = trace_device(lambda: run_traj(params, recs, [])[3])
        row.update(option=opt, records=len(recs), decode_s=decode_s,
                   decode_share=decode_s / row["wall_s"])
        log("traj-profile", json.dumps(row))
        out[str(opt)] = row
    return out


def profiled_kernels(torch, fn):
    """The device kernels torch.profiler counts in one call of ``fn``
    (copies and memsets not counted), or None when the trace holds no
    device event at all (a short session late in a long process, after
    the long traces, has been seen to record none)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [ev.name.lower() for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    if not names:
        return None
    return sum(1 for name in names
               if "memcpy" not in name and "memset" not in name)


def traj_kernel_phase(torch, timer: Timer, cols):
    """K8a-K8d against their plain versions bit for bit at the window shape
    (the 10 s window [T0, T0 + 10 s) of the stream: 258,925 points of
    10,357 taxis; K8b at its 5 s pane), at a 512-point realtime cut (K8a
    with the state its 64 earlier cuts carried) and, for K8a-K8c, at the
    one-block limit (``ops.trajectory.ONE_BLOCK_MAX`` points from the cut
    on), with CUDA-event time, launch-to-completion time, bound and the
    kernels torch.profiler counts in one call (K8a-K8c: as many as their
    key layout says, one at a cut; K8d: one); K8a and K8b take the
    batch's ts range as the operators pass it; K8d in every aggregate, with
    torch.Tensor.scatter_reduce_ (SUM, MIN, MAX) beside it. Returns
    {kernel: [cases]}."""
    from spatialflink_tpu_torch.models import PointBatch
    from spatialflink_tpu_torch.ops import trajectory as T

    dev = torch.device("cuda")
    grid = _grid()
    x, y, ts, traj = cols

    def batch(sel, ts_base):
        return PointBatch.from_arrays(x[sel], y[sel], device=dev, grid=grid,
                                      obj_id=traj[sel], ts=ts[sel],
                                      ts_base=ts_base)

    window = np.nonzero((ts >= T0) & (ts < T0 + 10_000))[0]
    pane = np.nonzero((ts >= T0) & (ts < T0 + 5_000))[0]
    cut = np.arange(64 * N_MICRO, 65 * N_MICRO)
    limit = np.arange(64 * N_MICRO, 64 * N_MICRO + T.ONE_BLOCK_MAX)
    cut_base = int(ts[cut[0]])
    shapes = {"window": (batch(window, T0), len(window),
                         PointBatch.ts_range(ts[window], T0)),
              "pane": (batch(pane, T0), len(pane),
                       PointBatch.ts_range(ts[pane], T0)),
              "cut": (batch(cut, cut_base), N_MICRO,
                      PointBatch.ts_range(ts[cut], cut_base)),
              "one-block-limit": (batch(limit, cut_base), len(limit),
                                  PointBatch.ts_range(ts[limit], cut_base))}
    # the state the 64 cuts before the measured one leave behind
    carried = T.TrajStatsState.zeros(TRAJ_STATE, dev)
    for c in range(64):
        idx = np.arange(c * N_MICRO, (c + 1) * N_MICRO)
        carried, _ = T.tstats_update_plain(carried, batch(idx, cut_base))
    cases = {name: [] for name in K8}

    def state_of(src):
        return T.TrajStatsState(*(t.clone() for t in src))

    def case(name, shape, kern, plain, nbytes, ops, layout=None, kernels=1,
             **extra):
        got, want = kern(), plain()
        torch.cuda.synchronize()
        err = compare(torch, got, want, f"{name} {shape}")
        b_ms, b_by = bound_ms(ops, nbytes)
        row = {"case": shape, **extra, "identical": True, "max_abs_err": err,
               "ms": timer.ms(kern), "plain_ms": timer.ms(plain, reps=5),
               "launch_to_completion_ms": launch_ms(torch, kern),
               "launches": profiled_kernels(torch, kern),
               "bound_ms": b_ms, "bound_by": b_by}
        if layout is not None:
            row.update(key_bits=layout.bits, passes=layout.passes)
            kernels = layout.launches
        if row["launches"] not in (None, kernels):
            raise AssertionError(f"{name} {shape}: {row['launches']} "
                                 f"kernels, its layout says {kernels}")
        log("kernels-traj", name, json.dumps(row))
        cases[name].append(row)
        return got

    for shape in ("window", "cut", "one-block-limit"):
        b, n, rng_ts = shapes[shape]
        base = (T.TrajStatsState.zeros(TRAJ_STATE, dev) if shape == "window"
                else carried)
        touched = int(torch.unique(b.obj_id[b.valid]).numel())

        def run(fn, **kw):
            st, out = fn(state_of(base), b, **kw)
            return (*out, *st)
        got = run(T.tstats_update, ts_range=rng_ts)
        want = run(T.tstats_update_plain)
        torch.cuda.synchronize()
        err = compare(torch, got, want, f"tstats_update {shape}")
        # the timed launches update one scratch state in place (the sort
        # and the walk do the same work whatever the state holds)
        scratch = state_of(base)

        def kern():
            return T.tstats_update(scratch, b, ts_range=rng_ts)
        _, lay = T.tstats_layout(b.x.shape[0], TRAJ_STATE, *rng_ts)
        b_ms, b_by = bound_ms(20.0 * n, 17.0 * n + 21.0 * n + 40.0 * touched)
        row = {"case": shape, "points": n, "objects": touched,
               "state_slots": TRAJ_STATE, "ts_range": list(rng_ts),
               "key_bits": lay.bits, "passes": lay.passes,
               "identical": True, "max_abs_err": err, "ms": timer.ms(kern),
               "plain_ms": timer.ms(lambda: run(T.tstats_update_plain),
                                    reps=5),
               "launch_to_completion_ms": launch_ms(torch, kern),
               "launches": profiled_kernels(torch, kern),
               "bound_ms": b_ms, "bound_by": b_by}
        if row["launches"] not in (None, lay.launches):
            raise AssertionError(f"tstats_update {shape}: {row['launches']} "
                                 f"kernels, its layout says {lay.launches}")
        log("kernels-traj", "tstats_update", json.dumps(row))
        cases["tstats_update"].append(row)
    for shape in ("pane", "cut", "one-block-limit"):
        b, n, rng_ts = shapes[shape]
        case("tstats_window_summary", shape,
             lambda: T.tstats_window_summary(b, m=TRAJ_STATE,
                                             ts_range=rng_ts),
             lambda: T.tstats_window_summary_plain(b, m=TRAJ_STATE),
             17.0 * n + 32.0 * TRAJ_STATE, 20.0 * n,
             layout=T.summary_layout(b.x.shape[0], TRAJ_STATE, *rng_ts)[1],
             points=n, ts_range=list(rng_ts))
    for shape in ("window", "cut", "one-block-limit"):
        b, n, _ = shapes[shape]
        ext = case("taggregate_group_extents", shape,
                   lambda: T.taggregate_group_extents(
                       b, num_cells=grid.num_cells, num_ids=N_TAXIS),
                   lambda: T.taggregate_group_extents_plain(
                       b, num_cells=grid.num_cells),
                   13.0 * n + 17.0 * n, 4.0 * n,
                   layout=T.extents_layout(b.x.shape[0], grid.num_cells,
                                           T._oid_bits(N_TAXIS)), points=n)
        if shape == "one-block-limit":
            continue
        groups = T.TAggregateGroups(cell=ext[0], obj_id=ext[1],
                                    length=ext[3] - ext[2], first=ext[4])
        idx = torch.where(groups.first, groups.cell.long(),
                          torch.full_like(groups.cell, grid.num_cells).long())
        vals = torch.where(groups.first, groups.length, 0).float()
        for agg in ("SUM", "AVG", "MIN", "MAX", "COUNT"):
            lib = {"SUM": "sum", "MIN": "amin", "MAX": "amax"}.get(agg)
            extra = {"aggregate": agg, "points": n,
                     "groups": int(groups.first.sum())}
            if lib is not None:
                extra["library_ms"] = timer.ms(
                    lambda: torch.zeros(grid.num_cells + 1, device=dev)
                    .scatter_reduce_(0, idx, vals, lib,
                                     include_self=lib == "sum"))
                extra["library_call"] = (
                    f"torch.Tensor.scatter_reduce_(0, cell, length, "
                    f"'{lib}') into a zero (num_cells + 1,) tensor")
            case("taggregate_heatmap", shape,
                 lambda agg=agg: (T.taggregate_heatmap(
                     groups, num_cells=grid.num_cells, agg=agg),),
                 lambda agg=agg: (T.taggregate_heatmap_plain(
                     groups, num_cells=grid.num_cells, agg=agg),),
                 9.0 * n + 4.0 * grid.num_cells, 2.0 * n, **extra)
    return cases

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
    # the trajectory stream, and K8's kernel cases before the long traces
    # below (their launch counts come from short torch.profiler sessions)
    t0 = time.perf_counter()
    tlines, tqlines, tcols = traj_stream(args.seed)
    log(f"trajectory stream: {len(tlines)} CSV rows of {N_TAXIS} taxis over "
        f"{TRAJ_STEPS * TRAJ_DT_MS} ms, {len(tqlines)} query rows "
        f"({time.perf_counter() - t0:.1f} s to generate)")
    k8_cases = phase("kernels-k8", traj_kernel_phase, torch, timer, tcols)
    del tcols
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    lines = stream_lines(args.seed, N_STREAM)
    log(f"stream: {len(lines)} CSV rows over {SPAN_MS} ms "
        f"({time.perf_counter() - t0:.1f} s to generate)")
    launches, report = phase("main-path", main_path_phase, card, lines, RUNS)
    rt_launches, rt_report = phase("realtime", main_path_phase, card,
                                   lines[:N_SHORT], REALTIME_RUNS)
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
                                       geoms, GEOM_RUNS, N_GEOM_RUNS)
    other_launches, other_report = phase(
        "geom-other", geom_main_phase, card, geoms, GEOM_OTHER_RUNS,
        N_GEOM_OTHER)
    geom_report.append(phase("geom-lines", geom_lines_phase, card,
                             glines["Polygon"][:N_GEOM_LINES],
                             geoms["Polygon"][:N_GEOM_LINES]))
    prof["71"] = phase("profile-71", geom_profile_phase,
                       geoms["Polygon"][:N_GEOM_RUNS], 71)
    phase("cli-geom", geom_cli_phase, glines["Polygon"][:N_GEOM_CLI])
    del glines

    # panes (K3) and the standing-query plane; the geometry runs take
    # every eighth parsed geometry (N_GEOM_SPREAD spread over the 20 s)
    k3_cases = phase("kernels-k3", k3_phase, torch, args.seed, timer)
    spread = {kind: objs[::N_GEOM // N_GEOM_SPREAD]
              for kind, objs in geoms.items()}
    pane_launches, pane_report = phase("panes", pane_phase, card, PANE_RUNS,
                                       lines, base_params(), FULL_WINDOWS)
    gpane_launches, gpane_report = phase(
        "panes-geom", pane_phase, card, GEOM_PANE_RUNS, spread["Polygon"],
        geom_params())
    dyn_launches, dyn_report = phase(
        "dynamic", dynamic_phase, card,
        [(1, lines, ("range_mask_stats",)), (51, lines, ("knn_topk",)),
         (16, spread["Polygon"], ("geom_stream_dist",)),
         (31, spread["LineString"], ("geom_stream_dist",))], base_params())
    phase("cli-queries", queries_cli_phase, args.seed)
    del spread
    FULL_WINDOWS.clear()

    # the spatial joins: the point stream and the parsed geometry streams
    # against four query streams
    t0 = time.perf_counter()
    streams = {"points": lines, **geoms, **join_query_streams(args.seed)}
    qpolys = decode_geoms(streams["qPolygon"], "Polygon")[0]
    log(f"join query streams: {N_QPOINTS} and {N_QSPARSE} points, "
        f"{N_QGEOMS} polygons and linestrings over {SPAN_MS} ms "
        f"({time.perf_counter() - t0:.1f} s to generate)")
    join_cases = phase("kernels-join", join_kernel_phase, torch, timer,
                       streams, qpolys)
    join_launches, join_report = phase("join-path", join_main_phase, card,
                                       streams, JOIN_RUNS)
    jrt_launches, jrt_report = phase("join-realtime", join_main_phase, card,
                                     streams, JOIN_RT_RUNS, True)
    join_report += jrt_report
    breakdown["join-101"] = phase("join-breakdown", join_breakdown_phase,
                                  streams)
    prof["101"] = phase("profile-101", join_profile_phase, streams)
    phase("cli-join", join_cli_phase, streams)
    del lines, geoms, streams
    torch.cuda.empty_cache()

    # the trajectory queries over T-Drive's taxi count (their stream and
    # K8's kernel cases came first)
    traj_launches, traj_report, traj_pane_err = phase(
        "trajectory", traj_main_phase, card, tlines, tqlines)
    prof.update(phase("trajectory-profile", traj_profile_phase, tlines))
    del tlines, tqlines
    for more in (rt_launches, short_launches, count_launches, geom_launches,
                 other_launches, pane_launches, gpane_launches, dyn_launches,
                 join_launches, jrt_launches, traj_launches):
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

    def join_case(c):
        return {key: c[key] for key in ("case", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "launch_to_completion_ms")}

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
              "benchmarks/exp_pip_lattice.py:112",
              k4x_cases + join_cases["pip_lattice"], k4x_cases[0],
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
    kernels[3]["join"] = join_case(join_cases["pip_lattice"][0])
    # the cell order is part of K4x: pip_lattice launches it on the main
    # path, and K4x's "ms" includes it
    order = entry("cell_order", "spatialflink_tpu_torch/csrc/cell_order.cu",
                  "benchmarks/exp_pip_lattice.py:112",
                  [order_case] + join_cases["cell_order"], order_case,
                  f"{N_KERNEL} points, {_grid().num_cells} cells")
    # the same sort builds the joins' index (ops/join.join_index)
    order["join"] = join_case(join_cases["cell_order"][0])
    order["library_note"] = ("no single PyTorch call: the plain version "
                             "is a torch.where, torch.argsort(stable=True) "
                             "and two gathers")
    kernels[3]["helpers"] = [order]
    window_k5 = [c for c in k5_cases if not c["case"].startswith("micro-")]
    k5 = entry("geom_stream_dist", "spatialflink_tpu_torch/csrc/geom_dist.cu",
               "spatialflink_tpu/ops/geom.py:126",
               window_k5 + join_cases["geom_stream_dist"],
               next(c for c in window_k5
                    if c["case"] == "polygons-x-conf-polygon-range"),
               f"{WINDOW_GEOMS} polygons of 4-32 edges x the conf's polygon, "
               "range mode (option 21's window)")
    k5["library_note"] = ("no single PyTorch call computes the geometry "
                          "distances with the cell rule")
    k5["join"] = join_case(join_cases["geom_stream_dist"][0])
    kernels.append(k5)
    k7 = entry("join_reduce", "spatialflink_tpu_torch/csrc/join_reduce.cu",
               "spatialflink_tpu/ops/pallas_kernels.py:299",
               join_cases["join_reduce"], join_cases["join_reduce"][0],
               f"{N_STREAM // 2} points x {N_QPOINTS // 2} query points "
               "(option 101's window)")
    k7["library_note"] = ("no single PyTorch call computes the per-point "
                          "partner count, min d2 and argmin under the "
                          "cell rule")
    k6 = entry("join_lattice", "spatialflink_tpu_torch/csrc/join_lattice.cu",
               "spatialflink_tpu/ops/join.py:137",
               join_cases["join_lattice"], join_cases["join_lattice"][0],
               "the rows K7 finds partners for x the window's "
               f"{N_QPOINTS // 2} query points (option 101's window)")
    k6["library_note"] = ("no single PyTorch call computes the join's "
                          "pair list; the plain version is a masked "
                          "lattice and torch.nonzero per tile")
    kernels += [k7, k6]
    k3 = entry("knn_merge", "spatialflink_tpu_torch/csrc/knn_merge.cu",
               "spatialflink_tpu/ops/knn.py:532", k3_cases, k3_cases[0],
               "2 panes x 1 query x k=50 (option 51's window under panes)")
    k3["library_note"] = ("no single PyTorch call computes the dedup by id "
                          "and the top-k of the merged partials")
    kernels.append(k3)
    k8_meta = {
        "tstats_update": ("spatialflink_tpu/ops/trajectory.py:88",
                          f"the 10 s window: 258,925 points of {N_TAXIS} "
                          f"taxis, fresh {TRAJ_STATE}-slot state"),
        "tstats_window_summary": ("spatialflink_tpu/ops/trajectory.py:192",
                                  "the 5 s pane of option 206 with panes"),
        "taggregate_group_extents": (
            "spatialflink_tpu/ops/trajectory.py:378",
            "the 10 s window over the conf's 10,000 cells"),
        "taggregate_heatmap": ("spatialflink_tpu/ops/trajectory.py:433",
                               "the 10 s window's groups, SUM"),
    }
    for name in K8:
        window = k8_cases[name][0]
        k8 = {"name": name, "route": "cuda",
              "source": "spatialflink_tpu_torch/csrc/traj.cu",
              "replaces": k8_meta[name][0],
              "launches": traj_launches[name],
              "max_abs_err": max(c["max_abs_err"] for c in k8_cases[name]),
              "ms": window["ms"], "plain_ms": window["plain_ms"],
              "bound_ms": window["bound_ms"], "bound_by": window["bound_by"],
              "library_ms": window.get("library_ms"),
              "shape": k8_meta[name][1], "cases": k8_cases[name]}
        if name == "taggregate_heatmap":
            k8["library_note"] = window["library_call"]
        else:
            k8["library_note"] = NO_LIB
        cut = next(c for c in k8_cases[name] if c["case"] == "cut")
        k8["micro_batch"] = {key: cut[key] for key in (
            "case", "ms", "launch_to_completion_ms", "plain_ms", "bound_ms",
            "bound_by")}
        kernels.append(k8)
    phases["total"] = time.perf_counter() - t_all
    log("build-report", json.dumps(build_report))
    print(card, flush=True)
    print(json.dumps({"kernels": kernels, "card": card,
                      "main_path": report + rt_report + count_report,
                      "geom_path": geom_report + other_report,
                      "join_path": join_report,
                      "panes": pane_report + gpane_report,
                      "dynamic": dyn_report,
                      "trajectory": traj_report,
                      "trajectory_pane_err_share_of_bound": traj_pane_err,
                      "geom_host": geom_host, "breakdown": breakdown,
                      "profile": prof, "phases_s": phases}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
