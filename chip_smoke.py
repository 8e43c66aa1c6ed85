#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (spatialflink_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 chip_smoke.py [--seed 0]

Phases (each raises on failure; the script catches nothing):

1. Device: the card's name and power limit; build the CUDA kernels from
   ``spatialflink_tpu_torch/csrc`` and print the build time.
2. Kernels against their plain PyTorch versions on the card, at the main
   path's shapes (1,048,576 points over the conf's grid bbox): K4
   ``pip_dist`` for a 64-edge polygon, a polygon with a hole, the conf's
   linestring, 1,301-, 512- and 513-edge polygons and the empty edge set;
   K1 ``range_mask_stats`` in point and cell-mask mode, exact and
   approximate. Each must equal its plain version bit for bit. Times are
   CUDA-event medians of 25 launches queued behind a sleep kernel (so the
   host's launch cost is not timed), with the 50 MB L2 evicted before
   each; the bound is max(operations / 67 TFLOP/s, bytes / 3.35 TB/s).
   A small input is also held against a float64 numpy reference.
3. Main path: options 6, 1 and 11 through ``driver.run_option`` on
   device="cuda" over a seeded 2,097,152-point CSV stream spanning 20 s
   (the conf's 10 s / 5 s sliding windows: full windows of 1,048,576
   points). The launch counters are zeroed before each option and read
   after it; each option runs again with the ops swapped for their plain
   versions, and the per-window selections must be equal. Then option 6's
   stages (CSV decode, window assembly, batch build and copy, device ops,
   readback and selection) are timed one after another, and the CLI runs
   option 6 on a 65,536-row CSV.
4. Output: the card line, one JSON ``kernels`` line, and as the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero without a result line when CUDA is not available or the
package is not beside the script.
"""

from __future__ import annotations

import argparse
import dataclasses
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
SPAN_MS = 20_000                  # event-time span of the stream
T0 = 1_700_000_000_000            # stream start, aligned to the 5 s slide
PEAK_FLOPS = 67e12                # H100 SXM f32, outside the tensor cores
PEAK_BYTES = 3.35e12              # H100 SXM HBM3
REPS = 25
SLEEP_CYCLES = 100_000_000        # ~50 ms hold while timed launches queue


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


class Timer:
    """Device time of one call: CUDA events around each of REPS launches,
    queued behind a sleep kernel so that the host's launch cost overlaps
    the wait, with L2 evicted (a 128 MB write) before each launch."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(32 << 20, dtype=torch.float32,
                                 device="cuda")

    def ms(self, fn) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        evs = [(torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True)) for _ in range(REPS)]
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


# ------------------------------------------------------------------------ #
# phase 2: kernels against their plain versions


def kernel_phase(torch, seed: int, timer: Timer):
    from spatialflink_tpu_torch.index import UniformGrid
    from spatialflink_tpu_torch.models import (LineString, PointBatch,
                                                Polygon, single_query_edges)
    from spatialflink_tpu_torch.ops import hopper_kernels as HK
    from spatialflink_tpu_torch.ops import range as R

    dev = torch.device("cuda")
    grid = UniformGrid(BBOX[0], BBOX[2], BBOX[1], BBOX[3],
                       num_grid_partitions=100)
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
        got = HK.pip_dist(b.x, b.y, e, m, areal)
        want = HK.pip_dist_plain(b.x, b.y, e, m, areal)
        torch.cuda.synchronize()
        if got.shape != (n,) or bool(torch.isnan(got).any()):
            raise AssertionError(f"pip_dist {name}: bad output")
        err = compare(torch, (got,), (want,), f"pip_dist {name}")
        ep = HK.bucket_edges(e.shape[0])
        b_ms, b_by = bound_ms(n * n_valid * HK.OPS_PER_PAIR,
                              n * 12 + ep * 17)
        case = {"case": name, "edges": n_valid, "edges_padded": ep,
                "identical": True, "max_abs_err": err,
                "ms": timer.ms(lambda: HK.pip_dist(b.x, b.y, e, m, areal)),
                "plain_ms": timer.ms(
                    lambda: HK.pip_dist_plain(b.x, b.y, e, m, areal)),
                "bound_ms": b_ms, "bound_by": b_by}
        log("K4", json.dumps(case))
        k4_cases.append(case)
        if name == "polygon-64":
            dists64 = got
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
            got, want = kern(), plain()
            torch.cuda.synchronize()
            err = compare(torch, got, want, f"range_mask_stats {mode}")
            b_ms, b_by = bound_ms(ops, nbytes)
            case = {"case": f"{mode}-{'approx' if approx else 'exact'}",
                    "selected": int(got[0].sum()),
                    "counts": [int(c) for c in got[-2:]],
                    "identical": True, "max_abs_err": err,
                    "ms": timer.ms(kern), "plain_ms": timer.ms(plain),
                    "bound_ms": b_ms, "bound_by": b_by}
            log("K1", json.dumps(case))
            k1_cases.append(case)
    if R.range_mask_stats.launches <= 0:
        raise AssertionError("range_mask_stats launched no kernel")
    return k4_cases, k1_cases


def reference_phase(torch, seed: int) -> None:
    """A small input against an independent float64 numpy reference:
    distances within 1e-4 degrees, masks equal away from the radius."""
    from spatialflink_tpu_torch.index import UniformGrid
    from spatialflink_tpu_torch.models import (PointBatch, Polygon,
                                                single_query_edges)
    from spatialflink_tpu_torch.ops import hopper_kernels as HK
    from spatialflink_tpu_torch.ops import range as R

    dev = torch.device("cuda")
    grid = UniformGrid(BBOX[0], BBOX[2], BBOX[1], BBOX[3],
                       num_grid_partitions=100)
    rng = np.random.default_rng(seed + 1)
    x = rng.uniform(BBOX[0], BBOX[2], 4096)
    y = rng.uniform(BBOX[1], BBOX[3], 4096)
    b = PointBatch.from_arrays(x, y, device=dev, grid=grid)
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
    log(f"reference: {int(ok.sum())} distances and {int(sure.sum())} mask "
        "entries agree with float64 numpy")


# ------------------------------------------------------------------------ #
# phase 3: the main path


def stream_lines(seed: int, n: int):
    """n CSV rows 'oid,ts,x,y' uniform over the bbox, timestamps spread
    evenly over SPAN_MS from T0 (each 10 s window holds exactly n/2)."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(BBOX[0], BBOX[2], n)
    y = rng.uniform(BBOX[1], BBOX[3], n)
    ts = T0 + (np.arange(n, dtype=np.int64) * SPAN_MS) // n
    oid = rng.integers(0, 100_000, n)
    return [f"o{o},{t},{a!r},{c!r}" for o, t, a, c in
            zip(oid.tolist(), ts.tolist(), x.tolist(), y.tolist())]


def run_pipeline(params, lines):
    """One run of run_option on the card: per-window (start, end, selected
    columns), per-window latencies (ms) and wall seconds."""
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
        x, y, ts, oid = w.records.columns()[:4]
        wins.append((w.window_start, w.window_end, x, y, ts, oid))
    return wins, lat, time.perf_counter() - t_start


def main_path_phase(card: str, seed: int):
    from spatialflink_tpu_torch.config import Params
    from spatialflink_tpu_torch.ops import hopper_kernels as HK
    from spatialflink_tpu_torch.ops import range as R

    t0 = time.perf_counter()
    lines = stream_lines(seed, N_STREAM)
    log(f"stream: {len(lines)} CSV rows over {SPAN_MS} ms "
        f"({time.perf_counter() - t0:.1f} s to generate)")
    base = Params.from_yaml(CONF)
    base = dataclasses.replace(
        base, input1=dataclasses.replace(base.input1, format="CSV"))
    base.query.query_polygons = [ring(64, 0.35)]
    plain_ops = {(R, "range_filter_point_stats"):
                 R.range_filter_point_stats_plain,
                 (R, "range_filter_masks_stats"):
                 R.range_filter_masks_stats_plain,
                 (HK, "pip_dist"): HK.pip_dist_plain}
    launches = {"pip_dist": 0, "range_mask_stats": 0}
    report = []
    for opt in (6, 1, 11):
        params = dataclasses.replace(
            base, query=dataclasses.replace(base.query, option=opt))
        HK.pip_dist.launches = 0
        R.range_mask_stats.launches = 0
        wins, lat, wall = run_pipeline(params, lines)
        got = {"pip_dist": HK.pip_dist.launches,
               "range_mask_stats": R.range_mask_stats.launches}
        for k in launches:
            launches[k] += got[k]
        if got["range_mask_stats"] <= 0 or (opt != 1 and got["pip_dist"] <= 0):
            raise AssertionError(f"option {opt}: kernels not launched {got}")
        saved = {k: getattr(*k) for k in plain_ops}
        try:
            for (mod, name), fn in plain_ops.items():
                setattr(mod, name, fn)
            pwins, _, pwall = run_pipeline(params, lines)
        finally:
            for (mod, name), fn in saved.items():
                setattr(mod, name, fn)
        if HK.pip_dist.launches != got["pip_dist"] \
                or R.range_mask_stats.launches != got["range_mask_stats"]:
            raise AssertionError("the plain run launched a kernel")
        if len(wins) != len(pwins) or not wins:
            raise AssertionError(f"option {opt}: {len(wins)} windows vs "
                                 f"{len(pwins)} with the plain versions")
        for a, p in zip(wins, pwins):
            if a[:2] != p[:2] or not all(np.array_equal(u, v)
                                         for u, v in zip(a[2:], p[2:])):
                raise AssertionError(f"option {opt} window {a[:2]}: "
                                     "selection differs from plain run")
            if a[2].size == 0:
                raise AssertionError(f"option {opt} window {a[:2]} empty")
        row = {"option": opt, "windows": len(wins),
               "selected": [int(w[2].size) for w in wins],
               "points_per_s": N_STREAM / wall, "wall_s": wall,
               "plain_wall_s": pwall,
               "median_window_ms": float(np.median(lat)),
               "launches": got, "card": card}
        log("main-path", json.dumps(row))
        report.append(row)
    return launches, report, lines


def breakdown_phase(lines) -> dict:
    """Where option 6's time goes: the main path's stages run one after
    another over the same stream, each timed on the host clock with the
    device synchronised at its end (the pipelined run overlaps them)."""
    import torch

    from spatialflink_tpu_torch.config import Params
    from spatialflink_tpu_torch.driver import (ChunkedStream, _query_conf,
                                               decode_chunks)
    from spatialflink_tpu_torch.models import Polygon
    from spatialflink_tpu_torch.operators import PointGeomRangeQuery

    params = Params.from_yaml(CONF)
    params = dataclasses.replace(
        params, input1=dataclasses.replace(params.input1, format="CSV"))
    grid = params.grids()[0]
    op = PointGeomRangeQuery(_query_conf(params), grid, device="cuda")
    mask_stats = op._mask_stats_fn(Polygon.create([ring(64, 0.35)], grid),
                                   params.query.radius)
    out = {"decode_s": 0.0, "assemble_s": 0.0, "batch_h2d_s": 0.0,
           "device_ops_s": 0.0, "readback_select_s": 0.0}
    t0 = time.perf_counter()
    chunks = list(decode_chunks(lines, params.input1, grid))
    out["decode_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    wins = list(op._windows(ChunkedStream(iter(chunks))))
    out["assemble_s"] = time.perf_counter() - t0
    for start, _end, recs in wins:
        t0 = time.perf_counter()
        batch = op._point_batch(recs, start)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mask, gn_c, evals = mask_stats(batch)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        recs.take(np.nonzero(mask.cpu().numpy())[0])
        t3 = time.perf_counter()
        out["batch_h2d_s"] += t1 - t0
        out["device_ops_s"] += t2 - t1
        out["readback_select_s"] += t3 - t2
    out["windows"] = len(wins)
    out["total_s"] = sum(v for k, v in out.items() if k.endswith("_s"))
    log("breakdown", json.dumps(out))
    return out


def cli_phase(seed: int) -> None:
    """The CLI on a CSV file: option 6 with the conf's own polygon; its
    per-window counts must equal an in-process run's."""
    from spatialflink_tpu_torch.config import Params
    from spatialflink_tpu_torch.driver import run_option

    build = os.path.join(ROOT, "spatialflink_tpu_torch", "_build")
    os.makedirs(build, exist_ok=True)
    lines = stream_lines(seed + 2, N_CLI)
    with tempfile.TemporaryDirectory(dir=build) as tmp:
        path = os.path.join(tmp, "points.csv")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        proc = subprocess.run(
            [sys.executable, "-m", "spatialflink_tpu_torch.driver",
             "--config", CONF, "--option", "6", "--input1", path,
             "--format", "CSV", "--device", "cuda"],
            cwd=ROOT, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"CLI exit {proc.returncode}: {proc.stderr}")
    out = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    params = Params.from_yaml(CONF)
    params = dataclasses.replace(
        params, input1=dataclasses.replace(params.input1, format="CSV"))
    params.query.option = 6
    want = [str({"window": [w.window_start, w.window_end],
                 "count": len(w.records)})
            for w in run_option(params, lines, device="cuda")]
    if out != want or not out:
        raise AssertionError(f"CLI stdout {out[:3]} != in-process {want[:3]}")
    log(f"cli: option 6 over {N_CLI} CSV rows -> {len(out)} windows, "
        "stdout equals the in-process run")


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

    card = card_line()
    log(f"card: {card}; torch.cuda: {torch.cuda.get_device_name(0)}; "
        f"torch {torch.__version__} CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    compile_s = native.build()
    log(f"build: {time.perf_counter() - t0:.2f} s wall "
        f"(per source: {json.dumps(compile_s)})")

    timer = Timer(torch)
    k4_cases, k1_cases = kernel_phase(torch, args.seed, timer)
    reference_phase(torch, args.seed)
    launches, report, lines = main_path_phase(card, args.seed)
    breakdown = breakdown_phase(lines)
    del lines
    cli_phase(args.seed)

    no_lib = "no single PyTorch call computes this function"
    main4 = k4_cases[0]  # polygon-64: option 6's shape
    main1 = k1_cases[0]  # point-exact: option 1's shape
    kernels = [
        {"name": "pip_dist", "route": "cuda",
         "source": "spatialflink_tpu_torch/csrc/pip_dist.cu",
         "replaces": "spatialflink_tpu/ops/pallas_kernels.py:195",
         "launches": launches["pip_dist"],
         "max_abs_err": max(c["max_abs_err"] for c in k4_cases),
         "ms": main4["ms"], "plain_ms": main4["plain_ms"],
         "bound_ms": main4["bound_ms"], "bound_by": main4["bound_by"],
         "library_ms": None, "library_note": no_lib,
         "shape": f"{N_KERNEL} points x 64 edges", "cases": k4_cases},
        {"name": "range_mask_stats", "route": "cuda",
         "source": "spatialflink_tpu_torch/csrc/range_mask.cu",
         "replaces": "spatialflink_tpu/ops/range.py:72",
         "launches": launches["range_mask_stats"],
         "max_abs_err": max(c["max_abs_err"] for c in k1_cases),
         "ms": main1["ms"], "plain_ms": main1["plain_ms"],
         "bound_ms": main1["bound_ms"], "bound_by": main1["bound_by"],
         "library_ms": None, "library_note": no_lib,
         "shape": f"{N_KERNEL} points, point query", "cases": k1_cases},
    ]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels, "card": card,
                      "main_path": report, "breakdown": breakdown}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
