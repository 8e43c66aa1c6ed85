"""Synthetic skewed streams (port of ``spatialflink_tpu.streams.synthetic``):
the same generators, seed for seed, so a test or ``chip_smoke.py`` makes
the JAX package's skewed streams without it.

- :func:`zipf_cells`: raw cell-id streams for the repartition controller;
- :func:`clustered_xy` / :func:`clustered_points` / :func:`clustered_lines`:
  coordinate streams, a tight hot cluster holding ``hot_share`` of the
  records over a uniform background; ``hot_share=0`` is uniform traffic.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

#: the hot cell of the :func:`zipf_cells` streams
ZIPF_HOT = 17


def zipf_cells(n: int = 4000, seed: int = 7, hot: int = ZIPF_HOT,
               hot_share: float = 0.6) -> np.ndarray:
    """A clustered cell-id stream: ``hot_share`` of records land in ``hot``,
    the rest spread Zipf-ish over higher cells — the skew shape a uniform
    grid sees under real (vehicle/checkin) traffic."""
    rng = np.random.default_rng(seed)
    tail = 20 + (rng.zipf(1.5, n) % 60)
    cells = np.where(rng.uniform(size=n) < hot_share, hot, tail)
    return cells.astype(np.int64)


def clustered_xy(grid, n: int, hot_share: float, seed: int = 7,
                 hot_center: Optional[Tuple[float, float]] = None,
                 cluster_span_cells: float = 2.0
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """(x, y) arrays: ``hot_share`` of the points uniform inside a tight
    cluster box spanning ``cluster_span_cells`` grid cells around
    ``hot_center`` (default: the bbox middle, snapped off cell boundaries),
    the rest uniform over the whole bbox. Deterministic per seed."""
    rng = np.random.default_rng(seed)
    span = cluster_span_cells * grid.cell_length
    if hot_center is None:
        # mid-bbox, nudged a third of a cell so the cluster box never sits
        # exactly on a cell boundary (stable cell membership per seed)
        hot_center = ((grid.min_x + grid.max_x) / 2 + grid.cell_length / 3,
                      (grid.min_y + grid.max_y) / 2 + grid.cell_length / 3)
    hx, hy = hot_center
    hot = rng.uniform(size=n) < hot_share
    x = rng.uniform(grid.min_x, grid.max_x, n)
    y = rng.uniform(grid.min_y, grid.max_y, n)
    x[hot] = hx + rng.uniform(-span / 2, span / 2, int(hot.sum()))
    y[hot] = hy + rng.uniform(-span / 2, span / 2, int(hot.sum()))
    # the cluster must stay inside the bbox whatever the center
    x = np.clip(x, grid.min_x, np.nextafter(grid.max_x, -np.inf))
    y = np.clip(y, grid.min_y, np.nextafter(grid.max_y, -np.inf))
    return x, y


def clustered_points(grid, n: int, hot_share: float, seed: int = 7,
                     t0: int = 1_700_000_000_000, dt_ms: int = 100,
                     hot_center: Optional[Tuple[float, float]] = None,
                     cluster_span_cells: float = 2.0,
                     id_pool: int = 4093) -> List:
    """``n`` :class:`~spatialflink_tpu_torch.models.Point` records on the
    clustered distribution, timestamps ``t0 + i * dt_ms`` (in order — the
    watermark-friendly shape every generator here emits). Object ids cycle
    through a bounded pool of ``id_pool`` ids (real feeds track a finite
    fleet; per-record-unique ids would make the decode interner the
    bottleneck and measure string hashing instead of the pipeline)."""
    from spatialflink_tpu_torch.models import Point

    x, y = clustered_xy(grid, n, hot_share, seed, hot_center,
                        cluster_span_cells)
    return [Point.create(float(x[i]), float(y[i]), grid,
                         obj_id=f"o{i % id_pool}",
                         timestamp=t0 + i * dt_ms)
            for i in range(n)]


def clustered_lines(grid, n: int, hot_share: float, seed: int = 7,
                    fmt: str = "csv", t0: int = 1_700_000_000_000,
                    dt_ms: int = 100,
                    hot_center: Optional[Tuple[float, float]] = None,
                    cluster_span_cells: float = 2.0,
                    id_pool: int = 4093) -> List[str]:
    """The same stream as serialized ingest lines (``csv`` rows matching
    schema [oID, ts, x, y], or ``geojson`` features) — what the driver-level
    suites and the bench feed through the real decode path."""
    x, y = clustered_xy(grid, n, hot_share, seed, hot_center,
                        cluster_span_cells)
    ts = t0 + np.arange(n, dtype=np.int64) * dt_ms
    if fmt.lower() == "csv":
        return [f"o{i % id_pool},{int(ts[i])},{x[i]:.7f},{y[i]:.7f}"
                for i in range(n)]
    if fmt.lower() == "geojson":
        from spatialflink_tpu_torch.models import Point
        from spatialflink_tpu_torch.streams.formats import serialize_spatial

        return [serialize_spatial(
            Point.create(float(x[i]), float(y[i]), grid,
                         obj_id=f"o{i % id_pool}",
                         timestamp=int(ts[i])), "GeoJSON")
                for i in range(n)]
    raise ValueError(f"clustered_lines supports csv/geojson, not {fmt!r}")
