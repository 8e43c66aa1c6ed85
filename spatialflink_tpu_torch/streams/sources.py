"""Sources (port of ``SyntheticPointSource``, ``generate_query_polygons``
and ``kafka_source`` of ``spatialflink_tpu.streams.sources``).

- :class:`SyntheticPointSource` — deterministic random-walk trajectories,
  the rebuild of the reference's queryOption 99 dummy-data generator, in
  the JAX package's draw order (same seed, same points).
- :func:`generate_query_polygons` — cell-sized square query polygons
  tiling the grid (``HelperClass.generateQueryPolygons``).

- :func:`kafka_source` — a consumer group's record values from a topic.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Tuple

import numpy as np

from spatialflink_tpu_torch.index import UniformGrid
from spatialflink_tpu_torch.models import Point, Polygon


class SyntheticPointSource:
    """Deterministic random-walk trajectory generator over a grid bbox.

    Emits :class:`Point` objects with object ids ``traj-<i>`` and timestamps
    advancing ``dt_ms`` per step, in arrival order interleaved across
    trajectories; a share ``out_of_order_fraction`` of the points is moved
    up to ``out_of_order_max_ms`` into the past. :meth:`columns` gives the
    same stream as arrays without building the objects."""

    def __init__(self, grid: UniformGrid, num_trajectories: int = 100,
                 steps: int = 100, dt_ms: int = 1000,
                 step_std: float = 0.002,
                 start_ts: int = 1_700_000_000_000, seed: int = 0,
                 out_of_order_fraction: float = 0.0,
                 out_of_order_max_ms: int = 0):
        self.grid = grid
        self.num_trajectories = num_trajectories
        self.steps = steps
        self.dt_ms = dt_ms
        self.step_std = step_std
        self.start_ts = start_ts
        self.seed = seed
        self.out_of_order_fraction = out_of_order_fraction
        self.out_of_order_max_ms = out_of_order_max_ms

    def columns(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                               np.ndarray]:
        """(x f64, y f64, ts int64, trajectory index int64) of every point
        in arrival order, from the random draws of the JAX package's
        generator in its order (one uniform per out-of-order test, one
        integer per late point, interleaved with the steps' normals)."""
        rng = np.random.default_rng(self.seed)
        g = self.grid
        t = self.num_trajectories
        n = t * self.steps
        xs = rng.uniform(g.min_x, g.min_x + g.cell_length * g.n, t)
        ys = rng.uniform(g.min_y, g.min_y + g.cell_length * g.n, t)
        x = np.empty(n, np.float64)
        y = np.empty(n, np.float64)
        ts = np.empty(n, np.int64)
        frac = self.out_of_order_fraction
        hi = self.out_of_order_max_ms + 1
        for step in range(self.steps):
            base = self.start_ts + step * self.dt_ms
            xs = xs + rng.normal(0, self.step_std, t)
            ys = ys + rng.normal(0, self.step_std, t)
            lo = step * t
            x[lo:lo + t] = xs
            y[lo:lo + t] = ys
            ts[lo:lo + t] = base
            if frac:
                for i in range(t):
                    if rng.random() < frac:
                        ts[lo + i] -= int(rng.integers(0, hi))
        traj = np.tile(np.arange(t, dtype=np.int64), self.steps)
        return x, y, ts, traj

    def __iter__(self) -> Iterator[Point]:
        x, y, ts, traj = self.columns()
        for xi, yi, ti, ki in zip(x.tolist(), y.tolist(), ts.tolist(),
                                  traj.tolist()):
            yield Point.create(xi, yi, self.grid, obj_id=f"traj-{ki}",
                               timestamp=ti)


def generate_query_polygons(num: int, grid: UniformGrid) -> List[Polygon]:
    """Deterministic cell-sized square query polygons tiling the grid bbox,
    column-major, ``min(num, n * n)`` of them (the JAX package's rebuild of
    ``HelperClass.generateQueryPolygons``, ``utils/HelperClass.java:387-
    439``, with its deliberate deviations: this grid's cell length, no
    overshoot of the count, a reproducible order)."""
    side = grid.cell_length
    if side <= 0:  # degenerate bbox: no cells, no tiles
        return []
    out: List[Polygon] = []
    for ix in range(grid.n):
        if len(out) >= num:
            break
        x = grid.min_x + ix * side
        for iy in range(grid.n):
            if len(out) >= num:
                break
            y = grid.min_y + iy * side
            out.append(Polygon.create(
                [[(x, y), (x + side, y), (x + side, y + side),
                  (x, y + side), (x, y)]], grid))
    return out


def kafka_source(topic: str, bootstrap_servers: str = "", *, broker=None,
                 group: str = "spatialflink", **consumer_kwargs
                 ) -> Iterable[str]:
    """A consumer group's record values from ``topic``, from its committed
    offset to the topic's end: through ``broker`` (an ``InMemoryBroker``
    or any object of the broker interface) when given, else through the
    broker ``bootstrap_servers`` names (``streams.kafka.resolve_broker``:
    ``memory://<name>``, or a real cluster, which needs kafka-python).
    ``consumer_kwargs`` go to ``streams.kafka.KafkaSource``."""
    from spatialflink_tpu_torch.streams.kafka import (KafkaSource,
                                                      resolve_broker)

    if broker is None:
        broker = resolve_broker(bootstrap_servers)
    yield from KafkaSource(broker, topic, group, **consumer_kwargs)
