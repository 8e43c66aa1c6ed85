"""StayTime app: per-cell stay time of moving objects, normalized by sensor
coverage (port of ``spatialflink_tpu.apps.stay_time``; reference
``apps/StayTime.java:32-485``).

- :meth:`StayTime.cell_stay_time_tuples` (``CellStayTimeWinFunction``,
  ``StayTime.java:227-396``): per object and window, time-sorted
  consecutive point pairs split their time delta across the grid cells
  they cross.
- :meth:`StayTime.cell_stay_time`: the per-cell window sum
  (``StayTime.java:432-448``).
- :meth:`StayTime.cell_sensor_range_intersection`
  (``StayTime.java:397-430``): per cell, the number of distinct timestamps
  whose sensor polygon intersects the cell's rectangle, holes honoured.
- :meth:`StayTime.normalized_cell_stay_time` (``StayTime.java:113-212``):
  ``((stay_ms / 1000) / intersections) * window_size_s`` per cell.

Cell splitting of one pair (last -> current), ``StayTime.java:270-371``:
the same cell takes the whole delta; the same x index splits it equally
over the inclusive y range of cells, the same y index over the x range;
otherwise over {last cell, current cell} and the cells of the segment's
bbox whose rectangle the segment meets (Liang–Barsky).

The JAX package splits each object's pairs with numpy, one object at a
time; here a window's pairs of every object are split in one pass over
its columns, objects in first-appearance order and each object's points
in time order, which is the JAX package's order of pairs, cells and
float additions. Host-only: no kernel runs.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, Iterator, List, Optional, Set, Tuple

import numpy as np

from spatialflink_tpu_torch.models import Point, Polygon
from spatialflink_tpu_torch.operators.base import (QueryType,
                                                   SpatialOperator,
                                                   WindowResult)


def _segment_intersects_rect(x0, y0, x1, y1, rect) -> bool:
    """Liang–Barsky clip test: does segment (x0,y0)-(x1,y1) meet the
    rect."""
    rx0, ry0, rx1, ry1 = rect
    dx, dy = x1 - x0, y1 - y0
    t0, t1 = 0.0, 1.0
    for p, q in ((-dx, x0 - rx0), (dx, rx1 - x0),
                 (-dy, y0 - ry0), (dy, ry1 - y0)):
        if p == 0:
            if q < 0:
                return False
            continue
        r = q / p
        if p < 0:
            if r > t1:
                return False
            t0 = max(t0, r)
        else:
            if r < t0:
                return False
            t1 = min(t1, r)
    return t0 <= t1


def _segments_intersect_rects(x0, y0, x1, y1, rx0, ry0, rx1, ry1
                              ) -> np.ndarray:
    """Vectorized Liang–Barsky over parallel (segment, rect) arrays: the
    scalar test's early exits equal its final ``t0 <= t1`` (t0 only grows,
    t1 only shrinks), so every edge clamps and one compare decides."""
    dx, dy = x1 - x0, y1 - y0
    t0 = np.zeros_like(dx)
    t1 = np.ones_like(dx)
    ok = np.ones(dx.shape, bool)
    for p, q in ((-dx, x0 - rx0), (dx, rx1 - x0),
                 (-dy, y0 - ry0), (dy, ry1 - y0)):
        para = p == 0
        ok &= ~(para & (q < 0))
        with np.errstate(divide="ignore", invalid="ignore"):
            r = q / np.where(para, 1.0, p)
        neg = ~para & (p < 0)
        pos = ~para & (p > 0)
        t0 = np.where(neg, np.maximum(t0, r), t0)
        t1 = np.where(pos, np.minimum(t1, r), t1)
    return ok & (t0 <= t1)


class StayTime(SpatialOperator):
    """The windowed stay-time pipeline over a uniform grid. Count windows
    are refused: the normalized join pairs the two streams by window
    start."""

    def __init__(self, conf, grid, *, device="cuda"):
        if conf.query_type is QueryType.CountBased:
            raise NotImplementedError(
                "CountBased queries are not yet supported")
        super().__init__(conf, grid, device=device)

    # ------------------------------------------------------------------ #
    # stage 1: per-(object, pair) stay-time shares

    def _split(self, ts, xs, ys, cs, same=None):
        """The shares of consecutive pairs of time-sorted points:
        ``(pair, cell, share_ms)`` arrays, pairs in order and cells
        ascending within a pair (pair ``i`` is points ``i`` -> ``i + 1``);
        ``same`` (one bool per pair) keeps only pairs of one object."""
        g = self.grid
        n = g.n
        c0, c1 = cs[:-1], cs[1:]
        x0, x1 = xs[:-1], xs[1:]
        y0, y1 = ys[:-1], ys[1:]
        ok = (c0 >= 0) & (c1 >= 0)
        if same is not None:
            ok &= same
        dt = (ts[1:] - ts[:-1]).astype(np.float64)
        cx0, cy0 = c0 // n, c0 % n
        cx1, cy1 = c1 // n, c1 % n
        same_cell = ok & (c0 == c1)
        col = ok & ~same_cell & (cx0 == cx1)
        row = ok & ~same_cell & (cy0 == cy1)
        diag = ok & ~same_cell & ~col & ~row
        reps: List[np.ndarray] = []
        cells_out: List[np.ndarray] = []
        counts_out: List[np.ndarray] = []

        def expand(i, lo, hi):
            """(pair reps, lo + 0..count-1, the count per element)."""
            counts = (hi - lo + 1).astype(np.int64)
            total = int(counts.sum())
            rep = np.repeat(i, counts)
            cum = np.concatenate([[0], np.cumsum(counts)])
            pos = np.arange(total) - np.repeat(cum[:-1], counts)
            return rep, np.repeat(lo, counts) + pos, np.repeat(counts, counts)

        i = np.nonzero(same_cell)[0]
        if i.size:
            reps.append(i)
            cells_out.append(c0[i])
            counts_out.append(np.ones(i.size, np.int64))
        i = np.nonzero(col)[0]
        if i.size:
            rep, vary, cnts = expand(i, np.minimum(cy0[i], cy1[i]),
                                     np.maximum(cy0[i], cy1[i]))
            reps.append(rep)
            cells_out.append(cx0[rep] * n + vary)
            counts_out.append(cnts)
        i = np.nonzero(row)[0]
        if i.size:
            rep, vary, cnts = expand(i, np.minimum(cx0[i], cx1[i]),
                                     np.maximum(cx0[i], cx1[i]))
            reps.append(rep)
            cells_out.append(vary * n + cy0[rep])
            counts_out.append(cnts)
        i = np.nonzero(diag)[0]
        if i.size:
            gx_lo = np.minimum(cx0[i], cx1[i])
            gx_hi = np.maximum(cx0[i], cx1[i])
            gy_lo = np.minimum(cy0[i], cy1[i])
            gy_hi = np.maximum(cy0[i], cy1[i])
            ny = gy_hi - gy_lo + 1
            counts = (gx_hi - gx_lo + 1) * ny
            total = int(counts.sum())
            rep = np.repeat(i, counts)
            cum = np.concatenate([[0], np.cumsum(counts)])
            pos = np.arange(total) - np.repeat(cum[:-1], counts)
            ny_r = np.repeat(ny, counts)
            cxs = np.repeat(gx_lo, counts) + pos // ny_r
            cys = np.repeat(gy_lo, counts) + pos % ny_r
            cand = cxs * n + cys
            rx0 = g.min_x + cxs * g.cell_length
            ry0 = g.min_y + cys * g.cell_length
            hit = _segments_intersect_rects(
                x0[rep], y0[rep], x1[rep], y1[rep],
                rx0, ry0, rx0 + g.cell_length, ry0 + g.cell_length)
            # the endpoint cells always share, as the scalar rule seeds
            hit |= (cand == c0[rep]) | (cand == c1[rep])
            rep, cand = rep[hit], cand[hit]
            cnts = np.bincount(rep, minlength=c0.shape[0])[rep]
            reps.append(rep)
            cells_out.append(cand)
            counts_out.append(cnts)
        if not reps:
            empty = np.zeros(0, np.int64)
            return empty, empty, np.zeros(0, np.float64)
        rep = np.concatenate(reps)
        cells = np.concatenate(cells_out)
        counts = np.concatenate(counts_out)
        order = np.lexsort((cells, rep))  # pair order, cells ascending
        rep, cells, counts = rep[order], cells[order], counts[order]
        return rep, cells, dt[rep] / counts

    def _pair_shares(self, pts: List[Point]
                     ) -> List[Tuple[int, int, int, float]]:
        """``(t0, t1, cell, share_ms)`` per crossed cell for one object's
        time-sorted points (the JAX package's per-object entry)."""
        if len(pts) < 2:
            return []
        ts = np.array([p.timestamp for p in pts], np.int64)
        rep, cells, shares = self._split(
            ts, np.array([p.x for p in pts], np.float64),
            np.array([p.y for p in pts], np.float64),
            np.array([p.cell for p in pts], np.int64))
        return list(zip(ts[rep].tolist(), ts[rep + 1].tolist(),
                        cells.tolist(), shares.tolist()))

    def _window_shares(self, records, allowed: Set[str]):
        """A window's pair shares over all its objects: ``(oid, t0, t1,
        cell, share)`` arrays, objects in first-appearance order (interned
        ids ``oid``), each object's points in time order (stable)."""
        x, y, ts, oid, cell, _ = records.columns()
        if allowed:
            uniq = np.unique(oid)
            ok = uniq[[records.interner.lookup(int(u)) in allowed
                       for u in uniq.tolist()]]
            keep = np.isin(oid, ok)
            x, y, ts, oid, cell = (a[keep] for a in (x, y, ts, oid, cell))
        uniq, first, inv = np.unique(oid, return_index=True,
                                     return_inverse=True)
        rank = np.empty(uniq.size, np.int64)
        rank[np.argsort(first, kind="stable")] = np.arange(uniq.size)
        obj = rank[inv.reshape(-1)]
        order = np.lexsort((ts, obj))
        obj, ts = obj[order], ts[order]
        rep, cells, shares = self._split(
            ts, x[order], y[order], cell[order].astype(np.int64),
            same=obj[1:] == obj[:-1])
        return oid[order][rep], ts[rep], ts[rep + 1], cells, shares

    def cell_stay_time_tuples(self, stream: Iterable,
                              traj_ids: Optional[Set[str]] = None
                              ) -> Iterator[WindowResult]:
        """Per window: ``(objID, t0, t1, cell, stay_share_ms)`` tuples
        (``Tuple5``, ``StayTime.java:383-391``)."""
        allowed = set(traj_ids or ())
        for start, end, records in self._windows(stream):
            oid, t0, t1, cells, shares = self._window_shares(records,
                                                             allowed)
            lk = records.interner.lookup
            yield WindowResult(start, end, [
                (lk(o), a, b, c, s) for o, a, b, c, s in zip(
                    oid.tolist(), t0.tolist(), t1.tolist(), cells.tolist(),
                    shares.tolist())])

    def cell_stay_time(self, stream: Iterable,
                       traj_ids: Optional[Set[str]] = None
                       ) -> Iterator[WindowResult]:
        """Per window: ``(cell, summed stay time ms)`` per touched cell,
        ascending; each cell's shares added in pair order."""
        allowed = set(traj_ids or ())
        for start, end, records in self._windows(stream):
            _, _, _, cells, shares = self._window_shares(records, allowed)
            sums: Dict[int, float] = defaultdict(float)
            for c, s in zip(cells.tolist(), shares.tolist()):
                sums[c] += s
            yield WindowResult(start, end, sorted(sums.items()))

    # ------------------------------------------------------------------ #
    # sensor coverage

    def _polygon_intersects_rect(self, poly: Polygon, rect) -> bool:
        """Rect–polygon intersection with interior rings: a rect strictly
        inside a hole does not intersect (JTS ``intersects`` in the
        reference's ``cellPoly.intersects(p.polygon)``)."""
        rx0, ry0, rx1, ry1 = rect
        bx0, by0, bx1, by1 = poly.bbox
        if bx1 < rx0 or bx0 > rx1 or by1 < ry0 or by0 > ry1:
            return False
        rings = [np.asarray(r, np.float64) for r in poly.rings]
        for ring in rings:
            # a ring vertex inside the rect: the boundary meets it
            if ((ring[:, 0] >= rx0) & (ring[:, 0] <= rx1)
                    & (ring[:, 1] >= ry0) & (ring[:, 1] <= ry1)).any():
                return True
            # a ring edge (shell or hole) crossing the rect
            for (x0, y0), (x1, y1) in zip(ring[:-1], ring[1:]):
                if _segment_intersects_rect(x0, y0, x1, y1, rect):
                    return True
        # no boundary contact: the rect lies inside the material, inside a
        # hole, or outside; an even-odd ray over all rings classifies one
        # corner (holes flip the parity back)
        x, y = rx0, ry0
        crossings = 0
        for ring in rings:
            xs0, ys0 = ring[:-1, 0], ring[:-1, 1]
            xs1, ys1 = ring[1:, 0], ring[1:, 1]
            cond = (ys0 > y) != (ys1 > y)
            with np.errstate(divide="ignore", invalid="ignore"):
                xint = xs0 + (y - ys0) / (ys1 - ys0) * (xs1 - xs0)
            crossings += int((cond & (x < xint)).sum())
        return bool(crossings % 2)

    def cell_sensor_range_intersection(self, polygon_stream: Iterable,
                                       traj_ids: Optional[Set[str]] = None
                                       ) -> Iterator[WindowResult]:
        """Per window: ``(cell, distinct timestamps whose polygon meets the
        cell's rectangle)``, ascending (``StayTime.java:397-430``)."""
        allowed = set(traj_ids or ())
        for start, end, records in self._windows(polygon_stream):
            ts_per_cell: Dict[int, Set[int]] = defaultdict(set)
            for poly in records.records():
                if allowed and poly.obj_id not in allowed:
                    continue
                for c in sorted(poly.cells):
                    if self._polygon_intersects_rect(
                            poly, self.grid.cell_bounds(c)):
                        ts_per_cell[c].add(poly.timestamp)
            yield WindowResult(start, end, sorted(
                (c, len(ts)) for c, ts in ts_per_cell.items()))

    # ------------------------------------------------------------------ #
    # the normalized join

    def normalized_cell_stay_time(self, point_stream: Iterable,
                                  polygon_stream: Iterable,
                                  traj_ids_points: Optional[Set[str]] = None,
                                  traj_ids_sensors: Optional[Set[str]] = None
                                  ) -> Iterator[WindowResult]:
        """The windowed cell join of stay time and sensor coverage,
        ``((stay_ms / 1000) / intersections) * window_size_s`` per cell
        (``StayTime.java:195-212``): records ``(cell, start, end,
        normalized_stay_s)``; a window appears when both sides have it (a
        two-pointer merge on window start)."""
        window_size_s = self.conf.window_size_ms / 1000.0
        sit = iter(self.cell_stay_time(point_stream, traj_ids_points))
        cit = iter(self.cell_sensor_range_intersection(polygon_stream,
                                                       traj_ids_sensors))
        s, c = next(sit, None), next(cit, None)
        while s is not None and c is not None:
            if s.window_start == c.window_start:
                start = s.window_start
                end = start + self.conf.window_size_ms
                stay, cover = dict(s.records), dict(c.records)
                yield WindowResult(start, end, [
                    (cell, start, end,
                     (stay[cell] / 1000.0) / cover[cell] * window_size_s)
                    for cell in sorted(set(stay) & set(cover))
                    if cover[cell] > 0])
                s, c = next(sit, None), next(cit, None)
            elif s.window_start < c.window_start:
                s = next(sit, None)
            else:
                c = next(cit, None)
