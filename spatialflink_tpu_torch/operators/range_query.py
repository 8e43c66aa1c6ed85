"""Continuous range queries, windowed and realtime (port of ``run`` and
``run_multi`` of ``PointPointRangeQuery``, ``PointGeomRangeQuery``,
``GeomPointRangeQuery`` and ``GeomGeomRangeQuery`` of
``spatialflink_tpu.operators.range_query``, without the adaptive-grid leaf
prefilter, which the port does not have).

Point streams: guaranteed-cell points are emitted without a distance
computation; candidate-cell points pass iff their exact distance is <= r;
approximate mode emits every candidate point (point query) or filters on
the bbox distance instead of the exact geometry distance
(polygon/linestring query). ``run_multi`` answers Q queries in one dispatch
per window: K1 with a query axis for query points, the K4x lattice plus
K1's mask mode with a query axis for query polygons/linestrings.

Polygon and linestring streams (the reference's ``PolygonPointRangeQuery``
and its siblings): a geometry whose cells are ALL guaranteed passes without
a distance; one with a neighbouring cell passes iff its exact distance (the
bbox distance in approximate mode) is <= r. Every window, single- or
multi-query, is ONE launch of K5 (``ops/geom.py`` range entries) with the
query axis; ``run`` is its Q = 1 row.

``records[q]`` holds query q's selection under ``run_multi`` and
``extras["queries"] = Q``. The device ops are looked up on their modules
at call time (``R.range_filter_point_stats``,
``G.points_to_single_geom_dist``, ...), so a caller can run the same
pipeline with the plain versions by setting those module attributes.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List

from spatialflink_tpu_torch.models import Point
from spatialflink_tpu_torch.operators.base import (GeomQueryMixin,
                                                   SpatialOperator,
                                                   WindowResult)
from spatialflink_tpu_torch.ops import distances as D
from spatialflink_tpu_torch.ops import geom as G
from spatialflink_tpu_torch.ops import range as R


class PointPointRangeQuery(SpatialOperator):
    """Point stream x point query."""

    def run(self, stream: Iterable, query_point: Point, radius: float
            ) -> Iterator[WindowResult]:
        mask_stats = self._mask_stats_fn(query_point, radius)

        def eval_batch(records, ts_base):
            if not len(records):
                return []
            batch = self._point_batch(records, ts_base)
            mask, gn_c, evals = self._filter_stream(batch, mask_stats)
            return self._defer_mask_select(mask, records, (gn_c, evals))

        return self._drive(stream, eval_batch)

    def _mask_stats_fn(self, query_point: Point, radius: float):
        """Per-batch (mask, gn_bypassed, dist_evals) closure."""
        args = (query_point.x, query_point.y, query_point.cell, radius,
                self.grid.guaranteed_layers(radius),
                self.grid.candidate_layers(radius))

        def mask_stats(b):
            mask, _, gn_c, evals = R.range_filter_point_stats(
                b, *args, n=self.grid.n, approximate=self.conf.approximate,
                return_dists=False)
            return mask, gn_c, evals

        return mask_stats

    def _multi_mask_stats(self, query_points: List[Point], radius: float):
        """Per-batch (masks (Q, N), gn (Q,), evals (Q,)) closure."""
        qx, qy, qc = self._query_point_arrays(query_points, self.device)
        args = (radius, self.grid.guaranteed_layers(radius),
                self.grid.candidate_layers(radius))

        def multi_mask_stats(b):
            return R.range_filter_point_multi_masks(
                b, qx, qy, qc, *args, n=self.grid.n,
                approximate=self.conf.approximate)

        return multi_mask_stats

    def run_multi(self, stream: Iterable, query_points: List[Point],
                  radius: float) -> Iterator[WindowResult]:
        """Q query points over ONE stream in ONE dispatch per window; all
        queries share ``radius``."""
        return self._run_multi_filter(
            stream, len(query_points),
            self._multi_mask_stats(query_points, radius))


class PointGeomRangeQuery(SpatialOperator, GeomQueryMixin):
    """Point stream x polygon/linestring query."""

    def _mask_stats_fn(self, query_geom, radius: float):
        gn, cn = self._query_masks(query_geom, radius)
        pip = None if self.conf.approximate else self._query_pip(query_geom)
        q_bbox = self._query_bbox(query_geom)

        def mask_stats(batch):
            if self.conf.approximate:
                dists = D.point_bbox_dist(batch.x, batch.y, q_bbox[0],
                                          q_bbox[1], q_bbox[2], q_bbox[3])
            else:
                dists = G.points_to_single_geom_dist(
                    batch, pip.edges, pip.edge_mask, pip.is_areal, table=pip)
            return R.range_filter_masks_stats(batch, gn, cn, dists, radius)

        return mask_stats

    def run(self, stream: Iterable, query_geom, radius: float
            ) -> Iterator[WindowResult]:
        mask_stats = self._mask_stats_fn(query_geom, radius)

        def eval_batch(records, ts_base):
            if not len(records):
                return []
            batch = self._point_batch(records, ts_base)
            mask, gn_c, evals = self._filter_stream(batch, mask_stats)
            return self._defer_mask_select(mask, records, (gn_c, evals))

        return self._drive(stream, eval_batch)

    def _multi_mask_stats(self, query_geoms, radius: float):
        qgb = self._query_geom_batch(query_geoms)
        gn, cn = self._stack_query_masks(query_geoms, radius)
        return lambda batch: G.range_points_to_geom_queries(
            batch, qgb, gn, cn, radius, approximate=self.conf.approximate)

    def run_multi(self, stream: Iterable, query_geoms, radius: float
                  ) -> Iterator[WindowResult]:
        """Q polygon/linestring queries over ONE point stream in ONE
        dispatch per window (the K4x lattice, then K1's mask mode)."""
        return self._run_multi_filter(
            stream, len(query_geoms),
            self._multi_mask_stats(query_geoms, radius))


class _GeomStreamRange(SpatialOperator, GeomQueryMixin):
    """Polygon/linestring stream x any query: the subclass gives the
    per-run closure ``batch -> (masks (Q, G), gn (Q,), evals (Q,))``."""

    def run(self, stream: Iterable, query, radius: float
            ) -> Iterator[WindowResult]:
        mask_stats = self._multi_mask_stats([query], radius)

        def eval_batch(records, ts_base):
            if not len(records):
                return []
            masks, gn_c, evals = mask_stats(self._geom_batch(records,
                                                             ts_base))
            return self._defer_mask_select(masks[0], records, (gn_c, evals))

        return self._drive(stream, eval_batch)

    def run_multi(self, stream: Iterable, queries, radius: float
                  ) -> Iterator[WindowResult]:
        """Q queries over ONE polygon/linestring stream in ONE K5 launch
        per window; all queries share ``radius``."""
        return self._run_multi_filter(
            stream, len(queries), self._multi_mask_stats(queries, radius),
            self._geom_batch)


class GeomPointRangeQuery(_GeomStreamRange):
    """Polygon/linestring stream x point query (``PolygonPointRangeQuery``,
    ``LineStringPointRangeQuery``)."""

    def _multi_mask_stats(self, query_points, radius: float):
        qx, qy, _qc = self._query_point_arrays(query_points, self.device)
        gn, nb = self._stack_query_masks(query_points, radius,
                                         which=("gn", "nb"))
        return lambda geoms: G.range_geoms_to_point_queries(
            geoms, qx, qy, gn, nb, radius,
            approximate=self.conf.approximate)


class GeomGeomRangeQuery(_GeomStreamRange):
    """Polygon/linestring stream x polygon/linestring query
    (``PolygonPolygonRangeQuery`` and the three sibling pairs); the Q
    queries ride one exact-capacity padded edge batch."""

    def _multi_mask_stats(self, query_geoms, radius: float):
        qgb = self._query_geom_batch(query_geoms)
        gn, nb = self._stack_query_masks(query_geoms, radius,
                                         which=("gn", "nb"))
        return lambda geoms: G.range_geoms_to_geom_queries(
            geoms, qgb, gn, nb, radius, approximate=self.conf.approximate)


# Reference-named aliases (stream type x query type)
PointPolygonRangeQuery = PointGeomRangeQuery
PointLineStringRangeQuery = PointGeomRangeQuery
PolygonPointRangeQuery = GeomPointRangeQuery
LineStringPointRangeQuery = GeomPointRangeQuery
PolygonPolygonRangeQuery = GeomGeomRangeQuery
PolygonLineStringRangeQuery = GeomGeomRangeQuery
LineStringPolygonRangeQuery = GeomGeomRangeQuery
LineStringLineStringRangeQuery = GeomGeomRangeQuery
