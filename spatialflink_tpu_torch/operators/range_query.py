"""Point-stream continuous range queries, windowed (port of ``run`` and
``run_multi`` of ``PointPointRangeQuery`` and ``PointGeomRangeQuery`` of
``spatialflink_tpu.operators.range_query``, without the adaptive-grid leaf
prefilter, which the port does not have).

Guaranteed-cell points are emitted without a distance computation;
candidate-cell points pass iff their exact distance is <= r; approximate
mode emits every candidate point (point query) or filters on the bbox
distance instead of the exact geometry distance (polygon/linestring query).

``run_multi`` answers Q queries in one dispatch per window: K1 with a query
axis for query points, the K4x lattice plus K1's mask mode with a query
axis for query polygons/linestrings; ``records[q]`` holds query q's
selection and ``extras["queries"] = Q``.

The device ops are looked up on their modules at call time
(``R.range_filter_point_stats``, ``G.points_to_single_geom_dist``, ...), so
a caller can run the same pipeline with the plain versions by setting those
module attributes.
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
                b, *args, n=self.grid.n, approximate=self.conf.approximate)
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
        q_edges, q_mask, q_areal = self._query_edges(query_geom)
        q_bbox = self._query_bbox(query_geom)

        def mask_stats(batch):
            if self.conf.approximate:
                dists = D.point_bbox_dist(batch.x, batch.y, q_bbox[0],
                                          q_bbox[1], q_bbox[2], q_bbox[3])
            else:
                dists = G.points_to_single_geom_dist(batch, q_edges, q_mask,
                                                     q_areal)
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


# Reference-named aliases (stream type x query type)
PointPolygonRangeQuery = PointGeomRangeQuery
PointLineStringRangeQuery = PointGeomRangeQuery
