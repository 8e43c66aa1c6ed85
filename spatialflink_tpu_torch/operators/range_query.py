"""Point-stream continuous range queries, windowed (port of
``PointPointRangeQuery.run`` and ``PointGeomRangeQuery.run`` of
``spatialflink_tpu.operators.range_query``).

Guaranteed-cell points are emitted without a distance computation;
candidate-cell points pass iff their exact distance is <= r; approximate
mode emits every candidate point (point query) or filters on the bbox
distance instead of the exact geometry distance (polygon/linestring query).

The device ops are looked up on their modules at call time
(``R.range_filter_point_stats``, ``G.points_to_single_geom_dist``), so a
caller can run the same pipeline with the plain versions by setting those
module attributes.
"""

from __future__ import annotations

from typing import Iterable, Iterator

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


# Reference-named aliases (stream type x query type)
PointPolygonRangeQuery = PointGeomRangeQuery
PointLineStringRangeQuery = PointGeomRangeQuery
