"""Continuous range queries, windowed and realtime (port of ``run`` and
``run_multi`` of ``PointPointRangeQuery``, ``PointGeomRangeQuery``,
``GeomPointRangeQuery`` and ``GeomGeomRangeQuery`` of
``spatialflink_tpu.operators.range_query``).

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
``extras["queries"] = Q``. With ``conf.panes`` every ``run`` and
``run_multi`` evaluates each pane once and concatenates a window's pane
selections in pane order (``merge_partials``). ``run_dynamic`` (point
queries, over a point or a polygon/linestring stream) serves the live
fleet of a ``runtime.queryplane.QueryRegistry``.

With ``conf.adaptive_grid`` the point-stream operators prefilter each
window on the host (``SpatialOperator._prefilter``): ``run`` against the
query's GN ∪ CN leaf mask (a query point's tightened to its fine cell
inside a split cell), ``run_multi`` and ``run_dynamic`` against the union
of the queries' masks; the kernels run on the kept rows. The
geometry-stream operators do not prefilter, as in the JAX package.

The device ops are looked up on their modules
at call time (``R.range_filter_point_stats``,
``G.points_to_single_geom_dist``, ...), so a caller can run the same
pipeline with the plain versions by setting those module attributes.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List

from spatialflink_tpu_torch.models import Point
from spatialflink_tpu_torch.operators.base import (BulkReplay,
                                                   GeomQueryMixin,
                                                   SpatialOperator,
                                                   WindowResult)
from spatialflink_tpu_torch.ops import distances as D
from spatialflink_tpu_torch.ops import geom as G
from spatialflink_tpu_torch.ops import range as R


class PointPointRangeQuery(BulkReplay, SpatialOperator):
    """Point stream x point query."""
    telemetry_label = "range"

    bulk_panes = True

    #: the pane merge of every range pair: disjoint panes concatenate
    merge_partials = staticmethod(SpatialOperator._pane_concat)

    def run(self, stream: Iterable, query_point: Point, radius: float
            ) -> Iterator[WindowResult]:
        # --adaptive-grid: the query's GN ∪ CN leaf mask, tightened to the
        # point's fine cell inside a split cell
        mask_cache = self._leaf_mask_cache(
            lambda: self.conf.adaptive_grid.neighboring_leaf_mask(
                radius, query_point.cell,
                point=(query_point.x, query_point.y)))
        return self._drive(
            stream, self._filter_eval(self._mask_stats_fn(query_point,
                                                          radius),
                                      mask_cache),
            pane_merge=self.merge_partials)

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
        def union_leaf_mask():
            return self.conf.adaptive_grid.union_neighboring_leaf_mask(
                radius, [(q.cell, (q.x, q.y)) for q in query_points])

        return self._run_multi_filter(
            stream, len(query_points),
            self._multi_mask_stats(query_points, radius),
            leaf_mask_builder=union_leaf_mask)

    def run_dynamic(self, stream: Iterable, registry, radius: float
                    ) -> Iterator[WindowResult]:
        """The standing point queries of ``registry``, admitted, updated
        and retired while the stream runs, each change landing at the next
        window (``_run_dynamic_filter``); ``records[q]`` is the selection
        of ``extras["query_ids"][q]``."""
        ag = self.conf.adaptive_grid
        leaf_union = None
        if ag is not None:
            def leaf_union(pts):
                return ag.union_neighboring_leaf_mask(
                    radius, [(p.cell, (p.x, p.y)) for p in pts])

        return self._run_dynamic_filter(stream, registry, radius,
                                        self._multi_mask_stats,
                                        leaf_union_builder=leaf_union)


class PointGeomRangeQuery(BulkReplay, SpatialOperator, GeomQueryMixin):
    """Point stream x polygon/linestring query."""
    telemetry_label = "range"

    bulk_panes = True

    merge_partials = staticmethod(SpatialOperator._pane_concat)

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
        # --adaptive-grid: the leaf mask over the union of the geometry's
        # base cells
        mask_cache = self._leaf_mask_cache(
            lambda: self.conf.adaptive_grid.neighboring_leaf_mask(
                radius, self._query_cells(query_geom)))
        return self._drive(
            stream, self._filter_eval(self._mask_stats_fn(query_geom,
                                                          radius),
                                      mask_cache),
            pane_merge=self.merge_partials)

    def _multi_mask_stats(self, query_geoms, radius: float):
        qgb = self._query_geom_batch(query_geoms)
        gn, cn = self._stack_query_masks(query_geoms, radius)
        return lambda batch: G.range_points_to_geom_queries(
            batch, qgb, gn, cn, radius, approximate=self.conf.approximate)

    def run_multi(self, stream: Iterable, query_geoms, radius: float
                  ) -> Iterator[WindowResult]:
        """Q polygon/linestring queries over ONE point stream in ONE
        dispatch per window (the K4x lattice, then K1's mask mode)."""
        def union_leaf_mask():
            return self.conf.adaptive_grid.union_neighboring_leaf_mask(
                radius, [(self._query_cells(q), None) for q in query_geoms])

        return self._run_multi_filter(
            stream, len(query_geoms),
            self._multi_mask_stats(query_geoms, radius),
            leaf_mask_builder=union_leaf_mask)


class _GeomStreamRange(BulkReplay, SpatialOperator, GeomQueryMixin):
    """Polygon/linestring stream x any query: the subclass gives the
    per-run closure ``batch -> (masks (Q, G), gn (Q,), evals (Q,))``."""
    telemetry_label = "range"

    merge_partials = staticmethod(SpatialOperator._pane_concat)

    def run(self, stream: Iterable, query, radius: float
            ) -> Iterator[WindowResult]:
        mask_stats = self._multi_mask_stats([query], radius)

        def eval_batch(records, ts_base):
            if not len(records):
                return []
            masks, gn_c, evals = mask_stats(self._geom_batch(records,
                                                             ts_base))
            return self._defer_mask_select(masks[0], records, (gn_c, evals))

        return self._drive(stream, eval_batch,
                           pane_merge=self.merge_partials)

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

    def run_dynamic(self, stream: Iterable, registry, radius: float
                    ) -> Iterator[WindowResult]:
        """The standing point queries of ``registry`` over a polygon or
        linestring stream: the contract of
        :meth:`PointPointRangeQuery.run_dynamic`."""
        return self._run_dynamic_filter(stream, registry, radius,
                                        self._multi_mask_stats,
                                        self._geom_batch)


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
