"""Point-stream continuous kNN, windowed (port of ``PointPointKNNQuery``,
``_GenericKnn`` and ``PointGeomKNNQuery`` of
``spatialflink_tpu.operators.knn_query``: ``run`` and ``run_multi``).

The radius prunes candidate *cells* only — windowed kNN does not
radius-filter exact distances; radius 0 disables pruning. Each window is
one launch of the K2 kernel (``ops/knn.py``): eligibility, each object's
minimum distance, and the exact top-k ordered by (distance, interned id).
Point queries compute the distance inside K2; polygon/linestring queries
take it from K4 (one query) or the K4x lattice (Q queries), or from the
bbox in approximate mode. Records are (objID, distance) pairs resolved
through the window's interner, whose size is K2's per-object table size.

Approximate mode: the JAX package also switches its selection to
``lax.approx_min_k`` (``_knn_strategy``, recall < 1); the port keeps its one
exact selection, so its list is the JAX ``sort`` strategy's and JAX's
approximate list is a prefix of it.

Not yet ported: panes (``merge_partials``), the device mesh, bulk replay
and ``run_dynamic``.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional

from spatialflink_tpu_torch.models import Point
from spatialflink_tpu_torch.operators.base import (GeomQueryMixin,
                                                   SpatialOperator,
                                                   WindowResult)
from spatialflink_tpu_torch.ops import distances as D
from spatialflink_tpu_torch.ops import geom as G
from spatialflink_tpu_torch.ops import knn as K


class _KnnOperator(SpatialOperator):
    """The kNN drive loops shared by the point and geometry query forms:
    per run, a closure ``local(batch, num_ids) -> (KnnResult, dist_evals)``
    evaluates one window batch."""

    def _drive_single(self, stream, local, k: int
                      ) -> Iterator[WindowResult]:
        def eval_batch(records, ts_base):
            if not len(records):
                return []
            res, evals = local(self._point_batch(records, ts_base),
                               len(records.interner))
            return self._defer_knn(res, records.interner, evals)

        for result in self._drive(stream, eval_batch):
            result.extras["k"] = k
            yield result

    def _drive_multi(self, stream, n_queries: int, local, k: int
                     ) -> Iterator[WindowResult]:
        """Shared run_multi loop: one (Q, k) dispatch per window."""
        def eval_batch(records, ts_base):
            if not len(records):
                return [[] for _ in range(n_queries)]
            res, evals = local(self._point_batch(records, ts_base),
                               len(records.interner))
            return self._defer_knn_multi(res, records.interner, evals)

        for result in self._drive(stream, eval_batch):
            result.extras["k"] = k
            result.extras["queries"] = n_queries
            yield result


class PointPointKNNQuery(_KnnOperator):
    """Point stream x point query."""

    def run(self, stream: Iterable, query_point: Point, radius: float,
            k: Optional[int] = None) -> Iterator[WindowResult]:
        k = k or self.conf.k
        return self._drive_single(stream, self._knn_result(
            [query_point], radius, k, single=True), k)

    def _nb_layers(self, radius: float) -> int:
        """Candidate-cell layer count; radius 0 disables pruning (every
        cell is a neighbour) — one rule for run() and run_multi()."""
        return (self.grid.n if radius == 0
                else self.grid.candidate_layers(radius))

    def _knn_result(self, query_points: List[Point], radius: float, k: int,
                    *, single: bool):
        """The per-batch closure: ``knn_point_stats`` for one query
        (``single``), ``knn_point_multi_stats`` for Q."""
        qx, qy, qc = self._query_point_arrays(query_points, self.device)
        fn = K.knn_point_stats if single else K.knn_point_multi_stats
        nb_layers = self._nb_layers(radius)

        def local(b, num_ids):
            return fn(b, qx, qy, qc, nb_layers, n=self.grid.n, k=k,
                      num_ids=num_ids)

        return local

    def run_multi(self, stream: Iterable, query_points: List[Point],
                  radius: float, k: Optional[int] = None
                  ) -> Iterator[WindowResult]:
        """Q continuous kNN queries over ONE stream in ONE dispatch per
        window: ``records[q]`` is the (objID, distance) list of
        ``query_points[q]``, ``extras["queries"] = Q``; all queries share
        ``radius``."""
        k = k or self.conf.k
        return self._drive_multi(stream, len(query_points), self._knn_result(
            query_points, radius, k, single=False), k)


class _GenericKnn(_KnnOperator, GeomQueryMixin):
    """kNN against a polygon/linestring query: the subclass gives the
    per-run setup and the per-batch distances; eligibility (valid, in grid,
    in a neighbouring cell) is fused into K2."""

    def _knn_eval(self, setup, k: int):
        def local(b, num_ids):
            return K.knn_masked_stats(b, self._dists(b, setup), setup["nb"],
                                      k=k, num_ids=num_ids)
        return local

    def run(self, stream: Iterable, query, radius: float,
            k: Optional[int] = None) -> Iterator[WindowResult]:
        k = k or self.conf.k
        return self._drive_single(
            stream, self._knn_eval(self._setup(query, radius), k), k)

    def run_multi(self, stream: Iterable, queries, radius: float,
                  k: Optional[int] = None) -> Iterator[WindowResult]:
        """Q queries in ONE dispatch per window — contract as
        :meth:`PointPointKNNQuery.run_multi`."""
        k = k or self.conf.k
        return self._drive_multi(stream, len(queries),
                                 self._multi_local(queries, radius, k), k)


class PointGeomKNNQuery(_GenericKnn):
    """Point stream x polygon/linestring query (``PointPolygonKNNQuery``,
    ``PointLineStringKNNQuery``)."""

    def _setup(self, query, radius: float) -> dict:
        return dict(nb=self._query_nb(query, radius),
                    edges=self._query_edges(query),
                    bbox=self._query_bbox(query))

    def _dists(self, batch, setup):
        """(N,) distance to the query: K4, or the bbox in approximate
        mode."""
        if self.conf.approximate:
            b = setup["bbox"]
            return D.point_bbox_dist(batch.x, batch.y, b[0], b[1], b[2], b[3])
        return G.points_to_single_geom_dist(batch, *setup["edges"])

    def _multi_local(self, query_geoms, radius: float, k: int):
        """Q polygon/linestring queries: one padded query edge batch
        through the K4x lattice (bbox distances in approximate mode)."""
        gb = self._query_geom_batch(query_geoms)
        nb_masks = self._stack_query_nb(query_geoms, radius)

        def local(b, num_ids):
            return G.knn_points_to_geom_queries(
                b, gb, nb_masks, k=k, num_ids=num_ids,
                approximate=self.conf.approximate)

        return local


# Reference-named aliases (stream type x query type)
PointPolygonKNNQuery = PointGeomKNNQuery
PointLineStringKNNQuery = PointGeomKNNQuery
