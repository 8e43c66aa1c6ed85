"""Continuous kNN, windowed and realtime (port of ``PointPointKNNQuery``,
``_GenericKnn``, ``PointGeomKNNQuery``, ``_GeomStreamKnn``,
``GeomPointKNNQuery`` and ``GeomGeomKNNQuery`` of
``spatialflink_tpu.operators.knn_query``: ``run`` and ``run_multi``).

The radius prunes candidate *cells* only — windowed kNN does not
radius-filter exact distances; radius 0 disables pruning. Each window ends
in one launch of the K2 kernel (``ops/knn.py``): eligibility, each object's
minimum distance, and the exact top-k ordered by (distance, interned id).
Point queries over a point stream compute the distance inside K2;
polygon/linestring queries take it from K4 (one query) or the K4x lattice
(Q queries), or from the bbox in approximate mode. Over a polygon or
linestring stream, K5 (``ops/geom.py``) computes the eligibility (valid,
with a neighbouring cell) and the distances of the eligible geometries to
Q query points or geometries in one launch, and K2 takes them in its
eligible mode. Records are (objID, distance) pairs resolved through the
id space of the batch: the window's decode interner for a point stream,
the operator's own interner for a geometry stream (whose batches intern
through it, as the JAX package's ``_geom_batch`` does); its size is K2's
per-object table size.

Realtime mode: a micro-batch of ``realtime_batch_size`` records would still
size K2's per-object table by the whole stream's id count, so its interned
ids are compacted on the host first (``np.unique`` of at most a batch of
ints; the unique ids come out sorted, so ascending local id is ascending
interned id and distance ties break as in the uncompacted call): K2 runs
with the batch's distinct count as ``num_ids`` and the result ids map back
at readback. Windowed and count modes keep the interner's size.

Approximate mode: the JAX package also switches its selection to
``lax.approx_min_k`` (``_knn_strategy``, recall < 1); the port keeps its one
exact selection, so its list is the JAX ``sort`` strategy's and JAX's
approximate list is a prefix of it.

Panes (``conf.panes``): each pane's K2 result is a partial; a window's
merge is :func:`merge_partials` on the host (ties in interned-id order,
through the id space the partials were built in) or, for the device merge
(:func:`_knn_device_merge`), one K3 launch over the partials still on the
device, whose merged list alone is read back.
``PointPointKNNQuery.run_dynamic`` serves the live fleet of a
``runtime.queryplane.QueryRegistry`` (option 51 under ``--queries-file``).

Not yet ported: the device mesh and bulk replay.
"""

from __future__ import annotations

from typing import Iterable, Iterator, List, Optional

import numpy as np

from spatialflink_tpu_torch.models import Point
from spatialflink_tpu_torch.models.batches import to_device
from spatialflink_tpu_torch.operators.base import (Deferred, GeomQueryMixin,
                                                   SpatialOperator,
                                                   WindowResult, _knn_pairs)
from spatialflink_tpu_torch.ops import distances as D
from spatialflink_tpu_torch.ops import geom as G
from spatialflink_tpu_torch.ops import knn as K


class _CompactIds:
    """The id lookup of a compacted micro-batch: local id ``i`` is
    interned id ``ids[i]``."""

    __slots__ = ("ids", "interner")

    def __init__(self, ids: np.ndarray, interner):
        self.ids = ids
        self.interner = interner

    def __len__(self) -> int:
        return int(self.ids.shape[0])

    def lookup(self, i: int) -> str:
        return self.interner.lookup(int(self.ids[i]))


def merge_partials(parts, k: int, interner):
    """The host pane merge of every kNN pair: per-pane (objID, distance)
    lists -> the window's exact top-k (``ops.knn.merge_topk_host``).
    ``interner`` is the id space the partials were built in: its
    ``intern`` reproduces the kernels' equal-distance order (ascending
    interned id), never string order."""
    return K.merge_topk_host(parts, k, tie_key=interner.intern)


def _merge_partials_multi(op, n_queries: int, k: int):
    """Per-query :func:`merge_partials` for the multi-query paths."""
    def merge(parts):
        return [merge_partials([p[q] for p in parts], k, op._id_space)
                for q in range(n_queries)]
    return merge


def _knn_device_merge(op, k: int, n_queries: Optional[int] = None):
    """The device pane merge of the kNN families: a window's partials, (k,)
    or (Q, k) K2 results still on the device, merge in one K3 launch
    (``ops.knn.knn_merge_parts``, which reads them where they lie) and
    only the merged list is read back. Returns None, and the host merge
    runs with the same result,
    where the JAX package's does: a part that is not a device partial, or
    partials of another id space than the run's. A partial's distance
    count rides the first merged readback that takes it
    (``PanePartial.stats_done``)."""
    def merge(parts):
        devs = []
        for p in parts:
            v = p.value
            if (not isinstance(v, Deferred) or len(v.device_result) != 4
                    or v.ids is not op._id_space):
                return None
            devs.append(v.device_result)
        results = [K.KnnResult(*d[:3]) for d in devs]
        merged = K.knn_merge_parts(results, k)
        evals = []
        for p, d in zip(parts, devs):
            if not p.stats_done:
                evals.append(d[3])
                p.stats_done = True
        ids = op._id_space

        def collect(host):
            oid, dist, valid, *ev = host
            op.pruning["distance-computations"] += sum(int(e.sum())
                                                       for e in ev)
            if n_queries is None:
                return _knn_pairs(oid, dist, valid, ids)
            return [_knn_pairs(o, d, v, ids)
                    for o, d, v in zip(oid, dist, valid)]

        return Deferred((*merged, *evals), collect)

    return merge


class _KnnOperator(SpatialOperator):
    """The kNN drive loops shared by the point and geometry query forms:
    per run, a closure ``local(batch, num_ids) -> (KnnResult, dist_evals)``
    evaluates one window batch."""

    @property
    def _id_space(self):
        """The id space of the run's windowed results: the stream's decode
        interner for a point stream (set by the first batch), the
        operator's own for a geometry stream."""
        seen = getattr(self, "_ids_seen", None)
        return self.interner if seen is None else seen

    def _knn_batch(self, records, ts_base: int):
        """``(batch, id lookup)``: the lookup's size is K2's ``num_ids``;
        in realtime mode the batch carries compacted ids."""
        if not self.realtime:
            self._ids_seen = records.interner
            return self._point_batch(records, ts_base), records.interner
        batch, ids = records.point_batch(ts_base, self.device, compact=True)
        return batch, _CompactIds(ids, records.interner)

    def _drive_single(self, stream, local, k: int
                      ) -> Iterator[WindowResult]:
        def eval_batch(records, ts_base):
            if not len(records):
                return []
            batch, ids = self._knn_batch(records, ts_base)
            res, evals = local(batch, len(ids))
            return self._defer_knn(res, ids, evals)

        for result in self._drive(
                stream, eval_batch,
                pane_merge=lambda parts: merge_partials(parts, k,
                                                        self._id_space),
                pane_device_merge=_knn_device_merge(self, k)):
            result.extras["k"] = k
            yield result

    def _drive_multi(self, stream, n_queries: int, local, k: int
                     ) -> Iterator[WindowResult]:
        """Shared run_multi loop: one (Q, k) dispatch per window."""
        def eval_batch(records, ts_base):
            if not len(records):
                return [[] for _ in range(n_queries)]
            batch, ids = self._knn_batch(records, ts_base)
            res, evals = local(batch, len(ids))
            return self._defer_knn_multi(res, ids, evals)

        for result in self._multi_results(
                stream, eval_batch,
                pane_merge=_merge_partials_multi(self, n_queries, k),
                pane_device_merge=_knn_device_merge(self, k, n_queries)):
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

    def run_dynamic(self, stream: Iterable, registry, radius: float,
                    k: Optional[int] = None) -> Iterator[WindowResult]:
        """The standing kNN queries of ``registry``: per window,
        ``registry.apply()``, the padded fleet's (B, k) launch rebuilt on a
        ``fleet_version`` bump, the distance counts gated by the valid
        slots, and only the live slots read out (``extras["query_ids"]``).
        Full-window evaluation: pane partials are fleet-shaped."""
        k = k or self.conf.k
        state: dict = {"v": -1, "entries": [], "local": None, "gate": None}

        def ensure() -> None:
            if state["v"] == registry.fleet_version:
                return
            entries, qpts, valid = registry.padded_fleet(self.grid)
            local = gate = None
            if entries:
                local = self._knn_result(qpts, radius, k, single=False)
                gate = to_device(valid, np.bool_, self.device)
            state.update(v=registry.fleet_version, entries=entries,
                         local=local, gate=gate)

        window_ids: dict = {}

        def eval_batch(records, ts_base):
            registry.apply()
            ensure()
            live = len(state["entries"])
            window_ids[ts_base] = [e.id for e in state["entries"]]
            if not live:
                return []
            if not len(records):
                return [[] for _ in range(live)]
            batch, ids = self._knn_batch(records, ts_base)
            res, evals = state["local"](batch, len(ids))
            return self._defer_knn_multi(res, ids, evals * state["gate"],
                                         live)

        for result in self._drive(stream, eval_batch):
            ids = window_ids.pop(result.window_start, [])
            result.extras["query_ids"] = ids
            result.extras["queries"] = len(ids)
            result.extras["k"] = k
            yield result


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
                    pip=(None if self.conf.approximate
                         else self._query_pip(query)),
                    bbox=self._query_bbox(query))

    def _dists(self, batch, setup):
        """(N,) distance to the query: K4, or the bbox in approximate
        mode."""
        if self.conf.approximate:
            b = setup["bbox"]
            return D.point_bbox_dist(batch.x, batch.y, b[0], b[1], b[2], b[3])
        pip = setup["pip"]
        return G.points_to_single_geom_dist(batch, pip.edges, pip.edge_mask,
                                            pip.is_areal, table=pip)

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


class _GeomStreamKnn(_KnnOperator, GeomQueryMixin):
    """kNN over a polygon/linestring stream: the subclass gives the
    per-run closure ``local(geoms, num_ids) -> (KnnResult (Q, k),
    dist_evals (Q,))``, one K5 and one K2 launch per window."""

    @property
    def _id_space(self):
        return self.interner

    def _knn_batch(self, records, ts_base: int):
        """``(batch, id lookup)``: the operator's interner, or in realtime
        mode the micro-batch's compacted ids."""
        batch, ids = records.geom_batch(ts_base, self.device, self.interner,
                                        compact=self.realtime)
        if ids is None:
            return batch, self.interner
        return batch, _CompactIds(ids, self.interner)

    def run(self, stream: Iterable, query, radius: float,
            k: Optional[int] = None) -> Iterator[WindowResult]:
        k = k or self.conf.k
        multi = self._multi_local([query], radius, k)

        def local(b, num_ids):
            res, evals = multi(b, num_ids)
            return K.KnnResult(*(t[0] for t in res)), evals[0]

        return self._drive_single(stream, local, k)

    def run_multi(self, stream: Iterable, queries, radius: float,
                  k: Optional[int] = None) -> Iterator[WindowResult]:
        """Q queries in ONE dispatch per window — contract as
        :meth:`PointPointKNNQuery.run_multi`."""
        k = k or self.conf.k
        return self._drive_multi(stream, len(queries),
                                 self._multi_local(queries, radius, k), k)


class GeomPointKNNQuery(_GeomStreamKnn):
    """Polygon/linestring stream x point query (``PolygonPointKNNQuery``,
    ``LineStringPointKNNQuery``)."""

    def _multi_local(self, query_points, radius: float, k: int):
        qx, qy, _qc = self._query_point_arrays(query_points, self.device)
        nb = self._stack_query_nb(query_points, radius)

        def local(geoms, num_ids):
            return G.knn_geoms_to_point_queries(
                geoms, qx, qy, nb, k=k, num_ids=num_ids,
                approximate=self.conf.approximate)

        return local


class GeomGeomKNNQuery(_GeomStreamKnn):
    """Polygon/linestring stream x polygon/linestring query (the remaining
    four pairs); the Q queries ride one exact-capacity padded edge
    batch."""

    def _multi_local(self, query_geoms, radius: float, k: int):
        qgb = self._query_geom_batch(query_geoms)
        nb = self._stack_query_nb(query_geoms, radius)

        def local(geoms, num_ids):
            return G.knn_geoms_to_geom_queries(
                geoms, qgb, nb, k=k, num_ids=num_ids,
                approximate=self.conf.approximate)

        return local


# Reference-named aliases (stream type x query type)
PointPolygonKNNQuery = PointGeomKNNQuery
PointLineStringKNNQuery = PointGeomKNNQuery
PolygonPointKNNQuery = GeomPointKNNQuery
LineStringPointKNNQuery = GeomPointKNNQuery
PolygonPolygonKNNQuery = GeomGeomKNNQuery
PolygonLineStringKNNQuery = GeomGeomKNNQuery
LineStringPolygonKNNQuery = GeomGeomKNNQuery
LineStringLineStringKNNQuery = GeomGeomKNNQuery
