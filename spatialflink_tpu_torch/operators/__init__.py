"""Continuous query operators (range and kNN over point, polygon and
linestring streams, single- and multi-query; joins of two such streams;
the six trajectory query families over a point stream)."""

from spatialflink_tpu_torch.operators.base import (Deferred, GeomQueryMixin,
                                                   QueryConfiguration,
                                                   QueryType, SpatialOperator,
                                                   WindowResult)
from spatialflink_tpu_torch.operators.join_query import (
    GeomGeomJoinQuery, GeomPointJoinQuery, LineStringLineStringJoinQuery,
    LineStringPointJoinQuery, LineStringPolygonJoinQuery, PointGeomJoinQuery,
    PointLineStringJoinQuery, PointPointJoinQuery, PointPolygonJoinQuery,
    PolygonLineStringJoinQuery, PolygonPointJoinQuery,
    PolygonPolygonJoinQuery)
from spatialflink_tpu_torch.operators.knn_query import (
    GeomGeomKNNQuery, GeomPointKNNQuery, LineStringLineStringKNNQuery,
    LineStringPointKNNQuery, LineStringPolygonKNNQuery, PointGeomKNNQuery,
    PointLineStringKNNQuery, PointPointKNNQuery, PointPolygonKNNQuery,
    PolygonLineStringKNNQuery, PolygonPointKNNQuery, PolygonPolygonKNNQuery)
from spatialflink_tpu_torch.operators.range_query import (
    GeomGeomRangeQuery, GeomPointRangeQuery, LineStringLineStringRangeQuery,
    LineStringPointRangeQuery, LineStringPolygonRangeQuery,
    PointGeomRangeQuery, PointLineStringRangeQuery, PointPointRangeQuery,
    PointPolygonRangeQuery, PolygonLineStringRangeQuery,
    PolygonPointRangeQuery, PolygonPolygonRangeQuery)
from spatialflink_tpu_torch.operators.trajectory import (
    PointPointTJoinQuery, PointPointTKNNQuery, PointPolygonTRangeQuery,
    PointTAggregateQuery, PointTFilterQuery, PointTStatsQuery, TAggregateQuery,
    TFilterQuery, TJoinQuery, TKNNQuery, TRangeQuery, TStatsQuery)

__all__ = ["Deferred", "GeomQueryMixin", "QueryConfiguration", "QueryType",
           "SpatialOperator", "WindowResult",
           "GeomGeomKNNQuery", "GeomPointKNNQuery",
           "LineStringLineStringKNNQuery", "LineStringPointKNNQuery",
           "LineStringPolygonKNNQuery", "PointGeomKNNQuery",
           "PointLineStringKNNQuery", "PointPointKNNQuery",
           "PointPolygonKNNQuery", "PolygonLineStringKNNQuery",
           "PolygonPointKNNQuery", "PolygonPolygonKNNQuery",
           "GeomGeomRangeQuery", "GeomPointRangeQuery",
           "LineStringLineStringRangeQuery", "LineStringPointRangeQuery",
           "LineStringPolygonRangeQuery", "PointGeomRangeQuery",
           "PointLineStringRangeQuery", "PointPointRangeQuery",
           "PointPolygonRangeQuery", "PolygonLineStringRangeQuery",
           "PolygonPointRangeQuery", "PolygonPolygonRangeQuery",
           "GeomGeomJoinQuery", "GeomPointJoinQuery",
           "LineStringLineStringJoinQuery", "LineStringPointJoinQuery",
           "LineStringPolygonJoinQuery", "PointGeomJoinQuery",
           "PointLineStringJoinQuery", "PointPointJoinQuery",
           "PointPolygonJoinQuery", "PolygonLineStringJoinQuery",
           "PolygonPointJoinQuery", "PolygonPolygonJoinQuery",
           "PointPointTJoinQuery", "PointPointTKNNQuery",
           "PointPolygonTRangeQuery", "PointTAggregateQuery",
           "PointTFilterQuery", "PointTStatsQuery", "TAggregateQuery",
           "TFilterQuery", "TJoinQuery", "TKNNQuery", "TRangeQuery",
           "TStatsQuery"]
