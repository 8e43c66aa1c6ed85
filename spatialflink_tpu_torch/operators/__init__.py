"""Continuous query operators (range and kNN over point, polygon and
linestring streams, single- and multi-query)."""

from spatialflink_tpu_torch.operators.base import (Deferred, GeomQueryMixin,
                                                   QueryConfiguration,
                                                   QueryType, SpatialOperator,
                                                   WindowResult)
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
           "PolygonPointRangeQuery", "PolygonPolygonRangeQuery"]
