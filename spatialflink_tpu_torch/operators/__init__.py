"""Continuous query operators (windowed point-stream range and kNN
queries, single- and multi-query)."""

from spatialflink_tpu_torch.operators.base import (Deferred, GeomQueryMixin,
                                                   QueryConfiguration,
                                                   QueryType, SpatialOperator,
                                                   WindowResult)
from spatialflink_tpu_torch.operators.knn_query import (
    PointGeomKNNQuery, PointLineStringKNNQuery, PointPointKNNQuery,
    PointPolygonKNNQuery)
from spatialflink_tpu_torch.operators.range_query import (
    PointGeomRangeQuery, PointLineStringRangeQuery, PointPointRangeQuery,
    PointPolygonRangeQuery)

__all__ = ["Deferred", "GeomQueryMixin", "QueryConfiguration", "QueryType",
           "SpatialOperator", "WindowResult", "PointGeomKNNQuery",
           "PointLineStringKNNQuery", "PointPointKNNQuery",
           "PointPolygonKNNQuery", "PointGeomRangeQuery",
           "PointLineStringRangeQuery", "PointPointRangeQuery",
           "PointPolygonRangeQuery"]
