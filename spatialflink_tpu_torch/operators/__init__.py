"""Continuous query operators (windowed point-stream range queries)."""

from spatialflink_tpu_torch.operators.base import (Deferred, GeomQueryMixin,
                                                   QueryConfiguration,
                                                   QueryType, SpatialOperator,
                                                   WindowResult)
from spatialflink_tpu_torch.operators.range_query import (
    PointGeomRangeQuery, PointLineStringRangeQuery, PointPointRangeQuery,
    PointPolygonRangeQuery)

__all__ = ["Deferred", "GeomQueryMixin", "QueryConfiguration", "QueryType",
           "SpatialOperator", "WindowResult", "PointGeomRangeQuery",
           "PointLineStringRangeQuery", "PointPointRangeQuery",
           "PointPolygonRangeQuery"]
