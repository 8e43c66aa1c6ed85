"""Spatial object model: host objects and padded device batches."""

from spatialflink_tpu_torch.models.batches import (EdgeGeomBatch, PointBatch,
                                                    from_jax_arrays,
                                                    single_query_edges)
from spatialflink_tpu_torch.models.objects import (GeometryCollection,
                                                    LineString,
                                                    MultiLineString,
                                                    MultiPoint, MultiPolygon,
                                                    Point, Polygon,
                                                    SpatialObject)

__all__ = ["SpatialObject", "Point", "Polygon", "LineString", "MultiPoint",
           "MultiPolygon", "MultiLineString", "GeometryCollection",
           "EdgeGeomBatch", "PointBatch", "from_jax_arrays",
           "single_query_edges"]
