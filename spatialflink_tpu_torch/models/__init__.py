"""Spatial object model: host objects and padded device batches."""

from spatialflink_tpu_torch.models.batches import (PointBatch,
                                                    from_jax_arrays,
                                                    single_query_edges)
from spatialflink_tpu_torch.models.objects import (LineString, MultiPolygon,
                                                    Point, Polygon,
                                                    SpatialObject)

__all__ = ["SpatialObject", "Point", "Polygon", "LineString", "MultiPolygon",
           "PointBatch", "from_jax_arrays", "single_query_edges"]
