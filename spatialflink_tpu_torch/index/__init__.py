"""Spatial index layer."""

from spatialflink_tpu_torch.index.adaptive_grid import AdaptiveGrid
from spatialflink_tpu_torch.index.uniform_grid import (UniformGrid,
                                                        cheb_layers)

__all__ = ["AdaptiveGrid", "UniformGrid", "cheb_layers"]
