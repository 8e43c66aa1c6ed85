"""Spatial index layer."""

from spatialflink_tpu_torch.index.uniform_grid import (UniformGrid,
                                                        cheb_layers)

__all__ = ["UniformGrid", "cheb_layers"]
