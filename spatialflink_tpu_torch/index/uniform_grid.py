"""Uniform grid spatial index (port of ``spatialflink_tpu.index.uniform_grid``).

The host-side parts are copies of the JAX package's: float64 cell
assignment, the reference's layer math, and the dense GN/CN/NB cell masks.
:func:`cheb_layers` is the device-side Chebyshev layer distance, on tensors.

- Cells are ``cell = cx * n + cy`` int32 ids; -1 marks a point outside the
  grid.
- guaranteed layers = floor(r / (cellLength * sqrt(2))) - 1 (-1 means no
  guaranteed cells); candidate layers = ceil(r / cellLength).
- ``radius == 0`` in :meth:`UniformGrid.neighboring_cells_mask` selects all
  cells.
"""

from __future__ import annotations

import math
from typing import Iterable, Set, Tuple, Union

import numpy as np
import torch

#: Chebyshev layer of a pair with an invalid (-1) cell: never within reach
NO_LAYER = 2 ** 30


class UniformGrid:
    """An n x n square grid over a bounding box: ``num_grid_partitions=n``,
    or ``cell_length=L`` (the bbox is first made square by growing its
    shorter axis symmetrically)."""

    def __init__(self, min_x: float, max_x: float, min_y: float,
                 max_y: float, *, num_grid_partitions: int | None = None,
                 cell_length: float | None = None):
        if (num_grid_partitions is None) == (cell_length is None):
            raise ValueError(
                "pass exactly one of num_grid_partitions or cell_length")
        self.min_x, self.max_x = float(min_x), float(max_x)
        self.min_y, self.max_y = float(min_y), float(max_y)
        if cell_length is not None:
            self._adjust_for_square_grid()
            grid_length = math.hypot(0.0, self.max_x - self.min_x)
            rows = grid_length / cell_length
            self.n = 1 if rows < 1 else int(math.ceil(rows))
        else:
            self.n = int(num_grid_partitions)
        self.cell_length = (self.max_x - self.min_x) / self.n

    def _adjust_for_square_grid(self) -> None:
        dx = self.max_x - self.min_x
        dy = self.max_y - self.min_y
        if dx > dy:
            d = (dx - dy) / 2
            self.max_y += d
            self.min_y -= d
        elif dy > dx:
            d = (dy - dx) / 2
            self.max_x += d
            self.min_x -= d

    @property
    def num_cells(self) -> int:
        return self.n * self.n

    # ------------------------------------------------------------------ #
    # cell assignment (host, float64)

    def cell_indices(self, x, y) -> Tuple[np.ndarray, np.ndarray]:
        """Coordinates -> integer cell indices (cx, cy) by floor division;
        out-of-bbox coordinates give out-of-range indices."""
        cx = np.floor((np.asarray(x, np.float64) - self.min_x)
                      / self.cell_length)
        cy = np.floor((np.asarray(y, np.float64) - self.min_y)
                      / self.cell_length)
        return cx.astype(np.int64), cy.astype(np.int64)

    def valid_indices(self, cx, cy):
        cx, cy = np.asarray(cx), np.asarray(cy)
        return (cx >= 0) & (cy >= 0) & (cx < self.n) & (cy < self.n)

    def assign_cell(self, x, y) -> Tuple[np.ndarray, np.ndarray]:
        """Coordinates -> (cell id int32, valid bool); cell is -1 if invalid."""
        cx, cy = self.cell_indices(x, y)
        valid = self.valid_indices(cx, cy)
        cell = np.where(valid, cx * self.n + cy, -1).astype(np.int32)
        return cell, valid

    def cell_id(self, cx: int, cy: int) -> int:
        return int(cx) * self.n + int(cy)

    def bbox_cells(self, min_x: float, min_y: float, max_x: float,
                   max_y: float) -> Set[int]:
        """All valid cells overlapped by a bounding box."""
        cx1, cy1 = self.cell_indices(min_x, min_y)
        cx2, cy2 = self.cell_indices(max_x, max_y)
        out: Set[int] = set()
        for cx in range(int(cx1), int(cx2) + 1):
            for cy in range(int(cy1), int(cy2) + 1):
                if 0 <= cx < self.n and 0 <= cy < self.n:
                    out.add(self.cell_id(cx, cy))
        return out

    # ------------------------------------------------------------------ #
    # layer math

    def guaranteed_layers(self, radius: float) -> int:
        """floor(r / cellDiagonal) - 1; -1 => no guaranteed cells."""
        cell_diagonal = self.cell_length * math.sqrt(2.0)
        return int(math.floor(radius / cell_diagonal - 1))

    def candidate_layers(self, radius: float) -> int:
        """ceil(r / cellLength)."""
        return int(math.ceil(radius / self.cell_length))

    # ------------------------------------------------------------------ #
    # dense (n*n,) neighboring-cell masks

    def _layer_mask(self, cells: Iterable[int], layers: int) -> np.ndarray:
        mask = np.zeros((self.n, self.n), dtype=bool)
        if layers < 0:
            return mask.reshape(-1)
        for cell in cells:
            cx, cy = int(cell) // self.n, int(cell) % self.n
            x0, x1 = max(0, cx - layers), min(self.n, cx + layers + 1)
            y0, y1 = max(0, cy - layers), min(self.n, cy + layers + 1)
            mask[x0:x1, y0:y1] = True
        return mask.reshape(-1)

    @staticmethod
    def _as_cells(cells: Union[int, Iterable[int]]) -> Iterable[int]:
        if isinstance(cells, (int, np.integer)):
            return (int(cells),)
        return cells

    def guaranteed_cells_mask(self, radius: float,
                              cells: Union[int, Iterable[int]]) -> np.ndarray:
        """Guaranteed neighboring cells of query cell(s) (union over a
        geometry's cells)."""
        return self._layer_mask(self._as_cells(cells),
                                self.guaranteed_layers(radius))

    def candidate_cells_mask(self, radius: float,
                             cells: Union[int, Iterable[int]],
                             guaranteed_mask: np.ndarray | None = None
                             ) -> np.ndarray:
        """Cells within the candidate layers minus the guaranteed set."""
        if guaranteed_mask is None:
            guaranteed_mask = self.guaranteed_cells_mask(radius, cells)
        cand = self._layer_mask(self._as_cells(cells),
                                self.candidate_layers(radius))
        return cand & ~guaranteed_mask

    def neighboring_cells_mask(self, radius: float,
                               cells: Union[int, Iterable[int]]) -> np.ndarray:
        """GN ∪ CN; ``radius == 0`` selects all cells."""
        if radius == 0:
            return np.ones(self.num_cells, dtype=bool)
        return self._layer_mask(self._as_cells(cells),
                                self.candidate_layers(radius))

    def __repr__(self) -> str:
        return (
            f"UniformGrid(n={self.n}, cell_length={self.cell_length:.6g}, "
            f"bbox=[{self.min_x}, {self.min_y}, {self.max_x}, {self.max_y}])"
        )


def cheb_layers(cell_a: torch.Tensor, cell_b, n: int) -> torch.Tensor:
    """Chebyshev layer distance between cell ids on an n x n grid, int32;
    ``NO_LAYER`` (2**30) where either cell is invalid (-1).
    ``cheb_layers(a, b, n) <= L`` is "cell a lies within L layers of b"."""
    ax = torch.div(cell_a, n, rounding_mode="floor")
    ay = torch.remainder(cell_a, n)
    if isinstance(cell_b, torch.Tensor):
        bx = torch.div(cell_b, n, rounding_mode="floor")
        by = torch.remainder(cell_b, n)
    else:  # a host int: no device tensor for a scalar
        cell_b = int(cell_b)
        bx, by = cell_b // n, cell_b % n
    layers = torch.maximum((ax - bx).abs(), (ay - by).abs())
    ok = (cell_a >= 0) & (cell_b >= 0)
    return torch.where(ok, layers, torch.full_like(layers, NO_LAYER))
