"""Skew-adaptive two-level grid (port of
``spatialflink_tpu.index.adaptive_grid``, numpy only).

A refinement layer over :class:`UniformGrid` for skewed (Zipfian) streams,
where most records land in a few cells and base-cell pruning passes nearly
everything:

- Records keep their BASE cell ids everywhere (``PointChunk``, device
  batches, per-cell operator state): the kernels never see leaf ids, so a
  repartition never changes a kernel's inputs' meaning.
- The refinement defines a LEAF space over the same bbox: each base cell
  is its own leaf, split into ``refine x refine`` fine leaves (hot cells),
  or absorbed into one coarse leaf spanning an aligned ``coarsen x
  coarsen`` block of cold base cells. Leaves partition the bbox exactly.
- :meth:`AdaptiveGrid.assign_leaf` is the vectorized two-stage assignment
  (base floor-divide, table gather, fine sub-index where split).
- The GN / CN / neighbouring leaf masks are the reference's layer rules
  per level, on the FINE lattice (units of ``cell_length / refine``):
  guaranteed ``(cheb_max + 1) * fine_diag <= r``, candidate
  ``(cheb_min - 1) * fine_len <= r``. For unsplit leaves they reproduce
  the uniform grid's masks; the candidate boundary is inclusive, which
  makes the pre-kernel prefilter keep every record within ``r`` for any
  layout.
- Layouts are VERSIONED: every :meth:`AdaptiveGrid.apply_layout` that
  changes the leaf space bumps :attr:`AdaptiveGrid.version`, the key of
  the operators' cached per-query leaf masks.

The float arithmetic of :meth:`AdaptiveGrid.assign_leaf` and of the mask
rectangles is the JAX package's, in the same order: a leaf or cell edge is
where a reordered expression would give another leaf.
"""

from __future__ import annotations

import math
from typing import Iterable, List, Optional, Sequence, Set, Tuple, Union

import numpy as np

from spatialflink_tpu_torch.index.uniform_grid import UniformGrid


class AdaptiveGrid:
    """A versioned two-level leaf partition over a :class:`UniformGrid`.

    ``refine``  — hot base cells subdivide ``refine x refine`` (>= 2).
    ``coarsen`` — cold neighborhoods merge as aligned ``coarsen x coarsen``
    blocks of base cells into one leaf (>= 2; blocks never contain split
    cells). The default layout (no splits, no coarse blocks) is exactly the
    base grid: one leaf per base cell, masks equal to the uniform masks.
    """

    def __init__(self, base: UniformGrid, refine: int = 4, coarsen: int = 2):
        if refine < 2:
            raise ValueError(f"refine={refine}: must be >= 2")
        if coarsen < 2:
            raise ValueError(f"coarsen={coarsen}: must be >= 2")
        self.base = base
        self.refine = int(refine)
        self.coarsen = int(coarsen)
        #: monotonic layout stamp: bumped by every layout CHANGE; cached
        #: per-query leaf masks key on it
        self.version = 0
        self._split: Set[int] = set()
        self._coarse: Set[Tuple[int, int]] = set()
        self._rebuild()

    # ------------------------------------------------------------------ #
    # layout

    @property
    def n(self) -> int:
        return self.base.n

    @property
    def num_leaves(self) -> int:
        return int(self._leaf_fx0.shape[0])

    @property
    def fine_length(self) -> float:
        return self.base.cell_length / self.refine

    def split_cells(self) -> List[int]:
        return sorted(self._split)

    def coarse_blocks(self) -> List[Tuple[int, int]]:
        return sorted(self._coarse)

    def layout(self) -> dict:
        """JSON-able layout document (the checkpoint manifest's ``grid``
        component and the ``/partition`` endpoint's core payload)."""
        return {
            "version": self.version,
            "n": self.n,
            "refine": self.refine,
            "coarsen": self.coarsen,
            "num_leaves": self.num_leaves,
            "split_cells": self.split_cells(),
            "coarse_blocks": [list(b) for b in self.coarse_blocks()],
        }

    def apply_layout(self, split_cells: Iterable[int],
                     coarse_blocks: Iterable[Sequence[int]] = ()) -> bool:
        """Install a layout; returns True (and bumps :attr:`version`) iff
        the leaf space actually changed. Split cells must be valid base
        cells; coarse blocks are ``(block_x, block_y)`` coordinates on the
        ``coarsen``-aligned block lattice and silently exclude any block
        containing a split cell (split wins — the block stays at base
        granularity)."""
        splits = {int(c) for c in split_cells}
        bad = [c for c in splits if not 0 <= c < self.n * self.n]
        if bad:
            raise ValueError(f"split cells out of range: {bad[:8]}")
        blocks = set()
        nb = -(-self.n // self.coarsen)  # block lattice size (ceil)
        for b in coarse_blocks:
            bx, by = int(b[0]), int(b[1])
            if not (0 <= bx < nb and 0 <= by < nb):
                raise ValueError(f"coarse block out of range: {(bx, by)}")
            if any(m in splits for m in self._block_members(bx, by)):
                continue
            blocks.add((bx, by))
        if splits == self._split and blocks == self._coarse:
            return False
        self._split = splits
        self._coarse = blocks
        self.version += 1
        self._rebuild()
        return True

    def _block_members(self, bx: int, by: int) -> List[int]:
        n, c = self.n, self.coarsen
        return [cx * n + cy
                for cx in range(bx * c, min((bx + 1) * c, n))
                for cy in range(by * c, min((by + 1) * c, n))]

    def _rebuild(self) -> None:
        """Recompute the leaf tables. O(num_leaves + n^2) numpy/Python —
        runs per REPARTITION (epoch granularity), never per record."""
        n, k = self.n, self.refine
        num_base = n * n
        leaf_of_base = np.full(num_base, -1, np.int32)
        is_split = np.zeros(num_base, bool)
        # leaf geometry, as inclusive rects on the fine lattice
        fx0: List[int] = []
        fx1: List[int] = []
        fy0: List[int] = []
        fy1: List[int] = []
        anchor: List[int] = []   # base cell anchoring the leaf (min member)
        sub: List[int] = []      # fine sub-index for split leaves, else -1

        def add_leaf(ax0, ax1, ay0, ay1, base_cell, sub_idx=-1) -> int:
            fx0.append(ax0)
            fx1.append(ax1)
            fy0.append(ay0)
            fy1.append(ay1)
            anchor.append(base_cell)
            sub.append(sub_idx)
            return len(fx0) - 1

        c = self.coarsen
        # coarse blocks first: every member base cell maps to ONE leaf
        for bx, by in sorted(self._coarse):
            members = self._block_members(bx, by)
            x_lo = (bx * c) * k
            x_hi = min((bx + 1) * c, n) * k - 1
            y_lo = (by * c) * k
            y_hi = min((by + 1) * c, n) * k - 1
            leaf = add_leaf(x_lo, x_hi, y_lo, y_hi, min(members))
            for m in members:
                leaf_of_base[m] = leaf
        # base-level leaves
        for cell in range(num_base):
            if leaf_of_base[cell] >= 0 or cell in self._split:
                continue
            cx, cy = cell // n, cell % n
            leaf_of_base[cell] = add_leaf(cx * k, cx * k + k - 1,
                                          cy * k, cy * k + k - 1, cell)
        # split blocks last: leaf_of_base holds the block's FIRST leaf id
        # and assign_leaf adds the fine sub-index (sub = sx * k + sy)
        for cell in sorted(self._split):
            cx, cy = cell // n, cell % n
            first = None
            for sx in range(k):
                for sy in range(k):
                    leaf = add_leaf(cx * k + sx, cx * k + sx,
                                    cy * k + sy, cy * k + sy,
                                    cell, sub_idx=sx * k + sy)
                    if first is None:
                        first = leaf
            leaf_of_base[cell] = first
            is_split[cell] = True

        self._leaf_of_base = leaf_of_base
        self._base_is_split = is_split
        self._leaf_fx0 = np.asarray(fx0, np.int64)
        self._leaf_fx1 = np.asarray(fx1, np.int64)
        self._leaf_fy0 = np.asarray(fy0, np.int64)
        self._leaf_fy1 = np.asarray(fy1, np.int64)
        self._leaf_anchor = np.asarray(anchor, np.int32)
        self._leaf_sub = np.asarray(sub, np.int32)

    # ------------------------------------------------------------------ #
    # assignment (vectorized two-stage)

    def assign_leaf(self, x, y) -> np.ndarray:
        """(x, y) coordinates -> leaf ids; -1 outside the bbox. Stage 1 is
        the uniform floor-divide (identical arithmetic to
        ``UniformGrid.cell_indices`` — no observer feed: records were
        already observed at decode time under their base cells); stage 2 is
        a table gather plus, for split cells only, the fine sub-index from
        the cell-relative fraction. One numpy pass, any array shape."""
        base = self.base
        x = np.asarray(x, np.float64)
        y = np.asarray(y, np.float64)
        cx, cy = base.cell_indices(x, y)
        valid = base.valid_indices(cx, cy)
        cell = np.where(valid, cx * self.n + cy, 0).astype(np.int64)
        leaf = self._leaf_of_base[cell].astype(np.int64)
        if self._split:
            k = self.refine
            # cell-relative fraction in [0, 1) -> fine sub-cell, clipped so
            # float round-off at the upper cell edge stays inside the cell
            rx = (x - base.min_x) / base.cell_length - cx
            ry = (y - base.min_y) / base.cell_length - cy
            sx = np.clip(np.floor(rx * k).astype(np.int64), 0, k - 1)
            sy = np.clip(np.floor(ry * k).astype(np.int64), 0, k - 1)
            leaf = np.where(self._base_is_split[cell], leaf + sx * k + sy,
                            leaf)
        return np.where(valid, leaf, -1).astype(np.int32)

    def leaf_of_cell(self, cell: int) -> int:
        """The (first) leaf of a base cell — for split cells, the fine
        block's first leaf."""
        return int(self._leaf_of_base[int(cell)])

    def leaf_bounds(self, leaf: int) -> Tuple[float, float, float, float]:
        """(min_x, min_y, max_x, max_y) of a leaf in coordinate space."""
        fl = self.fine_length
        b = self.base
        return (b.min_x + float(self._leaf_fx0[leaf]) * fl,
                b.min_y + float(self._leaf_fy0[leaf]) * fl,
                b.min_x + float(self._leaf_fx1[leaf] + 1) * fl,
                b.min_y + float(self._leaf_fy1[leaf] + 1) * fl)

    # ------------------------------------------------------------------ #
    # wire format

    def cell_key(self, leaf: int) -> str:
        """Reference wire parity: the first 10 characters are exactly the
        uniform grid's two 5-digit zero-padded indices of the leaf's anchor
        base cell (``CELLINDEXSTRLENGTH = 5``, ``UniformGrid.java:40,92``);
        split leaves append ``:<sub>`` (the fine sub-index inside the base
        cell) so refined keys stay unambiguous while base-cell consumers
        can keep keying on the 10-char prefix."""
        base_key = self.base.cell_key(int(self._leaf_anchor[leaf]))
        s = int(self._leaf_sub[leaf])
        return base_key if s < 0 else f"{base_key}:{s}"

    def cell_from_key(self, key: str) -> int:
        base_cell = self.base.cell_from_key(key[:10])
        leaf = self.leaf_of_cell(base_cell)
        if len(key) > 10:
            if key[10] != ":":
                raise ValueError(f"malformed adaptive cell key {key!r}")
            sub = int(key[11:])
            if not self._base_is_split[base_cell]:
                raise ValueError(
                    f"key {key!r} names a sub-cell of unsplit cell "
                    f"{base_cell}")
            return leaf + sub
        return leaf

    # ------------------------------------------------------------------ #
    # masks over the leaf space

    def _query_rects(self, cells: Union[int, Iterable[int]],
                     point: Optional[Tuple[float, float]] = None
                     ) -> List[Tuple[int, int, int, int]]:
        """The query as inclusive fine-lattice rects: one per query base
        cell (the cell's full fine extent — geometry queries are only known
        by the cells they overlap, ``UniformGrid.java:193-222`` union
        semantics); a known query POINT collapses its cell's rect to the
        exact fine cell, which is what makes point-query masks tight inside
        split cells."""
        if isinstance(cells, (int, np.integer)):
            cells = (int(cells),)
        k, n = self.refine, self.n
        rects = []
        for cell in cells:
            cell = int(cell)
            if cell < 0:
                continue
            cx, cy = cell // n, cell % n
            if point is not None:
                px, py = point
                qcx, qcy = self.base.cell_indices(px, py)
                if int(qcx) == cx and int(qcy) == cy:
                    # exact fine coords of the point (same clip rule as
                    # assign_leaf's stage 2)
                    rx = (px - self.base.min_x) / self.base.cell_length - cx
                    ry = (py - self.base.min_y) / self.base.cell_length - cy
                    sx = min(k - 1, max(0, int(math.floor(rx * k))))
                    sy = min(k - 1, max(0, int(math.floor(ry * k))))
                    fx = cx * k + sx
                    fy = cy * k + sy
                    rects.append((fx, fx, fy, fy))
                    continue
            rects.append((cx * k, cx * k + k - 1, cy * k, cy * k + k - 1))
        return rects

    def _mask_parts(self, radius: float,
                    cells: Union[int, Iterable[int]],
                    point: Optional[Tuple[float, float]] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """(gn, nb) boolean masks over the leaf space — the evaluator
        behind the guaranteed and candidate masks, which need GN (the
        neighbouring mask alone goes through :meth:`_nb_union`)."""
        return self._mask_parts_rects(radius, self._query_rects(cells,
                                                                point))

    def union_neighboring_leaf_mask(self, radius: float, queries
                                    ) -> np.ndarray:
        """The OR of many queries' GN∪CN leaf masks in ONE pass —
        ``queries`` is a sequence of ``(cells, point)`` pairs (``point``
        may be None). This is the multi-query prefilter's mask, rebuilt at
        every grid-version bump; all the queries' fine rects go into one
        evaluation (:meth:`_nb_union`)."""
        rects: List[Tuple[int, int, int, int]] = []
        for cells, point in queries:
            rects.extend(self._query_rects(cells, point))
        if radius == 0:
            return np.ones(self.num_leaves, bool)
        return self._nb_union(radius, rects)

    def _nb_union(self, radius: float, rects) -> np.ndarray:
        """The OR over ``rects`` of :meth:`_mask_parts_rects`' neighbouring
        mask, in one pass over the fine lattice instead of one sweep of the
        leaf space per rect (a polygon query has one rect per base cell).

        The rule ``max(dmin - 1, 0) * fine_len <= r`` is monotone in the
        integer Chebyshev gap ``dmin``, so it holds exactly up to the gap
        :meth:`_nb_gap` finds by evaluating that expression itself; a leaf
        is in the mask iff its rect meets a query rect grown by that gap,
        which a coverage count over the grown rects' bounding box of the
        fine lattice answers per leaf (a point query's box is a few fine
        cells wide)."""
        num = self.num_leaves
        gap = self._nb_gap(radius)
        if gap < 0 or not rects:
            return np.zeros(num, bool)
        side = self.n * self.refine
        q = np.asarray(rects, np.int64)
        x0 = np.maximum(q[:, 0] - gap, 0)
        x1 = np.minimum(q[:, 1] + gap, side - 1) + 1
        y0 = np.maximum(q[:, 2] - gap, 0)
        y1 = np.minimum(q[:, 3] + gap, side - 1) + 1
        bx, by = int(x0.min()), int(y0.min())
        w, h = int(x1.max()) - bx, int(y1.max()) - by
        x0, x1, y0, y1 = x0 - bx, x1 - bx, y0 - by, y1 - by
        diff = np.zeros((w + 1, h + 1), np.int64)
        np.add.at(diff, (x0, y0), 1)
        np.add.at(diff, (x1, y0), -1)
        np.add.at(diff, (x0, y1), -1)
        np.add.at(diff, (x1, y1), 1)
        covered = diff.cumsum(0).cumsum(1)[:w, :h] > 0
        pre = np.zeros((w + 1, h + 1), np.int64)
        pre[1:, 1:] = covered.cumsum(0).cumsum(1)
        # each leaf's rect clipped to the box (empty outside it)
        lx0 = np.clip(self._leaf_fx0 - bx, 0, w)
        lx1 = np.clip(self._leaf_fx1 + 1 - bx, 0, w)
        ly0 = np.clip(self._leaf_fy0 - by, 0, h)
        ly1 = np.clip(self._leaf_fy1 + 1 - by, 0, h)
        return (pre[lx1, ly1] - pre[lx0, ly1] - pre[lx1, ly0]
                + pre[lx0, ly0]) > 0

    def _nb_gap(self, radius: float) -> int:
        """The largest Chebyshev gap d >= 0 with ``max(d - 1, 0) *
        fine_len <= radius`` (the neighbouring rule of
        :meth:`_mask_parts_rects`, evaluated as it evaluates it), or -1
        when no gap passes."""
        fl = self.fine_length

        def passes(d: int) -> bool:
            return max(d - 1, 0) * fl <= radius

        if not passes(0):
            return -1
        d = max(0, int(radius / fl))
        while passes(d + 1):
            d += 1
        while not passes(d):
            d -= 1
        return d

    def _mask_parts_rects(self, radius: float, rects
                          ) -> Tuple[np.ndarray, np.ndarray]:
        num = self.num_leaves
        gn = np.zeros(num, bool)
        nb = np.zeros(num, bool)
        if radius == 0:
            # reference parity: radius 0 selects ALL cells
            # (getNeighboringCells, UniformGrid.java:264-266) and
            # guarantees none (guaranteed layers would be -1)
            nb[:] = True
            return gn, nb
        if not rects:
            return gn, nb
        fl = self.fine_length
        diag = fl * math.sqrt(2.0)
        lx0, lx1 = self._leaf_fx0, self._leaf_fx1
        ly0, ly1 = self._leaf_fy0, self._leaf_fy1
        for qx0, qx1, qy0, qy1 in rects:
            # Chebyshev index distances between the leaf rects and the
            # query rect on the fine lattice
            dminx = np.maximum(np.maximum(qx0 - lx1, lx0 - qx1), 0)
            dminy = np.maximum(np.maximum(qy0 - ly1, ly0 - qy1), 0)
            dmin = np.maximum(dminx, dminy)
            dmaxx = np.maximum(qx1 - lx0, lx1 - qx0)
            dmaxy = np.maximum(qy1 - ly0, ly1 - qy0)
            dmax = np.maximum(dmaxx, dmaxy)
            # guaranteed: every point of the leaf within r of every point
            # of the query rect — (cheb_max + 1) * fine_diag <= r, the
            # reference's floor(r/diag)-1 layer rule restated per level
            gn |= (dmax + 1) * diag <= radius
            # neighboring (GN ∪ CN): the leaf's closest point may be within
            # r — (cheb_min - 1) * fine_len <= r, the reference's
            # ceil(r/len) candidate layers with an inclusive boundary (the
            # identity-preserving form; see the module docstring)
            nb |= np.maximum(dmin - 1, 0) * fl <= radius
        return gn, nb

    def guaranteed_leaf_mask(self, radius: float,
                             cells: Union[int, Iterable[int]],
                             point: Optional[Tuple[float, float]] = None
                             ) -> np.ndarray:
        """Dense (num_leaves,) guaranteed mask: every point of a flagged
        leaf is within ``radius`` of the query (cells = the query
        geometry's BASE cells; ``point`` tightens a point query to its
        exact fine cell)."""
        gn, _ = self._mask_parts(radius, cells, point)
        return gn

    def candidate_leaf_mask(self, radius: float,
                            cells: Union[int, Iterable[int]],
                            point: Optional[Tuple[float, float]] = None,
                            guaranteed_mask: Optional[np.ndarray] = None
                            ) -> np.ndarray:
        """CN = within candidate layers minus the guaranteed set — mutually
        exclusive with GN, like ``getCandidateNeighboringCells``
        (``UniformGrid.java:367-425``)."""
        gn, nb = self._mask_parts(radius, cells, point)
        if guaranteed_mask is not None:
            gn = guaranteed_mask
        return nb & ~gn

    def neighboring_leaf_mask(self, radius: float,
                              cells: Union[int, Iterable[int]],
                              point: Optional[Tuple[float, float]] = None
                              ) -> np.ndarray:
        """GN ∪ CN over the leaf space; ``radius == 0`` selects all leaves
        (reference parity). This is the pre-kernel prefilter mask: a sound
        over-approximation of every leaf that can contain a record within
        ``radius`` of the query, for ANY layout — which is why a
        repartition mid-run can never change a window's result set. It is
        the one-query case of :meth:`union_neighboring_leaf_mask`."""
        return self.union_neighboring_leaf_mask(radius, [(cells, point)])

    def __repr__(self) -> str:
        return (f"AdaptiveGrid(n={self.n}, refine={self.refine}, "
                f"splits={len(self._split)}, coarse={len(self._coarse)}, "
                f"leaves={self.num_leaves}, v{self.version})")
