"""Repartition controller (port of ``RepartitionPolicy`` and
``RepartitionController`` of ``spatialflink_tpu.runtime.repartition``):
epoch-based split/merge decisions for the skew-adaptive grid, driven by the
cells the decode assigns.

- The controller observes base-cell assignments through the grid's cell
  observer hook (``index.uniform_grid._CELL_OBSERVER``), chained onto any
  observer already there: one bincount per decoded chunk.
- Decisions are EPOCH-based (every ``interval_records`` observed records)
  with HYSTERESIS: a cell splits when its epoch share reaches
  ``split_share``; a split cell merges back only after its share stayed
  below ``merge_share`` for ``cooldown_epochs`` consecutive epochs; cold
  ``coarsen x coarsen`` blocks coarsen under the same cooldown.
- Every applied change bumps the grid's ``version`` (the operators' leaf
  mask caches key on it) and the ``repartitions`` / ``grid-splits`` /
  ``grid-merges`` counters of ``utils.metrics.REGISTRY``.
- Correctness does not depend on when an epoch fires: the leaf masks
  over-approximate for every layout, so a repartition never changes a
  window's result, only how many records the prefilter keeps.
- The layout is a coordinated-checkpoint participant (component ``grid``):
  ``--resume`` restores the layout and its version; epoch counts restart.

With a telemetry session the split score blends in the session's
attributed kernel cost per cell (:meth:`RepartitionController.
_cost_shares`), each applied change is a ``repartition`` event, and the
``grid.version`` / ``grid.leaves`` gauges follow the layout; without one
the score is the record share alone. The fleet's leaf placement
(``balance_leaves``, ``pick_rebalance``) comes with multi-GPU serving.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from spatialflink_tpu_torch.index import AdaptiveGrid
from spatialflink_tpu_torch.index import uniform_grid as _ug
from spatialflink_tpu_torch.utils import metrics

#: the one controller the current process runs (the driver installs it)
_ACTIVE: Optional["RepartitionController"] = None


def active_controller() -> Optional["RepartitionController"]:
    """The process's installed :class:`RepartitionController`, or None."""
    return _ACTIVE


@dataclass
class RepartitionPolicy:
    """Split/merge thresholds. Shares are fractions of the records observed
    in ONE epoch; hysteresis = the split and merge thresholds are far apart
    AND merges/coarsens wait out ``cooldown_epochs`` below threshold."""

    #: split a base cell when its epoch record share reaches this
    split_share: float = 0.05
    #: merge a split cell back once its share stays below this (must be
    #: well under split_share — the hysteresis band)
    merge_share: float = 0.0125
    #: consecutive cold epochs before a merge / un-coarsen applies
    cooldown_epochs: int = 2
    #: cap on concurrently split cells (each costs refine^2 leaves)
    max_splits: int = 64
    #: coarsen an aligned block when the whole block's epoch share is below
    #: this (default: a nearly-empty block — ~5 records per 50k-record
    #: epoch); 0 disables coarsening
    coarsen_share: float = 0.0001
    #: un-coarsen when the block's share reaches this (hysteresis twin)
    uncoarsen_share: float = 0.002
    #: ignore epochs with fewer observed records than this (no signal)
    min_epoch_records: int = 256
    #: blend weight of attributed cost share vs record share in the split
    #: score when per-cell cost is known (0 = counts only, 1 = cost only);
    #: the port attributes no cost, so the score is the record share
    cost_weight: float = 0.5

    def validate(self) -> "RepartitionPolicy":
        if not 0 < self.merge_share < self.split_share <= 1:
            raise ValueError(
                f"need 0 < merge_share ({self.merge_share}) < split_share "
                f"({self.split_share}) <= 1 (the hysteresis band)")
        if self.coarsen_share and not (0 <= self.coarsen_share
                                       < self.uncoarsen_share):
            raise ValueError(
                f"need coarsen_share ({self.coarsen_share}) < "
                f"uncoarsen_share ({self.uncoarsen_share})")
        return self


class RepartitionController:
    """Feeds base-cell observations into epoch split/merge decisions on an
    :class:`AdaptiveGrid`. The observe path runs on the pipeline thread;
    :meth:`status` reads under the lock the epoch mutates under."""

    def __init__(self, grid: AdaptiveGrid,
                 interval_records: int = 50_000,
                 policy: Optional[RepartitionPolicy] = None,
                 coarsen: bool = True):
        self.grid = grid
        self.interval_records = max(1, int(interval_records))
        self.policy = (policy or RepartitionPolicy()).validate()
        self.coarsen_enabled = bool(coarsen) and self.policy.coarsen_share > 0
        n2 = grid.n * grid.n
        self._counts = np.zeros(n2, np.int64)
        self._since = 0
        self.epochs = 0
        self.repartitions = 0
        #: consecutive epochs each split cell spent below merge_share
        self._cold_epochs: dict = {}
        #: consecutive epochs each block spent below coarsen_share
        self._block_cold: dict = {}
        #: recent decisions, newest last (at most 32)
        self.decisions: List[dict] = []
        self._lock = threading.Lock()
        self._restore_observer: Optional[Callable[[], None]] = None

    # ------------------------------------------------------------------ #
    # observation

    def install(self) -> "RepartitionController":
        """Chain onto the grid-cell observer hook (an observer already
        there keeps being called first) and become the process's active
        controller. :meth:`uninstall` restores both."""
        global _ACTIVE
        prev = _ug._CELL_OBSERVER
        note = self.note_cells

        def observe(cells) -> None:
            if prev is not None:
                prev(cells)
            note(cells)

        def observe_each(cells) -> None:
            _ug.hand_each(prev, cells)
            self.note_each(cells)

        observe.each = observe_each
        _ug._CELL_OBSERVER = observe

        def restore() -> None:
            global _ACTIVE
            _ug._CELL_OBSERVER = prev
            if _ACTIVE is self:
                _ACTIVE = None

        with self._lock:
            self._restore_observer = restore
        _ACTIVE = self
        return self

    def uninstall(self) -> None:
        with self._lock:
            restore_fn = self._restore_observer
            self._restore_observer = None
        if restore_fn is not None:
            restore_fn()

    def note_cells(self, cells) -> None:
        """One decoded chunk's base-cell ids (any shape; -1 = outside the
        grid). Accumulates the epoch bincount and fires :meth:`epoch` when
        the interval fills — on the pipeline thread, between chunks, so a
        layout change can never interleave with a window evaluation."""
        c = np.asarray(cells).ravel()
        c = c[(c >= 0) & (c < self._counts.size)]
        if c.size == 0:
            return
        with self._lock:
            self._counts += np.bincount(c, minlength=self._counts.size)
            self._since += int(c.size)
            due = self._since >= self.interval_records
        if due:
            self.epoch()

    def note_each(self, cells) -> None:
        """:meth:`note_cells` for each of ``cells`` alone, in one call per
        epoch instead of one per cell: the array is cut where the interval
        fills, so every epoch closes at the same cell as one by one."""
        c = np.asarray(cells).ravel()
        c = c[(c >= 0) & (c < self._counts.size)]
        i = 0
        while i < c.size:
            with self._lock:
                take = max(1, self.interval_records - self._since)
            self.note_cells(c[i:i + take])
            i += take

    def request_epoch(self) -> None:
        """Arm the next observation to close the epoch early. Only the
        interval clock is touched: the epoch itself still fires from
        :meth:`note_cells` on the pipeline thread, between chunks, the one
        place a layout change cannot interleave with a window
        evaluation."""
        with self._lock:
            self._since = max(self._since, self.interval_records)

    # ------------------------------------------------------------------ #
    # decisions

    def _cost_shares(self) -> Optional[np.ndarray]:
        """Per-base-cell attributed-cost shares from the active telemetry
        session's cost profiles (``utils.telemetry.CostProfiles``), or None
        without a session or before any cost was attributed (the split
        score is then the record share alone). Cumulative, so cost ratchets
        toward persistently hot cells. The attribution is measured wall
        clock, so under a session the layouts depend on timing, in either
        package."""
        from spatialflink_tpu_torch.utils import telemetry as _telemetry

        tel = _telemetry.active()
        if tel is None:
            return None
        cost = tel.costs.cell_costs(self._counts.size)
        total = float(cost.sum())
        if total <= 0:
            return None
        return cost / total

    def epoch(self) -> bool:
        """Close one epoch: evaluate split/merge/coarsen with hysteresis and
        apply the new layout. Returns True when the layout changed."""
        p = self.policy
        with self._lock:
            counts = self._counts
            total = int(counts.sum())
            self._counts = np.zeros_like(counts)
            self._since = 0
            self.epochs += 1
            epoch_no = self.epochs
        # the no-signal floor clamps to the epoch interval: a deliberately
        # small --repartition-interval must still make decisions
        if total < min(p.min_epoch_records, self.interval_records):
            return False
        shares = counts / total
        cost = self._cost_shares()
        if cost is not None and p.cost_weight > 0:
            score = (1 - p.cost_weight) * shares + p.cost_weight * cost
        else:
            score = shares

        splits = set(self.grid.split_cells())
        # merges first (cooldown): a split cell cold for cooldown epochs
        # merges back to base granularity
        merged = []
        for cell in sorted(splits):
            if shares[cell] < p.merge_share:
                self._cold_epochs[cell] = self._cold_epochs.get(cell, 0) + 1
                if self._cold_epochs[cell] >= p.cooldown_epochs:
                    splits.discard(cell)
                    merged.append(int(cell))
                    self._cold_epochs.pop(cell, None)
            else:
                self._cold_epochs.pop(cell, None)
        # splits: hottest first, capped
        new_splits = []
        for cell in np.argsort(score)[::-1]:
            if len(splits) >= p.max_splits:
                break
            if score[cell] < p.split_share:
                break
            if int(cell) not in splits:
                splits.add(int(cell))
                new_splits.append(int(cell))
                self._cold_epochs.pop(int(cell), None)

        # coarsen/un-coarsen cold neighborhoods (block lattice sums)
        blocks = set(self.grid.coarse_blocks())
        coarsened, uncoarsened = [], []
        if self.coarsen_enabled:
            n, c = self.grid.n, self.grid.coarsen
            nb = -(-n // c)
            grid2d = shares.reshape(n, n)
            pad = nb * c
            padded = np.zeros((pad, pad))
            padded[:n, :n] = grid2d
            block_share = padded.reshape(nb, c, nb, c).sum(axis=(1, 3))
            for bx in range(nb):
                for by in range(nb):
                    key = (bx, by)
                    members = self.grid._block_members(bx, by)
                    if any(m in splits for m in members):
                        blocks.discard(key)
                        self._block_cold.pop(key, None)
                        continue
                    s = float(block_share[bx, by])
                    if key in blocks:
                        if s >= p.uncoarsen_share:
                            blocks.discard(key)
                            uncoarsened.append(list(key))
                            self._block_cold.pop(key, None)
                    elif s < p.coarsen_share:
                        self._block_cold[key] = \
                            self._block_cold.get(key, 0) + 1
                        if self._block_cold[key] >= p.cooldown_epochs:
                            blocks.add(key)
                            coarsened.append(list(key))
                            self._block_cold.pop(key, None)
                    else:
                        self._block_cold.pop(key, None)

        changed = self.grid.apply_layout(splits, blocks)
        if changed:
            self._note_change(epoch_no, total, new_splits, merged,
                              coarsened, uncoarsened)
        return changed

    def _note_change(self, epoch_no: int, total: int, new_splits, merged,
                     coarsened, uncoarsened) -> None:
        with self._lock:
            self.repartitions += 1
        reg = metrics.REGISTRY
        reg.counter("repartitions").inc()
        reg.counter("grid-splits").inc(len(new_splits))
        reg.counter("grid-merges").inc(len(merged))
        decision = {
            "ts_ms": int(time.time() * 1000),
            "epoch": epoch_no,
            "epoch_records": total,
            "version": self.grid.version,
            "split": new_splits,
            "merged": merged,
            "coarsened": coarsened,
            "uncoarsened": uncoarsened,
            "num_leaves": self.grid.num_leaves,
        }
        with self._lock:
            self.decisions.append(decision)
            del self.decisions[:-32]
        from spatialflink_tpu_torch.utils import telemetry as _telemetry

        _telemetry.emit_event(
            "repartition", version=self.grid.version, epoch=epoch_no,
            split=new_splits, merged=merged, coarsened=len(coarsened),
            uncoarsened=len(uncoarsened), num_leaves=self.grid.num_leaves)
        tel = _telemetry.active()
        if tel is not None:
            tel.gauge("grid.version").set(float(self.grid.version))
            tel.gauge("grid.leaves").set(float(self.grid.num_leaves))

    # ------------------------------------------------------------------ #
    # serving / checkpointing

    def status(self) -> dict:
        """The controller's state as JSON: the live layout, the policy
        thresholds, epoch progress and the recent decisions (the payload
        of the JAX package's ``/partition`` endpoint, which the port does
        not serve yet)."""
        with self._lock:
            since = self._since
            decisions = list(self.decisions)
            counts = self._counts
            total = int(counts.sum())
            top = []
            if total:
                nz = np.nonzero(counts)[0]
                order = nz[np.argsort(counts[nz])[::-1][:8]]
                top = [[int(c), round(float(counts[c]) / total, 4)]
                       for c in order]
        return {
            "grid": self.grid.layout(),
            "policy": {
                "split_share": self.policy.split_share,
                "merge_share": self.policy.merge_share,
                "cooldown_epochs": self.policy.cooldown_epochs,
                "max_splits": self.policy.max_splits,
                "coarsen_share": (self.policy.coarsen_share
                                  if self.coarsen_enabled else 0.0),
                "uncoarsen_share": self.policy.uncoarsen_share,
                "cost_weight": self.policy.cost_weight,
            },
            "interval_records": self.interval_records,
            "epoch": {"number": self.epochs, "records": since,
                      "top_shares": top},
            "repartitions": self.repartitions,
            "decisions": decisions,
        }

    def register_checkpoint(self, coordinator) -> None:
        """Carry the grid layout in the coordinated-checkpoint manifest
        (component ``grid``) so ``--resume`` restores the adapted
        partitioning. Registration auto-restores pending loaded state."""

        def snapshot():
            return {}, self.grid.layout()

        def restore(_arrays, meta) -> None:
            self.grid.apply_layout(
                meta.get("split_cells", ()),
                [tuple(b) for b in meta.get("coarse_blocks", ())])
            # the version is monotonic ACROSS the resume: never rewind
            # below the saved stamp (operators' mask caches key on it)
            self.grid.version = max(self.grid.version,
                                    int(meta.get("version", 0)))

        coordinator.register("grid", snapshot, restore)
