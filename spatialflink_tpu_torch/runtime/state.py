"""Carried trajectory state (port of ``TrajStateStore`` of
``spatialflink_tpu.runtime.state``): a :class:`TrajStatsState` on the
operator's device that grows with the interner, and rebases its int32
timestamp offsets when a realtime run moves its ``ts_base`` forward.
Snapshots to disk (``CheckpointableState``) are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from spatialflink_tpu_torch.ops.trajectory import INT32_MIN, TrajStatsState
from spatialflink_tpu_torch.utils import bucket_size

#: the floor of a rebased last_ts: with the operators' 2**30 batch-span cap,
#: |ts - last_ts| stays below 2**31, so K8a's int32 delta is exact
REBASE_FLOOR = -(2 ** 30) + 1
_IMAX = 2 ** 31 - 1


class TrajStateStore:
    """A :class:`TrajStatsState` of ``capacity`` slots on ``device``."""

    def __init__(self, capacity: int = 256, device="cpu"):
        self.device = torch.device(device)
        self.capacity = capacity
        self.state = TrajStatsState.zeros(capacity, self.device)

    @classmethod
    def from_numpy(cls, arrays, device="cpu") -> "TrajStateStore":
        """A store holding the state given as host arrays: a mapping (or the
        JAX package's ``TrajStatsState`` NamedTuple) of last_x, last_y,
        last_ts, spatial and temporal, each (M,)."""
        fields = arrays._asdict() if hasattr(arrays, "_asdict") else arrays
        dtypes = {"last_x": torch.float32, "last_y": torch.float32,
                  "last_ts": torch.int32, "spatial": torch.float32,
                  "temporal": torch.float32}
        tensors = {k: torch.tensor(np.array(fields[k]), dtype=dt,
                                   device=torch.device(device))
                   for k, dt in dtypes.items()}
        store = cls.__new__(cls)
        store.device = torch.device(device)
        store.capacity = int(tensors["last_x"].shape[0])
        store.state = TrajStatsState(**tensors)
        return store

    def ensure(self, min_capacity: int) -> None:
        """Grow (power of two, at least doubling) so new interned object
        ids fit."""
        if min_capacity <= self.capacity:
            return
        new_cap = bucket_size(min_capacity, self.capacity * 2)
        grown = TrajStatsState.zeros(new_cap, self.device)
        for g, o in zip(grown, self.state):
            g[: self.capacity] = o
        self.state = grown
        self.capacity = new_cap

    def rebase_ts(self, delta_ms: int) -> None:
        """Shift the carried ``last_ts`` offsets when the caller moves the
        batch ``ts_base`` forward by ``delta_ms``, saturating: entries
        dormant beyond ~12.4 days clamp to :data:`REBASE_FLOOR` (any new
        timestamp still compares newer); the uninitialised sentinel
        stays."""
        if delta_ms == 0:
            return
        lt = self.state.last_ts
        floor = torch.full_like(lt, REBASE_FLOOR)
        if delta_ms >= 2 ** 31:
            shifted = floor
        elif delta_ms <= -(2 ** 31):
            shifted = torch.full_like(lt, _IMAX)
        elif delta_ms > 0:
            shifted = torch.where(lt < REBASE_FLOOR + delta_ms, floor,
                                  lt - delta_ms)
        else:
            shifted = torch.where(lt > _IMAX + delta_ms,
                                  torch.full_like(lt, _IMAX), lt - delta_ms)
        self.state = self.state._replace(
            last_ts=torch.where(lt != INT32_MIN, shifted, lt))
