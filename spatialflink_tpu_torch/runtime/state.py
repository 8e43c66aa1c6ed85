"""Checkpoint files and carried trajectory state (port of
``spatialflink_tpu.runtime.state``).

:class:`CheckpointableState` is a named bag of numpy arrays and JSON
metadata saved as one ``.npz``, in the JAX package's format: the arrays,
and a ``__meta__`` entry holding ``{"schema", "checksum", "meta"}``, the
checksum a sha256 over the meta JSON and every array's key, dtype, shape
and bytes. A file saved by one package loads in the other. The write is
atomic (a temporary file, fsync, rename, fsync of the directory), and
:meth:`CheckpointableState.load` raises :class:`CheckpointCorrupt` for a
truncated, corrupt or newer-schema file.

:class:`TrajStateStore` is a :class:`TrajStatsState` on the operator's
device that grows with the interner, rebases its int32 timestamp offsets
when a realtime run moves its ``ts_base`` forward, and snapshots to a
:class:`CheckpointableState` (copies on the host) and restores from one
(fresh contiguous tensors on the device).
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from spatialflink_tpu_torch.ops.trajectory import INT32_MIN, TrajStatsState
from spatialflink_tpu_torch.utils import bucket_size

#: bumped when the on-disk layout changes incompatibly; a reader seeing a
#: newer version refuses
STATE_SCHEMA_VERSION = 1


class CheckpointCorrupt(RuntimeError):
    """A checkpoint file is unreadable: truncated, checksum-mismatched, or
    written by a newer schema."""


def _content_checksum(host: Dict[str, np.ndarray], meta: Dict) -> str:
    """sha256 over the meta JSON and every array's key, dtype, shape and
    bytes, in sorted key order."""
    h = hashlib.sha256()
    h.update(json.dumps(meta, sort_keys=True, default=str).encode())
    for k in sorted(host):
        a = np.ascontiguousarray(host[k])
        h.update(k.encode())
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _parse_meta_envelope(raw: str, path: str, host=None, verify=True):
    """The user meta of a ``__meta__`` entry: an envelope ``{"schema",
    "checksum", "meta"}``, verified when ``host`` is given; a bare meta
    dict (a file from before the envelope) loads unverified."""
    try:
        env = json.loads(raw)
    except (ValueError, TypeError) as e:
        raise CheckpointCorrupt(f"{path}: __meta__ is not JSON ({e})") from e
    if not (isinstance(env, dict) and "schema" in env and "meta" in env):
        return env if isinstance(env, dict) else {}
    schema = env.get("schema")
    if not isinstance(schema, int) or schema > STATE_SCHEMA_VERSION:
        raise CheckpointCorrupt(
            f"{path}: checkpoint schema version {schema!r} is newer than "
            f"this build understands ({STATE_SCHEMA_VERSION})")
    if verify and host is not None:
        want = env.get("checksum")
        got = _content_checksum(host, env["meta"])
        if want != got:
            raise CheckpointCorrupt(
                f"{path}: content checksum mismatch (file says "
                f"{str(want)[:12]}…, payload hashes to {got[:12]}…) — "
                "truncated or corrupt checkpoint")
    return env["meta"]


class CheckpointableState:
    """A named bag of arrays (numpy, or tensors: saved as host copies) and
    JSON-able metadata."""

    def __init__(self):
        self.arrays: Dict[str, Any] = {}
        self.meta: Dict[str, Any] = {}

    def save(self, path: str) -> None:
        """Atomic write: a crash mid-save leaves the previous file whole
        (a ``.tmp`` beside it is never read)."""
        host = {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)) for k, v in self.arrays.items()}
        envelope = {"schema": STATE_SCHEMA_VERSION,
                    "checksum": _content_checksum(host, self.meta),
                    "meta": self.meta}
        tmp = f"{path}.tmp"
        with open(tmp, "wb") as f:
            np.savez(f, __meta__=json.dumps(envelope), **host)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        dir_fd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
        try:
            os.fsync(dir_fd)
        finally:
            os.close(dir_fd)

    @classmethod
    def load(cls, path: str, verify: bool = True) -> "CheckpointableState":
        """Load and verify; any unreadable file, checksum or schema
        mismatch raises :class:`CheckpointCorrupt`."""
        out = cls()
        raw_meta: Optional[str] = None
        try:
            with np.load(path, allow_pickle=False) as z:
                for k in z.files:
                    if k == "__meta__":
                        raw_meta = str(z[k])
                    else:
                        out.arrays[k] = z[k]
        except Exception as e:  # BadZipFile, OSError, ValueError, ...
            raise CheckpointCorrupt(
                f"{path}: unreadable checkpoint ({type(e).__name__}: {e})"
            ) from e
        if raw_meta is not None:
            out.meta = _parse_meta_envelope(raw_meta, path, out.arrays,
                                            verify=verify)
        return out


def checkpoint_meta(path: str) -> Dict[str, Any]:
    """The (unverified) user meta of a checkpoint file; {} if there is
    none. Reads only the ``__meta__`` entry."""
    if not os.path.exists(path):
        return {}
    try:
        with np.load(path, allow_pickle=False) as z:
            if "__meta__" not in z.files:
                return {}
            raw = str(z["__meta__"])
    except Exception as e:
        raise CheckpointCorrupt(
            f"{path}: unreadable checkpoint ({type(e).__name__}: {e})") from e
    meta = _parse_meta_envelope(raw, path, host=None, verify=False)
    return meta if isinstance(meta, dict) else {}


def checkpoint_consumed(path: str) -> int:
    """The source records a checkpoint's state reflects (its ``consumed``
    meta; 0 when absent): the records a resumed file replay skips."""
    return int(checkpoint_meta(path).get("consumed", 0))


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

    def snapshot(self) -> CheckpointableState:
        """The state as host copies (K8a updates the tensors in place, and
        ``.numpy()`` of a CPU tensor would alias them)."""
        cp = CheckpointableState()
        cp.meta["capacity"] = self.capacity
        for name, t in self.state._asdict().items():
            cp.arrays[name] = t.detach().cpu().numpy().copy()
        return cp

    @classmethod
    def restore(cls, cp: CheckpointableState, device="cpu"
                ) -> "TrajStateStore":
        """A store holding a snapshot's state in fresh contiguous tensors
        on ``device`` (never views of the loaded buffers: K8a writes
        them)."""
        store = cls.from_numpy(cp.arrays, device)
        store.capacity = int(cp.meta.get("capacity", store.capacity))
        return store
