"""Coordinated pipeline checkpoints with exactly-once recovery (port of
``spatialflink_tpu.runtime.checkpoint``).

One :class:`CheckpointCoordinator` snapshots the whole pipeline — source
positions, watermarks, open window / pane / micro-batch buffers, pane
partials, interners and trajectory state — into one atomic, checksummed
manifest ``ckpt-<seq>.npz`` under a checkpoint directory, keeps the newest
``retain`` of them, and on load falls back past a truncated or corrupt
newest manifest to the one before. The manifest is the JAX package's: the
same file format (``runtime.state.CheckpointableState``), schema, component
names and codecs, so a checkpoint written by one package resumes in the
other.

Consistency (the barrier). A participant is snapshotted only where every
result yielded so far has been consumed downstream (sinks produced, markers
written, offsets committed: code after a ``yield`` runs only once the
consumer pulled the next item) and no sealed window is in flight (the
pipelined loops drain their deferred windows before committing). There,
every record the source taps reported is buffered in a snapshotted
structure, reflected in an emitted result, or dropped as late, so
restoring and seeking the sources to the noted positions reproduces the
uninterrupted run. Windows emitted between the last checkpoint and a crash
are emitted again on resume with the same contents and suppressed by the
marker-seeded ``streams.kafka.KafkaWindowSink`` (or, on the file path, by
the :class:`EmittedWindowJournal`): exactly-once output.

Telemetry, as in the JAX module: the registry's ``checkpoints-written``,
``checkpoint-fallbacks`` and ``checkpoint-restores`` counters, and with a
session the ``checkpoint-write-ms`` and ``checkpoint-size-bytes``
histograms, the ``checkpoint.age-s`` and ``checkpoint.seq`` gauges, and
the ``checkpoint-committed``, ``checkpoint-fallback`` and
``checkpoint-restored`` events. The JAX module's injected-stall check for
``--chaos`` is not ported yet.
"""

from __future__ import annotations

import base64
import json
import os
import re
import sys
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from spatialflink_tpu_torch.runtime.state import (CheckpointableState,
                                                  CheckpointCorrupt)
from spatialflink_tpu_torch.utils import metrics
from spatialflink_tpu_torch.utils import telemetry as _telemetry

#: manifest layout version (independent of the file envelope's)
MANIFEST_SCHEMA_VERSION = 1

_CKPT_RE = re.compile(r"^ckpt-(\d{8})\.npz$")


class CheckpointMismatch(RuntimeError):
    """A checkpoint was written by a different job (query / window /
    group fingerprint) or execution layout; restoring it would give wrong
    state, so the resume refuses."""


def check_job_fingerprint(saved: Optional[str], current: Optional[str],
                          path: str) -> None:
    """The job-fingerprint guard every resume path shares: raises
    :class:`CheckpointMismatch` when both are known and differ."""
    if current and saved and saved != current:
        raise CheckpointMismatch(
            f"{path} was written by job fingerprint {saved!r} but this run "
            f"is {current!r} (different query/window config or consumer "
            "group); restoring it would produce wrong state. Use a fresh "
            "checkpoint location, or rerun with the original "
            "configuration.")


def atomic_write_json(path: str, doc: dict) -> None:
    """Durable small-JSON write (fsync + rename): a reader never sees a
    torn document."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


# --------------------------------------------------------------------- #
# codecs


def record_codec(grid):
    """(encode, decode) of stream records: GeoJSON with raw epoch-ms
    timestamps (a lossless round trip; the ingestion time is not
    carried)."""
    from spatialflink_tpu_torch.streams.formats import (parse_spatial,
                                                        serialize_spatial)

    def encode(obj) -> str:
        return serialize_spatial(obj, "GeoJSON")

    def decode(s: str):
        return parse_spatial(s, "GeoJSON", grid)

    def points(recs):
        """Encoded point records -> one columnar chunk in one native parse
        (cells on ``grid``, as the record decode assigns them, and handed
        to the cell observer one by one, as the record decode does); None
        when a record is not a point."""
        from spatialflink_tpu_torch.index.uniform_grid import observe_each
        from spatialflink_tpu_torch.streams import bulk
        from spatialflink_tpu_torch.utils import IdInterner

        try:
            parsed = bulk.bulk_parse_geojson("\n".join(recs).encode(),
                                             interner=IdInterner())
        except ValueError:
            return None
        if len(parsed) != len(recs):
            return None
        cells = grid.cell_ids(parsed.x, parsed.y)[0]
        observe_each(cells)
        return bulk.PointChunk(parsed=parsed, cells=cells,
                               ingest_ms=int(time.time() * 1000))

    #: the columnar paths of the window snapshots (the same text, and the
    #: same records, as encode / decode one by one)
    encode.fmt = "GeoJSON"
    decode.points = points
    return encode, decode


def value_codec(grid):
    """(encode, decode) of pane partials: a tagged JSON projection of every
    partial shape the families cache — record lists, (objID, distance)
    tuples, id sets, numpy summaries, dicts of them. Anything else raises
    ``TypeError``, and the snapshot skips that entry (it recomputes on
    resume)."""
    enc_rec, dec_rec = record_codec(grid)

    def enc(v):
        if v is None or isinstance(v, (bool, int, str, float)):
            return v
        if isinstance(v, np.generic):
            return v.item()
        if isinstance(v, np.ndarray):
            return {"__nd__": [str(v.dtype), list(v.shape),
                               base64.b64encode(
                                   np.ascontiguousarray(v).tobytes()
                               ).decode("ascii")]}
        if isinstance(v, tuple):
            return {"__t__": [enc(x) for x in v]}
        if isinstance(v, list):
            return {"__l__": [enc(x) for x in v]}
        if isinstance(v, (set, frozenset)):
            return {"__s__": sorted(enc(x) for x in v)}
        if isinstance(v, dict):
            if not all(isinstance(k, str) for k in v):
                raise TypeError("only str-keyed dicts are encodable")
            return {"__d__": {k: enc(x) for k, x in v.items()}}
        if hasattr(v, "obj_id") and hasattr(v, "timestamp"):
            return {"__geo__": enc_rec(v)}
        raise TypeError(f"unencodable partial value {type(v).__name__}")

    def dec(v):
        if not isinstance(v, dict):
            return v
        if "__nd__" in v:
            dtype, shape, data = v["__nd__"]
            return np.frombuffer(base64.b64decode(data),
                                 dtype=np.dtype(dtype)).reshape(shape).copy()
        if "__t__" in v:
            return tuple(dec(x) for x in v["__t__"])
        if "__l__" in v:
            return [dec(x) for x in v["__l__"]]
        if "__s__" in v:
            return {dec(x) for x in v["__s__"]}
        if "__d__" in v:
            return {k: dec(x) for k, x in v["__d__"].items()}
        if "__geo__" in v:
            return dec_rec(v["__geo__"])
        return v

    return enc, dec


# --------------------------------------------------------------------- #
# source taps


class CheckpointTap:
    """Pass-through source wrapper that notes the live source position with
    the coordinator as records are handed downstream: ``position_fn()``
    (a Kafka source's next offset), or a count from ``base`` (a file
    replay). A position is noted before its record is yielded: at a
    barrier the tap is suspended at its ``yield`` and that record has been
    processed."""

    def __init__(self, source, coordinator: "CheckpointCoordinator",
                 key: str, base: int = 0,
                 position_fn: Optional[Callable[[], int]] = None):
        self.source = source
        self.coordinator = coordinator
        self.key = key
        self.base = int(base)
        self.position_fn = position_fn

    def __iter__(self) -> Iterator:
        note = self.coordinator.note_position
        n = self.base
        for rec in self.source:
            if self.position_fn is not None:
                note(self.key, self.position_fn())
            else:
                n += 1
                note(self.key, n)
            yield rec


class EmittedWindowJournal:
    """Append-only log of emitted window keys (``start:end:cell``) in the
    checkpoint directory, for the sinks with no recovery state of their
    own (stdout, ``--output``): a resumed run suppresses the windows the
    crashed run already emitted, as the output topic's commit markers do
    for the Kafka sink. Lines are flushed per window, so a killed process
    loses none; a machine crash can drop the unsynced tail, and those
    windows then emit again with the same contents."""

    FILENAME = "emitted.log"

    def __init__(self, directory: str, fresh: bool = False):
        self.path = os.path.join(directory, self.FILENAME)
        if fresh and os.path.exists(self.path):
            os.unlink(self.path)  # a run that does not resume starts anew
        self._seen = set()
        if os.path.exists(self.path):
            with open(self.path, "rb") as f:
                for raw in f:
                    ln = raw.decode("utf-8", "replace").rstrip("\n")
                    if not ln.strip():
                        continue
                    head, sep, rest = ln.partition("\t")
                    key = ln
                    if sep:  # a fenced line of the JAX package's fleet
                        try:
                            int(head)
                            key = rest
                        except ValueError:
                            pass
                    self._seen.add(key)
        self._f = open(self.path, "a")
        self.suppressed = 0

    @staticmethod
    def key(result) -> str:
        cell = (getattr(result, "extras", {}).get("cell")
                if hasattr(result, "extras") else None)
        return (f"{getattr(result, 'window_start', None)}:"
                f"{getattr(result, 'window_end', None)}:{cell}")

    def seen(self, result) -> bool:
        if self.key(result) in self._seen:
            self.suppressed += 1
            return True
        return False

    def record(self, result) -> None:
        k = self.key(result)
        if k not in self._seen:
            self._seen.add(k)
            self._f.write(k + "\n")
            self._f.flush()

    def close(self) -> None:
        self._f.close()


# --------------------------------------------------------------------- #
# coordinator


def _provenance(device) -> dict:
    """The manifest's ``device`` entry: which device wrote the state (the
    device plane's provenance, as the JAX manifest carries it)."""
    from spatialflink_tpu_torch.utils import deviceplane

    return deviceplane.backend_provenance(device=device)


class CheckpointCoordinator:
    """Periodic whole-pipeline snapshots, one atomic manifest each: a
    counter (and clock) check per processing unit, the write itself at a
    drained barrier every ``every_batches`` units or ``every_seconds``
    wall seconds, whichever comes first.

    Participants register ``(snapshot_fn, restore_fn)`` under a stable
    name: ``snapshot_fn() -> (arrays, meta)`` gives numpy arrays and
    JSON-able metadata, ``restore_fn(arrays, meta)`` applies a loaded
    component. A registration restores at once when a loaded manifest
    holds that name, so participants built lazily pick their state up the
    moment they exist. ``device`` (the run's) is written into each
    manifest. ``commit_ms`` and ``manifest_bytes`` keep each commit's
    write time and size."""

    def __init__(self, directory: str, *, every_batches: int = 16,
                 every_seconds: Optional[float] = None, retain: int = 3,
                 job: Optional[str] = None, layout: Optional[str] = None,
                 device="cpu"):
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self.every_batches = max(1, int(every_batches))
        self.every_seconds = every_seconds
        self.retain = max(1, int(retain))
        self.job = job
        #: execution layout (family:mode:panes:multi:dyn:source): the job
        #: fingerprint leaves out execution knobs such as --panes, but the
        #: manifest's components and positions depend on them, so a
        #: different layout refuses at load
        self.layout = layout
        self.device = device
        self.restored = False
        self.written = 0
        self._age_gauge_installed = False
        self.commit_ms: List[float] = []
        self.manifest_bytes: List[int] = []
        self._lock = threading.RLock()
        self._snapshots: Dict[str, Callable[[], Tuple[dict, Any]]] = {}
        self._pending: Dict[str, Tuple[dict, Any]] = {}
        self._positions: Dict[str, int] = {}
        self._batches = 0
        self._last_batches = 0
        self._last_time = time.monotonic()
        # a fresh run into a non-empty directory numbers past the stale
        # manifests, so retention prunes them and not the new ones
        existing = self._manifests()
        self.seq = existing[-1][0] if existing else 0

    # ------------------------------ participants ---------------------- #

    def register(self, name: str,
                 snapshot_fn: Callable[[], Tuple[dict, Any]],
                 restore_fn: Optional[Callable[[dict, Any], None]] = None
                 ) -> bool:
        """Register a participant; True when loaded state was applied
        through ``restore_fn``."""
        self._snapshots[name] = snapshot_fn
        if restore_fn is not None and name in self._pending:
            arrays, meta = self._pending.pop(name)
            restore_fn(arrays, meta)
            return True
        return False

    def note_position(self, key: str, next_pos: int) -> None:
        self._positions[key] = int(next_pos)

    def position(self, key: str, default: int = 0) -> int:
        return int(self._positions.get(key, default))

    def positions(self) -> Dict[str, int]:
        return dict(self._positions)

    # ------------------------------ cadence --------------------------- #

    def note_batch(self) -> None:
        with self._lock:
            self._batches += 1

    def due(self) -> bool:
        if self._batches - self._last_batches >= self.every_batches:
            return True
        return (self.every_seconds is not None
                and time.monotonic() - self._last_time >= self.every_seconds)

    def barrier(self) -> bool:
        """One processing unit done at a consistent point: count it and
        checkpoint if due (one compare when not)."""
        self.note_batch()
        if self.due():
            self.commit()
            return True
        return False

    # ------------------------------ write ----------------------------- #

    def _path(self, seq: int) -> str:
        return os.path.join(self.dir, f"ckpt-{seq:08d}.npz")

    def commit(self) -> str:
        """Snapshot every participant and the source positions into one
        manifest, then prune; only at a barrier."""
        t0 = time.perf_counter()
        cp = CheckpointableState()
        components: Dict[str, Any] = {}
        for name, fn in self._snapshots.items():
            arrays, meta = fn()
            for k, a in (arrays or {}).items():
                cp.arrays[f"{name}/{k}"] = np.asarray(a)
            components[name] = meta
        with self._lock:
            self.seq += 1
        cp.meta = {
            "manifest_schema": MANIFEST_SCHEMA_VERSION,
            "job": self.job,
            "layout": self.layout,
            "seq": self.seq,
            "wall_ms": int(time.time() * 1000),
            "positions": dict(self._positions),
            "components": components,
            "device": _provenance(self.device),
        }
        path = self._path(self.seq)
        cp.save(path)
        self._prune()
        write_ms = (time.perf_counter() - t0) * 1e3
        size = os.path.getsize(path)
        with self._lock:
            self.written += 1
            self._last_batches = self._batches
            self._last_time = time.monotonic()
            self.commit_ms.append(write_ms)
            self.manifest_bytes.append(size)
        metrics.REGISTRY.counter("checkpoints-written").inc()
        tel = _telemetry.active()
        if tel is not None:
            tel.histogram("checkpoint-write-ms").record(write_ms)
            tel.histogram("checkpoint-size-bytes").record(size)
            tel.event("checkpoint-committed", seq=self.seq,
                      write_ms=round(write_ms, 3), size_bytes=size)
            if not self._age_gauge_installed:
                # pull gauges: a snapshot reads the current age
                tel.gauge("checkpoint.age-s",
                          lambda: time.monotonic() - self._last_time)
                tel.gauge("checkpoint.seq", lambda: float(self.seq))
                with self._lock:
                    self._age_gauge_installed = True
        return path

    def _manifests(self) -> List[Tuple[int, str]]:
        out = []
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for n in names:
            m = _CKPT_RE.match(n)
            if m:
                out.append((int(m.group(1)), os.path.join(self.dir, n)))
        out.sort()
        return out

    def _prune(self) -> None:
        for _seq, path in self._manifests()[:-self.retain]:
            try:
                os.unlink(path)
            except OSError:
                pass
        # a crash mid-save leaves a ckpt-*.npz.tmp; this is the only
        # writer, so a tmp outside a save in progress is dead
        for n in os.listdir(self.dir):
            if n.endswith(".npz.tmp") and not os.path.exists(
                    os.path.join(self.dir, n[:-4])):
                try:
                    os.unlink(os.path.join(self.dir, n))
                except OSError:
                    pass

    # ------------------------------ load ------------------------------ #

    def load(self) -> bool:
        """Restore from the newest valid retained manifest, falling back
        past corrupt or truncated ones with a warning. False when none is
        valid; :class:`CheckpointMismatch` when the newest valid one was
        written by another job fingerprint or execution layout."""
        for seq, path in reversed(self._manifests()):
            try:
                cp = CheckpointableState.load(path)
                meta = cp.meta
                schema = meta.get("manifest_schema")
                if schema != MANIFEST_SCHEMA_VERSION:
                    raise CheckpointCorrupt(
                        f"{path}: manifest schema {schema!r} != "
                        f"{MANIFEST_SCHEMA_VERSION}")
            except CheckpointCorrupt as e:
                metrics.REGISTRY.counter("checkpoint-fallbacks").inc()
                _telemetry.emit_event("checkpoint-fallback", path=path,
                                      error=str(e))
                print(f"warning: {e}; falling back to the previous "
                      "retained checkpoint", file=sys.stderr)
                continue
            check_job_fingerprint(meta.get("job"), self.job, path)
            layout = meta.get("layout")
            if self.layout and layout and layout != self.layout:
                raise CheckpointMismatch(
                    f"{path} was written under execution layout {layout!r} "
                    f"but this run is {self.layout!r} (e.g. --panes, the "
                    "query mode, or the input source/topics changed); its "
                    "components and source positions would not restore "
                    "into this pipeline and records would be lost. Resume "
                    "with the original flags and sources, or use a fresh "
                    "--checkpoint-dir.")
            grouped: Dict[str, dict] = {}
            for k, arr in cp.arrays.items():
                name, _, sub = k.partition("/")
                grouped.setdefault(name, {})[sub] = arr
            with self._lock:
                self._pending = {
                    name: (grouped.get(name, {}), comp_meta)
                    for name, comp_meta in
                    meta.get("components", {}).items()}
                self._positions = {k: int(v) for k, v in
                                   meta.get("positions", {}).items()}
                self.seq = int(meta.get("seq", seq))
            written_on = (meta.get("device") or {}).get("platform")
            here = _provenance(self.device)["platform"]
            if written_on and written_on != here:
                print(f"# note: resuming a checkpoint written on "
                      f"'{written_on}' onto '{here}' (host-layout state "
                      "restores anywhere; device-resident pane values were "
                      "read back at snapshot time)", file=sys.stderr)
            with self._lock:
                self.restored = True
            metrics.REGISTRY.counter("checkpoint-restores").inc()
            _telemetry.emit_event("checkpoint-restored", seq=self.seq,
                                  positions=dict(self._positions))
            return True
        return False

    def pending_components(self) -> List[str]:
        """Loaded components no registration has claimed (non-empty after
        a run means some state was never restored)."""
        return sorted(self._pending)
