"""Closed-loop decode-chunk governor (port of
``spatialflink_tpu.runtime.control``, the pure-Python module whole).

- The governor ticks on the telemetry-reporter cadence: the latency
  plane's bucket close (:meth:`~spatialflink_tpu_torch.utils.latencyplane
  .LatencyPlane.tick`) hands it the closed backpressure bucket (per-stage
  time deltas, the stall annotation, the decode-buffer depth) and the
  live record→emit p99, which is what ``/latency`` serves.
- A decision moves the decode chunk ONE power-of-two bucket, bounded to
  ``[min_chunk, max_chunk]``, with hysteresis twice over: a direction
  must hold for ``confirm_ticks`` consecutive buckets before a step
  applies, and every applied step starts a ``cooldown_ticks`` quiet
  period.
- Shrink when the ``buffer``/``queue`` stages dominate the budget delta
  AND the record→emit p99 breaches the target, or on a backpressure
  stall; grow when ``dispatch`` dominates or the pipe is idle with the
  p99 under ``idle_headroom`` of the target.
- No kernel shape keys on the decode chunk: it sizes host buffers only
  (``decode_chunks``' flush threshold and the Kafka commit tap's
  ``bulk_chunk``), and window batches ride their own padding buckets, so
  a resize meets no new kernel signature in the compile registry.
- Latency classes: while any serving query is ``interactive`` the FAST
  LANE caps the chunk at ``interactive_max_chunk`` and the drive loop's
  in-flight deque at ``fast_lane_depth``.
- Admission shedding: ``shed_after_stalls`` consecutive stalled buckets
  put the :class:`~spatialflink_tpu_torch.runtime.queryplane
  .QueryRegistry` into shedding (new admissions park in the ``shed``
  state, HTTP 429 on ``POST /queries``); ``unshed_after_clean`` clean
  buckets release them to PENDING.
- Every decision emits a ``chunk-governor`` event, bumps the
  ``chunk-grow`` / ``chunk-shrink`` / ``shed`` counters and sets the
  ``decode.chunk`` gauge; :meth:`ChunkGovernor.status` is the
  ``controller`` block of ``GET /latency``.
- Checkpoint component ``controller``: the chunk, the direction streaks
  and the shed state, so ``--resume`` continues a trajectory.

Off by default: nothing builds a governor unless ``--controller`` (or a
test) installs one; with none installed every read site keeps its fixed
chunk.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

#: the governor the process runs (the driver installs at most one): how
#: the latency plane's tick and the decode and drive loops find it
_ACTIVE: Optional["ChunkGovernor"] = None

#: stages whose dominance means records wait (shrink pressure), and the
#: stage that amortizes with bigger flushes (grow pressure)
_WAIT_STAGES = ("buffer", "queue")
_AMORTIZE_STAGE = "dispatch"

#: the governor's default seed chunk (the JAX package's measured knee)
KNEE_CHUNK = 2048


def active_governor() -> Optional["ChunkGovernor"]:
    """The process's installed :class:`ChunkGovernor`, or None."""
    return _ACTIVE


def chunk_bucket(n: int, lo: int = 1, hi: int = 1 << 20) -> int:
    """Snap ``n`` to the nearest power of two (a tie keeps the lower),
    clamped to ``[lo, hi]``."""
    n = max(1, int(n))
    b = 1 << (n.bit_length() - 1)
    if n - b > 2 * b - n:
        b <<= 1
    return max(int(lo), min(int(hi), b))


@dataclass
class GovernorPolicy:
    """The control law's thresholds."""

    #: record→emit p99 target (ms); a breach is shrink pressure
    target_p99_ms: float = 250.0
    #: chunk bounds, powers of two
    min_chunk: int = 256
    max_chunk: int = 8192
    #: the fast lane's cap while any interactive query serves
    interactive_max_chunk: int = 1024
    #: the fast lane's bound on the drive loop's in-flight deque
    fast_lane_depth: int = 1
    #: consecutive same-direction buckets before a step applies
    confirm_ticks: int = 2
    #: quiet buckets after an applied step
    cooldown_ticks: int = 1
    #: consecutive stalled buckets before admissions shed
    shed_after_stalls: int = 2
    #: consecutive clean buckets before shed admissions release
    unshed_after_clean: int = 2
    #: grow when idle (p99 under this fraction of the target)
    idle_headroom: float = 0.5

    @classmethod
    def from_spec(cls, spec: str) -> "GovernorPolicy":
        """Parse ``--controller target_p99_ms=150,min_chunk=512,...`` (an
        empty spec gives the defaults)."""
        float_keys = ("target_p99_ms", "idle_headroom")
        kwargs = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            key, sep, val = part.partition("=")
            key = key.strip()
            if not sep:
                raise ValueError(
                    f"--controller entry {part!r} is not key=value")
            if key not in cls.__dataclass_fields__:
                raise ValueError(
                    f"unknown --controller key {key!r}; known: "
                    + ", ".join(sorted(cls.__dataclass_fields__)))
            try:
                kwargs[key] = (float(val) if key in float_keys
                               else int(val))
            except ValueError:
                raise ValueError(
                    f"--controller {key}={val!r} is not numeric")
        return cls(**kwargs).validate()

    def validate(self) -> "GovernorPolicy":
        for name in ("min_chunk", "max_chunk", "interactive_max_chunk"):
            v = getattr(self, name)
            if v < 1 or v & (v - 1):
                raise ValueError(f"{name} must be a power of two, got {v}")
        if not self.min_chunk <= self.max_chunk:
            raise ValueError(
                f"need min_chunk ({self.min_chunk}) <= max_chunk "
                f"({self.max_chunk})")
        if self.target_p99_ms <= 0:
            raise ValueError("target_p99_ms must be positive")
        if min(self.confirm_ticks, self.cooldown_ticks + 1,
               self.shed_after_stalls, self.unshed_after_clean,
               self.fast_lane_depth) < 1:
            raise ValueError("tick/depth counts must be >= 1 "
                             "(cooldown_ticks >= 0)")
        if not 0 < self.idle_headroom <= 1:
            raise ValueError("idle_headroom must be in (0, 1]")
        return self


class ChunkGovernor:
    """Turns latency-plane buckets into decode-chunk steps and admission
    shed/un-shed transitions. The tick runs on whichever thread closes the
    bucket (the reporter or a scrape); :meth:`chunk` and
    :meth:`drain_depth` read one int or bool (written under the lock);
    :meth:`status` reads under the lock the tick writes under."""

    def __init__(self, seed_chunk: int = KNEE_CHUNK,
                 policy: Optional[GovernorPolicy] = None):
        self.policy = (policy or GovernorPolicy()).validate()
        p = self.policy
        self._lock = threading.Lock()
        self._chunk = chunk_bucket(seed_chunk, p.min_chunk, p.max_chunk)
        self.seed_chunk = self._chunk
        #: pending direction (+1 grow / -1 shrink / 0) and its streak
        self._dir = 0
        self._streak = 0
        self._cooldown = 0
        self._stall_ticks = 0
        self._clean_ticks = 0
        self.shedding = False
        #: the fast lane (any interactive query serving)
        self._fast_lane = False
        self.ticks = 0
        self.grows = 0
        self.shrinks = 0
        self.sheds = 0
        #: recent decisions, newest last (the /latency controller tail)
        self.decisions: List[dict] = []

    # ------------------------------ actuators ------------------------- #

    def chunk(self) -> int:
        """The decode chunk now: what every per-flush callback returns.
        The fast lane's cap applies here, so it never waits out a
        hysteresis streak."""
        c = self._chunk
        if self._fast_lane:
            c = min(c, self.policy.interactive_max_chunk)
        return c

    def chunk_callback(self) -> Callable[[], int]:
        """The per-flush size callback for ``decode_chunks`` and the
        commit tap: read once per buffered flush, so a resize lands
        between chunks, never inside one."""
        return self.chunk

    @property
    def fast_lane(self) -> bool:
        return self._fast_lane

    def drain_depth(self, depth: int) -> int:
        """The drive loop's in-flight deque bound: the run's
        ``pipeline_depth``, or ``fast_lane_depth`` while the fast lane is
        engaged."""
        if self._fast_lane:
            return max(1, min(int(depth), self.policy.fast_lane_depth))
        return max(1, int(depth))

    # ------------------------------ the loop -------------------------- #

    def on_tick(self, bucket: dict, p99_ms: Optional[float] = None) -> None:
        """One closed backpressure bucket (``LatencyPlane.tick``) and the
        live record→emit p99: the control law under hysteresis, at most
        one chunk step and at most one shed transition."""
        p = self.policy
        stall = bool(bucket.get("stall"))
        deltas = bucket.get("stage_delta_s") or {}
        dominant = None
        if deltas:
            dominant = max(deltas, key=lambda s: deltas[s])
            if deltas[dominant] <= 0.0:
                dominant = None
        breach = p99_ms is not None and p99_ms > p.target_p99_ms
        idle = (dominant is None
                or (p99_ms is not None
                    and p99_ms <= p.idle_headroom * p.target_p99_ms))
        if stall or (breach and dominant in _WAIT_STAGES):
            direction = -1
        elif not breach and (dominant == _AMORTIZE_STAGE or idle):
            direction = +1
        else:
            direction = 0
        with self._lock:
            self.ticks += 1
            self._refresh_fast_lane_locked()
            stepped = self._vote_locked(direction)
            shed_flip = self._shed_locked(stall)
            chunk = self.chunk()
        if stepped:
            self._note_step(stepped, chunk, dominant, p99_ms, stall)
        if shed_flip is not None:
            self._note_shed(shed_flip, stall, p99_ms)
        self._export(chunk)

    def _vote_locked(self, direction: int) -> int:
        """Hysteresis and one bounded step; the applied direction (0: no
        step). The caller holds the lock."""
        p = self.policy
        if self._cooldown > 0:
            self._cooldown -= 1
            return 0
        if direction == 0:
            self._dir = 0
            self._streak = 0
            return 0
        if direction == self._dir:
            self._streak += 1
        else:
            self._dir = direction
            self._streak = 1
        if self._streak < p.confirm_ticks:
            return 0
        nxt = self._chunk << 1 if direction > 0 else self._chunk >> 1
        nxt = max(p.min_chunk, min(p.max_chunk, nxt))
        self._streak = 0
        if nxt == self._chunk:
            return 0
        self._chunk = nxt
        self._cooldown = p.cooldown_ticks
        if direction > 0:
            self.grows += 1
        else:
            self.shrinks += 1
        return direction

    def _shed_locked(self, stall: bool) -> Optional[bool]:
        """The shed state machine: the new shed state on a flip, None
        otherwise. The caller holds the lock."""
        p = self.policy
        if stall:
            self._stall_ticks += 1
            self._clean_ticks = 0
            if not self.shedding and self._stall_ticks >= p.shed_after_stalls:
                self.shedding = True
                self.sheds += 1
                return True
        else:
            self._clean_ticks += 1
            self._stall_ticks = 0
            if self.shedding and self._clean_ticks >= p.unshed_after_clean:
                self.shedding = False
                return False
        return None

    def _refresh_fast_lane_locked(self) -> None:
        """The fast lane: any serving query declared ``interactive``, read
        off the installed registry each tick."""
        try:
            from spatialflink_tpu_torch.runtime.queryplane import (
                active_registry)

            reg = active_registry()
            self._fast_lane = bool(
                reg is not None and reg.has_interactive())
        except Exception:
            pass

    # ------------------------------ reporting ------------------------- #

    def _note_step(self, direction: int, chunk: int, dominant, p99_ms,
                   stall: bool) -> None:
        from spatialflink_tpu_torch.utils import metrics as _metrics
        from spatialflink_tpu_torch.utils import telemetry as _telemetry

        kind = "chunk-grow" if direction > 0 else "chunk-shrink"
        _metrics.REGISTRY.counter(kind).inc()
        decision = {
            "ts_ms": int(time.time() * 1000),
            "tick": self.ticks,
            "action": kind,
            "chunk": chunk,
            "dominant_stage": dominant,
            "p99_emit_ms": None if p99_ms is None else round(p99_ms, 3),
            "stall": stall,
            "fast_lane": self._fast_lane,
        }
        with self._lock:
            self.decisions.append(decision)
            del self.decisions[:-32]
        _telemetry.emit_event(
            "chunk-governor", action=kind, chunk=chunk,
            dominant_stage=dominant, stall=stall,
            p99_emit_ms=decision["p99_emit_ms"])

    def _note_shed(self, shedding: bool, stall: bool, p99_ms) -> None:
        from spatialflink_tpu_torch.utils import metrics as _metrics
        from spatialflink_tpu_torch.utils import telemetry as _telemetry

        kind = "shed" if shedding else "unshed"
        if shedding:
            _metrics.REGISTRY.counter("shed").inc()
        decision = {
            "ts_ms": int(time.time() * 1000),
            "tick": self.ticks,
            "action": kind,
            "chunk": self.chunk(),
            "stall": stall,
            "p99_emit_ms": None if p99_ms is None else round(p99_ms, 3),
            "fast_lane": self._fast_lane,
        }
        with self._lock:
            self.decisions.append(decision)
            del self.decisions[:-32]
        _telemetry.emit_event("chunk-governor", action=kind,
                              stall=stall, chunk=decision["chunk"])
        if shedding:
            # a sustained stall asks the partition layer for an early
            # repartition epoch too (the installed adaptive-grid
            # controller), and leaves a harvestable event
            _telemetry.emit_event("rebalance-request",
                                  trigger="governor-stall",
                                  chunk=decision["chunk"],
                                  p99_emit_ms=decision["p99_emit_ms"])
            try:
                from spatialflink_tpu_torch.runtime.repartition import (
                    active_controller)

                ctl = active_controller()
                if ctl is not None:
                    ctl.request_epoch()
            except Exception:
                pass
        try:
            from spatialflink_tpu_torch.runtime.queryplane import (
                active_registry)

            reg = active_registry()
            if reg is not None:
                reg.set_shedding(shedding)
        except Exception:
            pass

    def _export(self, chunk: int) -> None:
        # gauges, so the /status digest's controller stanza comes from the
        # snapshot alone
        from spatialflink_tpu_torch.utils import telemetry as _telemetry

        tel = _telemetry.active()
        if tel is not None:
            tel.gauge("decode.chunk").set(float(chunk))
            tel.gauge("decode.fast-lane").set(1.0 if self._fast_lane
                                              else 0.0)
            tel.gauge("controller.shedding").set(1.0 if self.shedding
                                                 else 0.0)

    def status(self) -> dict:
        """The ``controller`` block of ``GET /latency``: the chunk, the
        policy, the streak and cooldown, the shed state and the recent
        decisions."""
        p = self.policy
        with self._lock:
            decisions = list(self.decisions)
            return {
                "chunk": self.chunk(),
                "base_chunk": self._chunk,
                "seed_chunk": self.seed_chunk,
                "fast_lane": self._fast_lane,
                "shedding": self.shedding,
                "ticks": self.ticks,
                "grows": self.grows,
                "shrinks": self.shrinks,
                "sheds": self.sheds,
                "streak": {"dir": self._dir, "ticks": self._streak,
                           "cooldown": self._cooldown,
                           "stall_ticks": self._stall_ticks,
                           "clean_ticks": self._clean_ticks},
                "policy": {
                    "target_p99_ms": p.target_p99_ms,
                    "min_chunk": p.min_chunk,
                    "max_chunk": p.max_chunk,
                    "interactive_max_chunk": p.interactive_max_chunk,
                    "fast_lane_depth": p.fast_lane_depth,
                    "confirm_ticks": p.confirm_ticks,
                    "cooldown_ticks": p.cooldown_ticks,
                    "shed_after_stalls": p.shed_after_stalls,
                    "unshed_after_clean": p.unshed_after_clean,
                },
                "decisions": decisions,
            }

    # ------------------------------ checkpoint ------------------------ #

    def register_checkpoint(self, coordinator) -> None:
        """The control state as the checkpoint component ``controller``
        (the JAX package's form), so ``--resume`` continues the
        trajectory; a restored chunk clamps to this policy's bounds."""

        def snapshot():
            with self._lock:
                return {}, {
                    "chunk": self._chunk,
                    "dir": self._dir,
                    "streak": self._streak,
                    "cooldown": self._cooldown,
                    "stall_ticks": self._stall_ticks,
                    "clean_ticks": self._clean_ticks,
                    "shedding": self.shedding,
                    "ticks": self.ticks,
                }

        def restore(_arrays, meta) -> None:
            p = self.policy
            with self._lock:
                self._chunk = chunk_bucket(
                    meta.get("chunk", self._chunk), p.min_chunk, p.max_chunk)
                self._dir = int(meta.get("dir", 0))
                self._streak = int(meta.get("streak", 0))
                self._cooldown = int(meta.get("cooldown", 0))
                self._stall_ticks = int(meta.get("stall_ticks", 0))
                self._clean_ticks = int(meta.get("clean_ticks", 0))
                self.shedding = bool(meta.get("shedding", False))
                self.ticks = max(self.ticks, int(meta.get("ticks", 0)))

        coordinator.register("controller", snapshot, restore)

    # ------------------------------ lifecycle ------------------------- #

    def install(self) -> "ChunkGovernor":
        global _ACTIVE
        _ACTIVE = self
        self._export(self.chunk())
        return self

    def uninstall(self) -> None:
        global _ACTIVE
        if _ACTIVE is self:
            _ACTIVE = None
