"""SLO / health evaluation for the operations plane (port of
``spatialflink_tpu.runtime.health``, the pure-Python module whole).

``--slo key=value,...`` configures threshold checks over the shared status
digest (:func:`~spatialflink_tpu_torch.utils.telemetry.status_digest`).
The verdict

- drives the status server's ``GET /healthz`` code (200 healthy / 503
  breached);
- is stamped as ``health`` into every telemetry snapshot and ``/status``
  document;
- counts breach TRANSITIONS (ok -> breached, per check) in the
  ``slo-breaches`` registry counter and emits ``slo-breach`` /
  ``slo-recovered`` events (plus ``watermark-stall`` for the
  watermark-lag check) into the event ring.

A check compares one digest field against one threshold. A field with no
value yet (gauge never set, histogram empty, no card: the device memory
on the CPU) is UNKNOWN and counts as healthy: a pipeline that has not
produced a window yet is starting, not breaching. Every check breaches on
``value > threshold`` except ``min_throughput_rps`` (``value <
threshold``). ``recompiles`` reads the port's compile registry (a kernel
library build or a first call at a new signature after the warmup);
``device_mem_bytes`` the largest ``torch.cuda.memory_stats`` allocation
over the cards.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, Optional


def _hist_p99(field: str) -> Callable[[dict], Optional[float]]:
    def get(status: dict) -> Optional[float]:
        h = status.get(field) or {}
        return h.get("p99") if h.get("count") else None
    return get


def _gauge(field: str) -> Callable[[dict], Optional[float]]:
    return lambda status: status.get(field)


def _checkpoint_age(status: dict) -> Optional[float]:
    return (status.get("checkpoint") or {}).get("age_s")


def _device_field(field: str) -> Callable[[dict], Optional[float]]:
    """Reader over the digest's ``device`` stanza (``utils.deviceplane``):
    ``recompiles`` is the post-warmup compile count, ``mem_bytes_in_use``
    the live allocation on the card (None on the CPU: unknown counts
    healthy, like every other check)."""
    def get(status: dict) -> Optional[float]:
        return (status.get("device") or {}).get(field)
    return get


def _emit_p99(status: dict) -> Optional[float]:
    """Record→emit p99 off the digest's ``latency`` stanza; no windows
    budgeted yet (or no session) reads None."""
    h = (status.get("latency") or {}).get("record_emit_ms") or {}
    return h.get("p99") if h.get("count") else None


def _shedding(status: dict) -> Optional[float]:
    """1.0 while the chunk governor holds the registry in admission
    shedding, 0.0 while admitting, None without a governor."""
    ctl = status.get("controller") or {}
    if ctl.get("chunk") is None:
        return None
    return 1.0 if ctl.get("shedding") else 0.0


def _throughput(status: dict) -> Optional[float]:
    # a stream that never started is unknown; one that stalled after
    # records flowed is a real, breachable 0 rps
    if not status.get("records_in"):
        return None
    return status.get("throughput_rps")


#: check name -> (extractor over the status digest, breach comparator).
#: ``hi`` breaches when value > threshold, ``lo`` when value < threshold.
KNOWN_CHECKS: Dict[str, tuple] = {
    "watermark_lag_ms": (_gauge("watermark_lag_ms"), "hi"),
    "p99_window_ms": (_hist_p99("window_latency_ms"), "hi"),
    "p99_record_ms": (_hist_p99("record_latency_ms"), "hi"),
    "commit_backlog": (_gauge("commit_backlog"), "hi"),
    "window_backlog": (_gauge("window_backlog"), "hi"),
    "checkpoint_age_s": (_checkpoint_age, "hi"),
    "dlq_depth": (_gauge("dlq_depth"), "hi"),
    "breaker_state": (_gauge("breaker_state"), "hi"),
    "min_throughput_rps": (_throughput, "lo"),
    "recompiles": (_device_field("recompiles"), "hi"),
    "device_mem_bytes": (_device_field("mem_bytes_in_use"), "hi"),
    "p99_emit_ms": (_emit_p99, "hi"),
    "shedding": (_shedding, "hi"),
}


class HealthEvaluator:
    """Threshold checks over the status digest. Stateful, so breach
    TRANSITIONS (not every unhealthy evaluation) bump the ``slo-breaches``
    counter and the event ring. One instance is shared by the reporter
    thread, the status server and the stderr digest (under its lock), so
    they agree on the transition history."""

    def __init__(self, thresholds: Dict[str, float]):
        unknown = sorted(set(thresholds) - set(KNOWN_CHECKS))
        if unknown:
            raise ValueError(
                f"unknown --slo check(s) {', '.join(unknown)}; known: "
                + ", ".join(sorted(KNOWN_CHECKS)))
        if not thresholds:
            raise ValueError(
                "--slo needs at least one key=value pair; known checks: "
                + ", ".join(sorted(KNOWN_CHECKS)))
        self.thresholds = {k: float(v) for k, v in thresholds.items()}
        self._breached: Dict[str, bool] = {}
        #: breach-transition observers ``hook(check, value, threshold)``
        #: (the flight recorder dumps a bundle here); a failing hook never
        #: changes the verdict
        self.hooks: list = []
        self._lock = threading.Lock()

    @classmethod
    def from_spec(cls, spec: str) -> "HealthEvaluator":
        """Parse ``--slo watermark_lag_ms=5000,p99_window_ms=250,...``."""
        thresholds: Dict[str, float] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            key, sep, val = part.partition("=")
            if not sep:
                raise ValueError(
                    f"--slo entry {part!r} is not key=value")
            try:
                thresholds[key.strip()] = float(val)
            except ValueError:
                raise ValueError(
                    f"--slo {key.strip()}={val!r} is not numeric")
        return cls(thresholds)

    def evaluate(self, snap: dict, registry=None) -> dict:
        """Every configured check against one snapshot document (its
        ``status`` digest, computed here for a raw snapshot). Breach
        transitions count in ``registry`` (the registry the snapshot was
        built from; None: the ambient one). Returns the ``health``
        stanza::

            {"healthy": bool, "status": "ok"|"breach",
             "checks": {name: {"value", "threshold", "ok"}}}
        """
        from spatialflink_tpu_torch.utils import metrics as _metrics
        from spatialflink_tpu_torch.utils import telemetry as _telemetry

        reg = registry if registry is not None else _metrics.REGISTRY
        status = snap.get("status")
        if status is None:
            status = _telemetry.status_digest(snap)
        checks: Dict[str, dict] = {}
        healthy = True
        fired: list = []
        with self._lock:
            for name, threshold in sorted(self.thresholds.items()):
                extract, direction = KNOWN_CHECKS[name]
                value = extract(status)
                ok = True
                if value is not None:
                    v = float(value)
                    ok = (v <= threshold if direction == "hi"
                          else v >= threshold)
                checks[name] = {"value": value, "threshold": threshold,
                                "ok": ok}
                healthy = healthy and ok
                was = self._breached.get(name, False)
                if not ok and not was:
                    reg.counter("slo-breaches").inc()
                    _telemetry.emit_event("slo-breach", check=name,
                                          value=value, threshold=threshold)
                    fired.append((name, value, threshold))
                    if name == "watermark_lag_ms":
                        _telemetry.emit_event("watermark-stall",
                                              lag_ms=value,
                                              threshold=threshold)
                elif ok and was:
                    _telemetry.emit_event("slo-recovered", check=name,
                                          value=value)
                self._breached[name] = not ok
        # hooks run outside the lock: a flight-recorder dump evaluates
        # again through status_snapshot, and the transition is recorded
        # already, so that evaluation cannot fire the hook again
        for name, value, threshold in fired:
            for hook in list(self.hooks):
                try:
                    hook(name, value, threshold)
                except Exception:
                    pass
        return {"healthy": healthy,
                "status": "ok" if healthy else "breach",
                "checks": checks}
