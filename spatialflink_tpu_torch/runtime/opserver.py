"""The ``--live-stats`` digest (port of ``format_digest`` and ``LiveStats``
of ``spatialflink_tpu.runtime.opserver``): one stderr line per snapshot
interval, rendered from the same status snapshot the reporter writes.
The status server, its endpoints, the SLO evaluator and the chunk
governor of the JAX module are not ported yet; the digest renders their
fields when a snapshot carries them, as the JAX one does.
"""

from __future__ import annotations

import sys
import threading
from typing import Optional

from spatialflink_tpu_torch.utils import telemetry as _telemetry

_BREAKER_NAMES = {0.0: "closed", 0.5: "half-open", 1.0: "open"}


def format_digest(snap: dict) -> str:
    """One stderr line from one status snapshot — the terminal operator's
    view of the same document ``/status`` serves. Fields with no data yet
    are omitted rather than printed as None/0 noise."""
    st = snap.get("status") or {}
    parts = []
    up = snap.get("uptime_s")
    if up is not None:
        parts.append(f"up {up:.0f}s")
    parts.append(f"in {st.get('records_in', 0)} rec "
                 f"({st.get('throughput_rps', 0.0):.0f}/s)")
    parts.append(f"win {st.get('windows_evaluated', 0)}")
    wl = st.get("window_latency_ms") or {}
    if wl.get("count"):
        parts.append(f"win p99 {wl['p99']:.0f}ms")
    if st.get("watermark_lag_ms") is not None:
        parts.append(f"wm lag {st['watermark_lag_ms']:.0f}ms")
    if st.get("commit_backlog") is not None:
        parts.append(f"backlog {st['commit_backlog']:.0f}")
    pc = st.get("pane_cache") or {}
    if pc.get("hit_rate") is not None:
        parts.append(f"pane hit {pc['hit_rate'] * 100:.0f}%")
    ck = st.get("checkpoint") or {}
    if ck.get("seq") is not None:
        parts.append(f"ckpt #{int(ck['seq'])} age {ck.get('age_s', 0):.1f}s")
    if st.get("breaker_state") is not None:
        parts.append("breaker " + _BREAKER_NAMES.get(
            st["breaker_state"], str(st["breaker_state"])))
    if st.get("dlq_depth"):
        parts.append(f"dlq {st['dlq_depth']}")
    sk = st.get("skew") or {}
    if sk.get("top_share"):
        # skew concentration: the hottest cell's record share + Gini — the
        # numbers the --adaptive-grid split threshold compares against
        gini = sk.get("gini")
        parts.append(f"skew top {sk['top_share'] * 100:.0f}%"
                     + (f" gini {gini:.2f}" if gini is not None else ""))
    tc = st.get("top_cost_cells") or []
    if tc:
        # the costliest grid cell and its attributed kernel share — the
        # skew-cost headline (who pays, not just who's crowded)
        cell, cost_ms, _recs = tc[0]
        total = (snap.get("costs") or {}).get("total_kernel_ms") or 0.0
        share = f" ({cost_ms / total * 100:.0f}%)" if total else ""
        parts.append(f"hot cell {cell} {cost_ms:.0f}ms{share}")
    dev = st.get("device") or {}
    be = dev.get("backend") or {}
    if be:
        # device truth: backend provenance on every digest line (a run
        # that landed on the CPU says so) + post-warmup recompiles when
        # the sentinel has fired
        s = f"dev {be.get('platform')}"
        if be.get("target") and not be.get("valid_for_target"):
            s += f"!={be['target']}"
        if dev.get("recompiles"):
            s += f" recompiles {dev['recompiles']}"
        mb = dev.get("mem_bytes_in_use")
        if mb:
            s += f" mem {mb / 1e6:.0f}MB"
        parts.append(s)
    ov = st.get("dispatch_overlap") or {}
    if ov.get("count"):
        # dispatch→ready overlap: how much of the device round-trip hid
        # behind host work (1.0 = fully hidden — the pipeline_depth payoff)
        parts.append(f"ovl {ov['p50'] * 100:.0f}%")
    la = st.get("latency") or {}
    re_h = la.get("record_emit_ms") or {}
    if re_h.get("count"):
        # record→emit p99 + the stage whose residency dominates — the
        # one-glance answer to "where is a record's time going" (full
        # decomposition at GET /latency)
        s = f"lat p99 {re_h['p99']:.0f}ms"
        if la.get("dominant_stage"):
            s += f" ({la['dominant_stage']})"
        if la.get("stall"):
            s += " STALL"
        parts.append(s)
    ctl = st.get("controller") or {}
    if ctl.get("chunk") is not None:
        # the actuator, next to the sensor it reacts to: live decode-chunk
        # setting plus step totals, fast lane, and shedding — one glance
        # answers "what is the governor doing about that latency"
        s = f"chunk {ctl['chunk']}"
        moves = int(ctl.get("grows", 0)) + int(ctl.get("shrinks", 0))
        if moves:
            s += f" ({ctl.get('grows', 0)}+/{ctl.get('shrinks', 0)}-)"
        if ctl.get("fast_lane"):
            s += " fast-lane"
        if ctl.get("shedding"):
            s += " SHED"
        parts.append(s)
    ten = st.get("tenants") or {}
    if ten.get("n", 0) > 1 and ten.get("top"):
        # who pays for this pipeline: the top tenant's attributed kernel
        # share (+ quota refusals when any) — only worth a glance when the
        # run is actually shared (n>1), full ledger at GET /tenants
        s = (f"tenant top {ten['top']} "
             f"{(ten.get('top_share') or 0.0) * 100:.0f}%")
        if ten.get("quota_rejections"):
            s += f" quota-rej {ten['quota_rejections']}"
        parts.append(s)
    deg = snap.get("degradation") or {}
    if deg:
        parts.append(f"degraded x{sum(deg.values())}")
    health = snap.get("health")
    if health is not None:
        bad = [n for n, c in health["checks"].items() if not c["ok"]]
        parts.append("health " + health["status"]
                     + (f" ({','.join(bad)})" if bad else ""))
    return "# live: " + " | ".join(parts)


class LiveStats:
    """Daemon thread printing :func:`format_digest` to stderr — once
    immediately at :meth:`start` (so even a short run shows a line), then
    per ``interval_s``. Reads ``sys.stderr`` at print time so pytest's
    capture and shell redirection both see the lines."""

    def __init__(self, interval_s: float = 5.0, telemetry=None, health=None,
                 registry=None):
        self.interval_s = max(0.01, float(interval_s))
        self.telemetry = telemetry
        self.health = health
        self.registry = registry
        self.emitted = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _tick(self) -> None:
        # pinned/active and explicit/session-health fallbacks are
        # status_snapshot's job (same resolution as /status and the
        # reporter)
        snap = _telemetry.status_snapshot(self.telemetry, health=self.health,
                                          registry=self.registry)
        print(format_digest(snap), file=sys.stderr, flush=True)
        self.emitted += 1

    def _loop(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._tick()

    def start(self) -> "LiveStats":
        self._tick()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="live-stats")
        self._thread.start()
        return self

    def close(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.interval_s + 5.0)
            self._thread = None
        self._tick()  # final line: the run's closing state
