"""Per-query and per-tenant cost accounting for the shared dispatch (port
of ``spatialflink_tpu.utils.accounting``, the pure-Python module whole).

The padded-fleet dispatch evaluates every live query in one launch, so a
per-kernel time says what a batch cost but not who asked for it. The
ledger is two-phase:

- ``note_dispatch(label, window_start, kernel_s, records, nbytes)`` runs
  where ``_drive_batched`` times the dispatch and parks the span as a
  PENDING entry keyed ``(label, window_start)``;
- ``resolve(label, window_start, slots)`` runs where the per-slot masks
  are on the host (the dynamic plane's demux) and splits the span across
  the live slots in proportion to each slot's mask-true count.

Shares are proportional floats with the rounding residual folded into
the heaviest slot, so the attributed kernel-ms sums to the measured span
(``max_residual_ms`` keeps the worst fold). Dispatches that never demux
(static single-query paths) age into the default tenant. Host float
arithmetic on counts already read back: no device work. Every feed site
is behind the session check, so a run without a session never builds a
ledger. Every instance-attribute write outside ``__init__`` holds
``self._lock`` (the record loop and the reporter thread share it).

:func:`parse_tenant_quotas` reads ``--tenant-quota``; the query registry
(``runtime/queryplane.py``) enforces the ceilings at admission and raises
:class:`QuotaExceeded`.
"""
from __future__ import annotations

import threading
import time
from collections import OrderedDict, deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "DEFAULT_TENANT",
    "QuotaExceeded",
    "TenantLedger",
    "gini",
    "merge_tenant_payloads",
    "parse_tenant_quotas",
]

#: tenant every QuerySpec lands in unless ``--tenant-default`` /
#: ``tenant=`` says otherwise
DEFAULT_TENANT = "default"

#: per-tenant distinct-query-id tracking cap (observability nicety,
#: bounded so a query churn storm cannot grow the ledger unboundedly)
_QUERY_ID_CAP = 512

#: cumulative per-tenant counter fields, in render order
ROW_FIELDS = (
    "kernel_ms", "bytes_moved", "records_in", "records_out", "windows",
    "pane_hits", "pane_misses", "slo_breaches", "shed",
    "quota_rejections",
)


class QuotaExceeded(Exception):
    """An admission was refused by a ``--tenant-quota`` ceiling.

    Distinct from load shedding: shed parks the query as SHED
    and admits it on pressure release; a quota rejection never creates
    an entry at all — the tenant is over its own ceiling regardless of
    engine pressure. Served as HTTP 429 ``quota-exceeded``.
    """

    def __init__(self, tenant: str, reason: str):
        self.tenant = str(tenant)
        self.reason = str(reason)
        super().__init__(f"tenant {self.tenant!r}: {self.reason}")


def parse_tenant_quotas(text: str) -> Dict[str, dict]:
    """Parse ``--tenant-quota`` syntax into per-tenant ceilings.

    ``T:max_active[,kernel_ms_s=X]`` with multiple tenants separated by
    ``;`` — e.g. ``acme:4,kernel_ms_s=250;free:1``. Returns
    ``{tenant: {"max_active": int, "kernel_ms_s": float?}}``; raises
    ``ValueError`` on malformed input (the driver maps that to its
    usual argparse error path).
    """
    quotas: Dict[str, dict] = {}
    for part in (text or "").split(";"):
        part = part.strip()
        if not part:
            continue
        head, _, rest = part.partition(",")
        tenant, sep, max_s = head.partition(":")
        tenant = tenant.strip()
        if not tenant or not sep:
            raise ValueError(
                f"bad tenant quota {part!r}: want T:max_active"
                "[,kernel_ms_s=X]")
        try:
            max_active = int(max_s.strip())
        except ValueError:
            raise ValueError(
                f"bad tenant quota {part!r}: max_active must be an int")
        if max_active < 0:
            raise ValueError(
                f"bad tenant quota {part!r}: max_active must be >= 0")
        quota: Dict[str, object] = {"max_active": max_active}
        for opt in rest.split(","):
            opt = opt.strip()
            if not opt:
                continue
            k, sep, v = opt.partition("=")
            if k.strip() != "kernel_ms_s" or not sep:
                raise ValueError(
                    f"bad tenant quota option {opt!r}: only "
                    "kernel_ms_s=X is understood")
            try:
                rate = float(v.strip())
            except ValueError:
                raise ValueError(
                    f"bad tenant quota option {opt!r}: "
                    "kernel_ms_s must be a number")
            if rate <= 0:
                raise ValueError(
                    f"bad tenant quota option {opt!r}: "
                    "kernel_ms_s must be > 0")
            quota["kernel_ms_s"] = rate
        if tenant in quotas:
            raise ValueError(f"duplicate tenant quota for {tenant!r}")
        quotas[tenant] = quota
    return quotas


def gini(values: Iterable[float]) -> float:
    """Gini coefficient over positive values (0 = perfectly even) —
    the same mean-difference form CellOccupancy.gini uses for cell
    skew, host-side and numpy-free so the fleet supervisor can merge
    without a device backend."""
    vals = sorted(float(v) for v in values if v and v > 0)
    m = len(vals)
    total = sum(vals)
    if m == 0 or total <= 0:
        return 0.0
    weighted = sum(i * v for i, v in enumerate(vals, start=1))
    return (2.0 * weighted / (m * total)) - (m + 1) / m


def _fairness(rows: Dict[str, dict]) -> dict:
    """Fairness summary over per-tenant attributed kernel-ms: the top
    payer, max/min share, and the Gini skew — the status-digest block
    and the supervisor's merged /fleet/tenants both render this."""
    costs = {t: float(r.get("kernel_ms") or 0.0) for t, r in rows.items()}
    total = sum(v for v in costs.values() if v > 0)
    if total <= 0:
        return {"top": None, "top_share": 0.0, "max_share": 0.0,
                "min_share": 0.0, "gini": 0.0}
    shares = {t: v / total for t, v in costs.items() if v > 0}
    top = max(shares, key=lambda t: shares[t])
    return {
        "top": top,
        "top_share": round(shares[top], 4),
        "max_share": round(max(shares.values()), 4),
        "min_share": round(min(shares.values()), 4),
        "gini": round(gini(shares.values()), 4),
    }


class TenantLedger:
    """The per-tenant cost ledger: cumulative counters, the pending
    dispatch table, bounded delta time-series buckets (CostProfiles'
    tick discipline), and the fairness summary. One instance lives on
    the telemetry session (``tel.tenants``) and rides coordinated
    checkpoints as component ``tenants``."""

    def __init__(self, *, default_tenant: str = DEFAULT_TENANT,
                 series_capacity: int = 128,
                 tick_interval_s: float = 5.0,
                 pending_capacity: int = 256,
                 pending_max_age_s: float = 5.0):
        self._lock = threading.Lock()
        self.default_tenant = str(default_tenant or DEFAULT_TENANT)
        #: tenant -> cumulative ROW_FIELDS counters
        self._tenants: Dict[str, Dict[str, float]] = {}
        #: tenant -> distinct query ids seen (capped)
        self._queries: Dict[str, set] = {}
        #: (label, window_start) -> measured-but-unattributed dispatch
        self._pending: "OrderedDict[Tuple[str, int], dict]" = OrderedDict()
        self.pending_capacity = max(1, int(pending_capacity))
        self.pending_max_age_s = float(pending_max_age_s)
        #: closed delta buckets: {"ts_ms", "dt_s", "kernel_ms": {t: ms}}
        self.series: deque = deque(maxlen=max(1, int(series_capacity)))
        self.tick_interval_s = float(tick_interval_s)
        self._last_tick_s = time.time()
        #: per-tenant cumulative kernel_ms at the last tick (delta base)
        self._at_tick: Dict[str, float] = {}
        #: worst |measured - sum(attributed)| fold, in ms (the
        #: sums-to-total residual — stays ~float-epsilon by construction)
        self.max_residual_ms = 0.0
        self.dispatches = 0
        self.resolved = 0
        #: resolve() with no pending entry (span already aged out)
        self.late_resolves = 0
        #: pending entries attributed to the default tenant by age/cap
        self.flushed = 0

    # ------------------------- feeds (hot path, tel-gated) ---------- #

    def note_dispatch(self, label: str, window_start, kernel_s: float,
                      records: int, nbytes: int) -> None:
        """Park one measured dispatch span until the demux resolves it.
        Called from ``_drive_batched`` right where the span is timed."""
        key = (str(label), int(window_start))
        entry = {"kernel_ms": float(kernel_s) * 1e3,
                 "records": int(records), "nbytes": int(nbytes),
                 "wall_s": time.time()}
        with self._lock:
            self.dispatches += 1
            prev = self._pending.pop(key, None)
            if prev is not None:  # re-dispatch of the same window: merge
                entry["kernel_ms"] += prev["kernel_ms"]
                entry["records"] += prev["records"]
                entry["nbytes"] += prev["nbytes"]
            self._pending[key] = entry
            while len(self._pending) > self.pending_capacity:
                _, old = self._pending.popitem(last=False)
                self._credit_locked(self.default_tenant, old)
                self.flushed += 1

    def resolve(self, label: str, window_start,
                slots: Sequence[Tuple[str, Optional[str], float]]) -> None:
        """Attribute one parked dispatch across the live slots.

        ``slots`` is ``[(query_id, tenant, weight)]`` for the LIVE rows
        of the padded fleet only — weight is the slot's mask-true
        candidate count over the real (un-padded) record rows. A zero
        total weight splits uniformly across the live slots; the
        rounding residual folds into the heaviest slot so the sum is
        exact."""
        key = (str(label), int(window_start))
        with self._lock:
            pend = self._pending.pop(key, None)
            if pend is None:
                self.late_resolves += 1
                return
            self.resolved += 1
            self._split_locked(pend, list(slots))

    def _split_locked(self, pend: dict,
                      slots: List[Tuple[str, Optional[str], float]]) -> None:
        if not slots:
            self._credit_locked(self.default_tenant, pend)
            return
        weights = [max(0.0, float(w)) for _, _, w in slots]
        total_w = sum(weights)
        if total_w <= 0.0:
            weights = [1.0] * len(slots)
            total_w = float(len(slots))
        kms = float(pend["kernel_ms"])
        recs = float(pend["records"])
        nbytes = float(pend["nbytes"])
        shares = [w / total_w for w in weights]
        per_k = [kms * s for s in shares]
        per_r = [recs * s for s in shares]
        per_b = [nbytes * s for s in shares]
        heavy = max(range(len(slots)), key=lambda i: weights[i])
        residual = kms - sum(per_k)
        per_k[heavy] += residual
        per_r[heavy] += recs - sum(per_r)
        per_b[heavy] += nbytes - sum(per_b)
        if abs(residual) > self.max_residual_ms:
            self.max_residual_ms = abs(residual)
        for (qid, tenant, _), sk, sr, sb in zip(slots, per_k, per_r,
                                                per_b):
            row = self._row_locked(tenant or self.default_tenant)
            row["kernel_ms"] += sk
            row["records_in"] += sr
            row["bytes_moved"] += sb
            self._note_query_locked(tenant or self.default_tenant, qid)

    def note_window(self, tenant: Optional[str], query_id: str,
                    n_records: int) -> None:
        """One emitted window for one query — the router's per-window
        demux feed (records_out / windows)."""
        with self._lock:
            row = self._row_locked(tenant or self.default_tenant)
            row["windows"] += 1
            row["records_out"] += int(n_records)
            self._note_query_locked(tenant or self.default_tenant,
                                    query_id)

    def note_pane(self, tenant: Optional[str], hits: int = 0,
                  misses: int = 0) -> None:
        with self._lock:
            row = self._row_locked(tenant or self.default_tenant)
            row["pane_hits"] += int(hits)
            row["pane_misses"] += int(misses)

    def note_breach(self, tenant: Optional[str]) -> None:
        with self._lock:
            row = self._row_locked(tenant or self.default_tenant)
            row["slo_breaches"] += 1

    def note_shed(self, tenant: Optional[str]) -> None:
        with self._lock:
            row = self._row_locked(tenant or self.default_tenant)
            row["shed"] += 1

    def note_quota_rejection(self, tenant: Optional[str]) -> None:
        with self._lock:
            row = self._row_locked(tenant or self.default_tenant)
            row["quota_rejections"] += 1

    # ------------------------- internals (caller holds lock) -------- #

    def _row_locked(self, tenant: str) -> Dict[str, float]:
        row = self._tenants.get(tenant)
        if row is None:
            row = self._tenants.setdefault(
                tenant, {f: 0.0 for f in ROW_FIELDS})
        return row

    def _note_query_locked(self, tenant: str, query_id) -> None:
        if query_id is None:
            return
        qs = self._queries.setdefault(tenant, set())
        if len(qs) < _QUERY_ID_CAP:
            qs.add(str(query_id))

    def _credit_locked(self, tenant: str, pend: dict) -> None:
        row = self._row_locked(tenant)
        row["kernel_ms"] += float(pend["kernel_ms"])
        row["records_in"] += float(pend["records"])
        row["bytes_moved"] += float(pend["nbytes"])

    def _flush_stale_locked(self, now: float) -> None:
        """Age unresolved pending spans into the default tenant —
        static single-query paths never demux through ``rows()``, and
        their measured cost must not sit unattributed forever."""
        cutoff = now - self.pending_max_age_s
        while self._pending:
            key = next(iter(self._pending))
            if self._pending[key]["wall_s"] > cutoff:
                break
            pend = self._pending.pop(key)
            self._credit_locked(self.default_tenant, pend)
            self.flushed += 1

    # ------------------------- tick discipline ---------------------- #

    def maybe_tick(self) -> None:
        """Scrape-driven bucket close (CostProfiles discipline): cheap
        no-op inside the interval, so payload builders can call it on
        every GET."""
        with self._lock:
            now = time.time()
            if now - self._last_tick_s < self.tick_interval_s:
                return
            self._tick_locked(now)

    def tick(self) -> None:
        with self._lock:
            self._tick_locked(time.time())

    def _tick_locked(self, now: float) -> None:
        self._flush_stale_locked(now)
        cur = {t: r["kernel_ms"] for t, r in self._tenants.items()}
        delta = {}
        for t, v in cur.items():
            d = v - self._at_tick.get(t, 0.0)
            if d > 0:
                delta[t] = round(d, 3)
        self.series.append({"ts_ms": int(now * 1000),
                            "dt_s": round(now - self._last_tick_s, 3),
                            "kernel_ms": delta})
        self._at_tick = cur
        self._last_tick_s = now

    def kernel_ms_rate(self, tenant: str,
                       horizon_s: float = 30.0) -> float:
        """Attributed kernel-ms per wall second over the recent horizon
        (open delta plus closed buckets) — the ``kernel_ms_s=`` quota's
        admission signal."""
        with self._lock:
            now = time.time()
            ms = (self._tenants.get(tenant, {}).get("kernel_ms", 0.0)
                  - self._at_tick.get(tenant, 0.0))
            span = now - self._last_tick_s
            for bucket in reversed(self.series):
                if span >= horizon_s:
                    break
                ms += float((bucket.get("kernel_ms") or {})
                            .get(tenant, 0.0))
                span += float(bucket.get("dt_s") or 0.0)
        if span <= 0.0:
            return 0.0
        return ms / span

    # ------------------------- views --------------------------------- #

    def _row_public_locked(self, tenant: str) -> dict:
        row = self._tenants[tenant]
        out = {
            "kernel_ms": round(row["kernel_ms"], 3),
            "bytes_moved": int(round(row["bytes_moved"])),
            "records_in": int(round(row["records_in"])),
            "records_out": int(row["records_out"]),
            "windows": int(row["windows"]),
            "pane_hits": int(row["pane_hits"]),
            "pane_misses": int(row["pane_misses"]),
            "slo_breaches": int(row["slo_breaches"]),
            "shed": int(row["shed"]),
            "quota_rejections": int(row["quota_rejections"]),
            "queries": len(self._queries.get(tenant, ())),
        }
        return out

    def to_dict(self) -> dict:
        """The ``tenants`` block of a telemetry snapshot: per-tenant
        rows, the fairness summary, and the ledger's own health
        counters."""
        with self._lock:
            self._flush_stale_locked(time.time())
            rows = {t: self._row_public_locked(t)
                    for t in sorted(self._tenants)}
            return {
                "tenants": rows,
                "n": len(rows),
                "default_tenant": self.default_tenant,
                "fairness": _fairness(rows),
                "pending": len(self._pending),
                "dispatches": self.dispatches,
                "resolved": self.resolved,
                "late_resolves": self.late_resolves,
                "flushed": self.flushed,
                "max_residual_ms": round(self.max_residual_ms, 6),
            }

    def payload(self) -> dict:
        """The ``GET /tenants`` document: the snapshot block plus the
        bounded delta series (scrape closes a due bucket first)."""
        self.maybe_tick()
        doc = self.to_dict()
        doc["schema"] = "tenants-v1"
        doc["ts_ms"] = int(time.time() * 1000)
        with self._lock:
            doc["series"] = [dict(b) for b in self.series]
        return doc

    def tenant_payload(self, tenant: str) -> Optional[dict]:
        """The ``GET /tenants/<id>`` document, or None if the tenant
        has never been seen."""
        self.maybe_tick()
        with self._lock:
            if tenant not in self._tenants:
                return None
            doc = {"schema": "tenant-v1", "tenant": tenant,
                   "ts_ms": int(time.time() * 1000)}
            doc.update(self._row_public_locked(tenant))
            doc["kernel_ms_series"] = [
                {"ts_ms": b["ts_ms"],
                 "kernel_ms": (b.get("kernel_ms") or {}).get(tenant, 0.0)}
                for b in self.series]
            doc["query_ids"] = sorted(self._queries.get(tenant, ()))
        doc["kernel_ms_rate"] = round(self.kernel_ms_rate(tenant), 3)
        return doc

    # ------------------------- checkpoint ---------------------------- #

    def snapshot(self) -> dict:
        """JSON state for the coordinated checkpoint (component
        ``tenants``): cumulative counters only — the pending table and
        delta series are transient observability."""
        with self._lock:
            return {
                "v": 1,
                "default_tenant": self.default_tenant,
                "tenants": {t: {f: r[f] for f in ROW_FIELDS}
                            for t, r in self._tenants.items()},
                "queries": {t: sorted(q)
                            for t, q in self._queries.items() if q},
                "max_residual_ms": self.max_residual_ms,
                "dispatches": self.dispatches,
                "resolved": self.resolved,
                "late_resolves": self.late_resolves,
                "flushed": self.flushed,
            }

    def restore(self, meta: Optional[dict]) -> None:
        if not meta:
            return
        tenants: Dict[str, Dict[str, float]] = {}
        for t, r in (meta.get("tenants") or {}).items():
            row = {f: 0.0 for f in ROW_FIELDS}
            for f in ROW_FIELDS:
                try:
                    row[f] = float((r or {}).get(f) or 0.0)
                except (TypeError, ValueError):
                    pass
            tenants[str(t)] = row
        with self._lock:
            self._tenants = tenants
            self._queries = {
                str(t): set(str(q) for q in (qs or [])[:_QUERY_ID_CAP])
                for t, qs in (meta.get("queries") or {}).items()}
            self.default_tenant = str(meta.get("default_tenant")
                                      or self.default_tenant)
            self.max_residual_ms = float(meta.get("max_residual_ms")
                                         or 0.0)
            self.dispatches = int(meta.get("dispatches") or 0)
            self.resolved = int(meta.get("resolved") or 0)
            self.late_resolves = int(meta.get("late_resolves") or 0)
            self.flushed = int(meta.get("flushed") or 0)
            self._at_tick = {t: r["kernel_ms"]
                             for t, r in self._tenants.items()}

    def register_checkpoint(self, coordinator) -> None:
        """Ride coordinated checkpoints as component ``tenants`` —
        same shape as QueryRegistry.register_checkpoint."""
        coordinator.register(
            "tenants",
            lambda: ({}, self.snapshot()),
            lambda _arrays, meta: self.restore(meta),
        )


def merge_tenant_payloads(payloads: Iterable[Optional[dict]]) -> dict:
    """Merge per-worker ``/tenants`` documents into one fleet view —
    sums the cumulative rows per tenant, keeps the worst residual, and
    recomputes the fairness summary over the merged rows (shares only
    make sense fleet-wide, so per-worker fairness blocks are
    discarded). The supervisor's ``GET /fleet/tenants`` serves this."""
    rows: Dict[str, dict] = {}
    counters = {"dispatches": 0, "resolved": 0, "late_resolves": 0,
                "flushed": 0, "pending": 0}
    max_residual = 0.0
    workers = 0
    for doc in payloads:
        if not doc:
            continue
        workers += 1
        for k in counters:
            try:
                counters[k] += int(doc.get(k) or 0)
            except (TypeError, ValueError):
                pass
        try:
            max_residual = max(max_residual,
                               float(doc.get("max_residual_ms") or 0.0))
        except (TypeError, ValueError):
            pass
        for t, r in (doc.get("tenants") or {}).items():
            dst = rows.setdefault(
                str(t), {f: 0 for f in ROW_FIELDS} | {"queries": 0})
            for f in ROW_FIELDS + ("queries",):
                try:
                    dst[f] += (r or {}).get(f) or 0
                except TypeError:
                    pass
    for r in rows.values():
        r["kernel_ms"] = round(float(r["kernel_ms"]), 3)
    merged = {
        "schema": "fleet-tenants-v1",
        "ts_ms": int(time.time() * 1000),
        "workers": workers,
        "tenants": {t: rows[t] for t in sorted(rows)},
        "n": len(rows),
        "fairness": _fairness(rows),
        "max_residual_ms": round(max_residual, 6),
    }
    merged.update(counters)
    return merged
