"""Standing-query control plane (the port's own copy of the parts of
``spatialflink_tpu.runtime.queryplane`` that serve a fleet from a file or
from in-process calls).

- :class:`QuerySpec` / :class:`QueryEntry`: one standing query's validated
  spec (id, family, point, route, optional SLO over window record counts)
  and its lifecycle (``pending -> active -> draining -> retired``).
- :class:`QueryRegistry`: what runs. Admissions, updates and retirements
  arrive from any thread (the status server's ``POST /queries`` /
  ``DELETE /queries/<id>``, the control topic, in-process calls), are
  staged and land only at :meth:`QueryRegistry.apply`, which the dynamic
  drive loop calls once per window, so a window is never evaluated
  against a half-applied fleet. Each applied change bumps
  ``fleet_version``; the operators rebuild their query arrays on the bump.
  Tenant quotas (``--tenant-quota``) refuse a new admission outright
  (:class:`~spatialflink_tpu_torch.utils.accounting.QuotaExceeded`, no
  entry made); admission shedding (the chunk governor's stall verdict,
  ``runtime/control.py``) parks new admissions in the ``shed`` state
  until it is lifted.
- :func:`bucket_size`: the fleet pads to the next power of two (the
  kernels' Q axis), padded slots forced empty by a valid gate.
- :class:`QueryRouter`: per-query demultiplexing of a dynamic window to
  each query's route (``stdout``, ``file:<path>`` or ``kafka:<topic>``),
  with the per-query SLO verdict.
- :class:`ControlTopicConsumer`: admissions, updates and retirements read
  from a Kafka control topic (``--control-topic``), drained inside
  :meth:`QueryRegistry.apply`.
- The checkpoint component ``queries`` (:meth:`QueryRegistry.snapshot` /
  :meth:`QueryRegistry.restore`, the JAX package's form): a resumed run
  restores its fleet, mid-drain entries, staged updates and the control
  topic's position.

Telemetry, as in the JAX module: the lifecycle counts in
``queries-admitted`` / ``-updated`` / ``-retired`` / ``-shed`` /
``-quota-rejected`` / ``-restored`` and ``fleet-repads``, with a
``query-*`` event at each step; each demultiplexed window counts in
``windows-emitted@<id>`` / ``records-out@<id>`` (and routed ones in
``query-windows-routed``), an SLO breach in ``query-slo-breaches`` with a
``query-slo-breach`` / ``query-slo-recovered`` event (and, with a flight
recorder, one bundle per query id); with a session the
router observes each query's record→emit latency (``record-emit-ms@<id>``,
which the ``p99_emit_ms`` SLO reads), the routed records' ingest latency
and the ``window-records@<id>`` histogram, and the tenant ledger takes the
window and the breach. :func:`active_registry` is the installed registry
(the latency plane reads its staged changes, the status server its
ledger, the governor its latency classes).
"""

from __future__ import annotations

import enum
import json
import sys
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from spatialflink_tpu_torch.utils import metrics as _metrics
from spatialflink_tpu_torch.utils.accounting import (DEFAULT_TENANT,
                                                     QuotaExceeded)

_ACTIVE: Optional["QueryRegistry"] = None


def active_registry() -> Optional["QueryRegistry"]:
    """The process's installed :class:`QueryRegistry`, or None."""
    return _ACTIVE


def _emit(kind: str, **fields) -> None:
    """A lifecycle event on the telemetry session's ring (nothing without
    a session)."""
    from spatialflink_tpu_torch.utils.telemetry import emit_event

    emit_event(kind, **fields)


def _telemetry_active():
    """The active telemetry session (lazily imported)."""
    from spatialflink_tpu_torch.utils import telemetry as _telemetry

    return _telemetry.active()


def bucket_size(n: int) -> int:
    """Fleet padding bucket: the next power of two >= ``n`` (min 1). A
    fleet change within a bucket keeps the kernels' launch shapes."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


class QuerySpecError(ValueError):
    """A query spec failed schema validation (bad or missing field, family
    mismatch, unservable k or radius)."""


class QueryState(enum.Enum):
    PENDING = "pending"      # admitted, joins the fleet at the next apply()
    ACTIVE = "active"        # serving: owns a slot on the Q axis
    DRAINING = "draining"    # retirement requested; serves until apply()
    RETIRED = "retired"      # left the fleet
    #: admitted while the governor was shedding: parked outside the
    #: apply() pipeline until un-shedding releases it to PENDING
    SHED = "shed"


_FAMILIES = ("range", "knn")
_ROUTE_PREFIXES = ("stdout", "file:", "kafka:")
_LATENCY_CLASSES = ("interactive", "batch")
_SLO_KEYS = ("min_window_records", "max_window_records", "p99_emit_ms")


@dataclass
class QuerySpec:
    """One standing query. ``x``/``y`` are the query point; ``radius``/``k``
    default to the run's and must equal them when given (the fleet shares
    one launch per window); ``route`` names where this query's windows go;
    ``slo`` is an optional verdict over per-window record counts.
    ``latency_class`` (``interactive`` engages the chunk governor's fast
    lane) and ``tenant`` (the accounting principal the quotas key on)
    default to the run's ``--latency-class`` / ``--tenant-default``."""

    id: str
    family: str
    x: float
    y: float
    radius: Optional[float] = None
    k: Optional[int] = None
    route: str = "stdout"
    slo: Optional[Dict[str, float]] = None
    latency_class: str = "batch"
    tenant: str = DEFAULT_TENANT

    def to_dict(self) -> dict:
        d = {"id": self.id, "family": self.family, "x": self.x, "y": self.y,
             "route": self.route}
        if self.radius is not None:
            d["radius"] = self.radius
        if self.k is not None:
            d["k"] = self.k
        if self.slo:
            d["slo"] = dict(self.slo)
        if self.latency_class != "batch":
            d["latency_class"] = self.latency_class
        if self.tenant != DEFAULT_TENANT:
            d["tenant"] = self.tenant
        return d

    @classmethod
    def from_dict(cls, d: Any, *, default_family: Optional[str] = None,
                  default_latency_class: str = "batch",
                  default_tenant: str = DEFAULT_TENANT) -> "QuerySpec":
        """Schema-validated build: every admission path funnels through
        here, so a malformed query is refused with the same named-field
        error everywhere."""
        if not isinstance(d, dict):
            raise QuerySpecError(f"query spec must be an object, got "
                                 f"{type(d).__name__}")
        unknown = set(d) - {"id", "family", "x", "y", "radius", "k",
                            "route", "slo", "latency_class", "tenant"}
        if unknown:
            raise QuerySpecError(f"unknown query field(s) "
                                 f"{sorted(unknown)}")
        qid = d.get("id")
        if not isinstance(qid, str) or not qid or len(qid) > 128:
            raise QuerySpecError("'id' must be a non-empty string "
                                 "(<= 128 chars)")
        family = d.get("family", default_family)
        if family not in _FAMILIES:
            raise QuerySpecError(f"'family' must be one of {_FAMILIES}, "
                                 f"got {family!r}")
        try:
            x, y = float(d["x"]), float(d["y"])
        except (KeyError, TypeError, ValueError):
            raise QuerySpecError("'x' and 'y' must be numeric coordinates")
        radius = d.get("radius")
        if radius is not None:
            try:
                radius = float(radius)
            except (TypeError, ValueError):
                raise QuerySpecError("'radius' must be numeric")
        k = d.get("k")
        if k is not None:
            try:
                k = int(k)
            except (TypeError, ValueError):
                raise QuerySpecError("'k' must be an integer")
        route = d.get("route", "stdout")
        if (not isinstance(route, str)
                or not route.startswith(_ROUTE_PREFIXES)
                or route.startswith(("file:", "kafka:")) and
                len(route.split(":", 1)[1]) == 0):
            raise QuerySpecError(
                "'route' must be 'stdout', 'file:<path>', or "
                f"'kafka:<topic>', got {route!r}")
        slo = d.get("slo")
        if slo is not None:
            if (not isinstance(slo, dict)
                    or not slo
                    or set(slo) - set(_SLO_KEYS)):
                raise QuerySpecError(
                    f"'slo' must be a non-empty object over {_SLO_KEYS}")
            try:
                slo = {sk: float(sv) for sk, sv in slo.items()}
            except (TypeError, ValueError):
                raise QuerySpecError("'slo' thresholds must be numeric")
        lclass = d.get("latency_class", default_latency_class)
        if lclass not in _LATENCY_CLASSES:
            raise QuerySpecError(
                f"'latency_class' must be one of {_LATENCY_CLASSES}, "
                f"got {lclass!r}")
        tenant = d.get("tenant", default_tenant)
        if not isinstance(tenant, str) or not tenant or len(tenant) > 128:
            raise QuerySpecError("'tenant' must be a non-empty string "
                                 "(<= 128 chars)")
        return cls(id=qid, family=family, x=x, y=y, radius=radius, k=k,
                   route=route, slo=slo, latency_class=lclass,
                   tenant=tenant)


@dataclass
class QueryEntry:
    """One query's lifecycle record inside the registry."""

    spec: QuerySpec
    state: QueryState = QueryState.PENDING
    #: spec staged by update(); swapped in at the next apply()
    pending_spec: Optional[QuerySpec] = field(default=None, repr=False)
    admitted_ms: int = 0
    retired_ms: Optional[int] = None
    #: fleet_version at which the entry last joined or changed
    since_version: int = 0
    #: per-query SLO verdict over per-window record counts
    slo_ok: Optional[bool] = None
    slo_breaches: int = 0

    @property
    def id(self) -> str:
        return self.spec.id

    @property
    def serving(self) -> bool:
        """In the fleet now (a draining query serves until the next
        apply)."""
        return self.state in (QueryState.ACTIVE, QueryState.DRAINING)

    def to_dict(self) -> dict:
        reg = _metrics.REGISTRY
        d = {"id": self.id, "state": self.state.value,
             "spec": self.spec.to_dict(),
             "tenant": self.spec.tenant,
             "admitted_ms": self.admitted_ms,
             "since_version": self.since_version,
             "windows_emitted":
                 reg.counter(f"windows-emitted@{self.id}").count,
             "records_out": reg.counter(f"records-out@{self.id}").count}
        if self.retired_ms is not None:
            d["retired_ms"] = self.retired_ms
        if self.spec.slo:
            d["slo"] = {"ok": self.slo_ok, "breaches": self.slo_breaches}
        return d


class QueryRegistry:
    """The run's standing-query fleet: lifecycle, the Q-axis padding
    contract and the apply-at-window-boundary discipline.

    ``family``/``radius``/``k`` are the run's: the fleet shares one launch
    per window, hence one family, one radius and one k (a spec may omit
    them or restate them exactly; anything else is refused at
    admission)."""

    def __init__(self, family: str, *, radius: float = 0.0,
                 k: Optional[int] = None, retain_retired: int = 64,
                 default_latency_class: str = "batch",
                 default_tenant: str = DEFAULT_TENANT,
                 tenant_quotas: Optional[Dict[str, dict]] = None):
        if family not in _FAMILIES:
            raise ValueError(f"family must be one of {_FAMILIES}")
        if default_latency_class not in _LATENCY_CLASSES:
            raise ValueError(
                f"default_latency_class must be one of {_LATENCY_CLASSES}")
        self.family = family
        self.radius = float(radius)
        self.k = k
        self.default_latency_class = default_latency_class
        self.default_tenant = str(default_tenant or DEFAULT_TENANT)
        #: per-tenant admission ceilings (``--tenant-quota``), checked at
        #: admit(); distinct from the governor's shedding
        self.tenant_quotas: Dict[str, dict] = dict(tenant_quotas or {})
        #: the governor's admission shedding: while True, new admissions
        #: park in QueryState.SHED
        self.shedding = False
        self._lock = threading.RLock()
        self._entries: Dict[str, QueryEntry] = {}
        #: ACTIVE/DRAINING ids in slot (admission) order: the Q axis
        self._fleet: List[str] = []
        self._version = 0
        self._dirty = False
        self._retired: List[str] = []
        self._retain_retired = retain_retired
        self._control: Optional["ControlTopicConsumer"] = None
        #: a checkpoint-restored control position, applied when the
        #: consumer attaches
        self._restored_control_pos: Optional[int] = None
        self.repads = _metrics.REGISTRY.counter("fleet-repads")

    # ------------------------------ admission ------------------------- #

    def _validate(self, spec: QuerySpec) -> QuerySpec:
        if spec.family != self.family:
            raise QuerySpecError(
                f"query {spec.id!r}: family {spec.family!r} does not match "
                f"this run's pipeline family {self.family!r} (one pipeline "
                "serves one family; run a second driver for the other)")
        if spec.radius is not None and spec.radius != self.radius:
            raise QuerySpecError(
                f"query {spec.id!r}: radius {spec.radius} != the fleet "
                f"radius {self.radius} (the Q-axis shares one candidate-"
                "layer geometry; omit 'radius' to inherit it)")
        if self.family == "knn" and spec.k is not None and spec.k != self.k:
            raise QuerySpecError(
                f"query {spec.id!r}: k={spec.k} != the fleet k={self.k} "
                "(the Q-axis shares one top-k width; omit 'k' to inherit)")
        return spec

    def _check_quota_locked(self, spec: QuerySpec) -> None:
        """The tenant's ``--tenant-quota`` ceilings on a NEW admission (the
        caller holds the lock): its held slots over the live states and,
        with a telemetry session, the ledger's recent attributed kernel-ms
        rate. Raises :class:`QuotaExceeded`."""
        quota = self.tenant_quotas.get(spec.tenant)
        if not quota:
            return
        reason = None
        max_active = quota.get("max_active")
        if max_active is not None:
            held = sum(
                1 for e in self._entries.values()
                if e.spec.tenant == spec.tenant
                and e.state in (QueryState.PENDING, QueryState.ACTIVE,
                                QueryState.DRAINING, QueryState.SHED))
            if held >= int(max_active):
                reason = (f"max_active {int(max_active)} reached "
                          f"({held} queries held)")
        rate_cap = quota.get("kernel_ms_s")
        tel = _telemetry_active()
        if reason is None and rate_cap is not None and tel is not None:
            rate = tel.tenants.kernel_ms_rate(spec.tenant)
            if rate > float(rate_cap):
                reason = (f"kernel_ms_s {float(rate_cap):g} exceeded "
                          f"(attributed {rate:.1f} ms/s)")
        if reason is None:
            return
        _metrics.REGISTRY.counter("queries-quota-rejected").inc()
        _emit("query-quota-rejected", id=spec.id, tenant=spec.tenant,
              reason=reason)
        if tel is not None:
            tel.tenants.note_quota_rejection(spec.tenant)
        raise QuotaExceeded(spec.tenant, reason)

    def admit(self, spec) -> QueryEntry:
        """Admit a new standing query (PENDING until the next apply), or,
        when the id names a live query, stage an UPDATE of it. While
        :attr:`shedding`, a NEW query lands in the ``shed`` state instead
        (updates of live queries still stage). A tenant over its quota
        raises :class:`QuotaExceeded` and no entry is made. Callable from
        any thread."""
        if not isinstance(spec, QuerySpec):
            spec = QuerySpec.from_dict(
                spec, default_family=self.family,
                default_latency_class=self.default_latency_class,
                default_tenant=self.default_tenant)
        self._validate(spec)
        with self._lock:
            cur = self._entries.get(spec.id)
            if cur is not None and cur.state is QueryState.SHED:
                cur.spec = spec  # re-admission while shed: refresh in place
                return cur
            if cur is not None and cur.state is not QueryState.RETIRED:
                return self._stage_update(cur, spec)
            # a new admission: the tenant's ceiling applies before a slot
            # is taken (a quota refusal makes no entry; shed parks one)
            self._check_quota_locked(spec)
            shed = self.shedding
            entry = QueryEntry(
                spec=spec,
                state=QueryState.SHED if shed else QueryState.PENDING,
                admitted_ms=int(time.time() * 1000))
            self._entries[spec.id] = entry
            if not shed:
                self._dirty = True
        if shed:
            _metrics.REGISTRY.counter("queries-shed").inc()
            _emit("query-shed", id=spec.id, route=spec.route)
            tel = _telemetry_active()
            if tel is not None:
                tel.tenants.note_shed(spec.tenant)
            return entry
        _metrics.REGISTRY.counter("queries-admitted").inc()
        _emit("query-admitted", id=spec.id, route=spec.route)
        return entry

    def update(self, qid: str, changes: dict) -> QueryEntry:
        """Stage an update of a live query (the new spec lands at the next
        apply)."""
        with self._lock:
            entry = self._entries.get(qid)
            if entry is None or entry.state is QueryState.RETIRED:
                raise KeyError(qid)
            merged = entry.spec.to_dict()
            merged.update(changes or {})
            merged["id"] = qid
            spec = self._validate(QuerySpec.from_dict(
                merged, default_family=self.family,
                default_latency_class=self.default_latency_class,
                default_tenant=entry.spec.tenant))
            if entry.state is QueryState.SHED:
                entry.spec = spec  # parked: nothing staged to swap
                return entry
            return self._stage_update(entry, spec)

    def _stage_update(self, entry: QueryEntry, spec: QuerySpec
                      ) -> QueryEntry:
        with self._lock:
            entry.pending_spec = spec
            self._dirty = True
        _metrics.REGISTRY.counter("queries-updated").inc()
        _emit("query-updated", id=entry.id)
        return entry

    def retire(self, qid: str) -> QueryEntry:
        """Request retirement: an ACTIVE query turns DRAINING (it serves
        until the next apply); a still-PENDING or parked query retires at
        once."""
        with self._lock:
            entry = self._entries.get(qid)
            if entry is None or entry.state is QueryState.RETIRED:
                raise KeyError(qid)
            if entry.state in (QueryState.PENDING, QueryState.SHED):
                self._retire_now(entry)
            elif entry.state is QueryState.ACTIVE:
                entry.state = QueryState.DRAINING
                self._dirty = True
                _emit("query-draining", id=qid)
        _metrics.REGISTRY.counter("queries-retired").inc()
        return entry

    def _retire_now(self, entry: QueryEntry) -> None:
        entry.state = QueryState.RETIRED
        entry.retired_ms = int(time.time() * 1000)
        entry.pending_spec = None
        self._retired.append(entry.id)
        _emit("query-retired", id=entry.id)
        # bound the retired ledger (ids stay queryable for a while)
        while len(self._retired) > self._retain_retired:
            dead = self._retired.pop(0)
            self._entries.pop(dead, None)

    # ------------------------------ the fleet ------------------------- #

    @property
    def fleet_version(self) -> int:
        """Monotonic stamp of the active fleet's composition."""
        return self._version

    def apply(self) -> bool:
        """The one place fleet changes land, called by the dynamic drive
        loop once per window: pending -> active, draining -> retired, and
        staged updates swapped in. True when the fleet changed
        (``fleet_version`` bumped). The control topic, when attached, is
        drained first."""
        if self._control is not None:
            self._control.poll(self)
        with self._lock:
            if not self._dirty:
                return False
            changed = False
            for entry in list(self._entries.values()):
                if entry.state is QueryState.PENDING:
                    entry.state = QueryState.ACTIVE
                    entry.since_version = self._version + 1
                    self._fleet.append(entry.id)
                    changed = True
                    _emit("query-active", id=entry.id)
                elif entry.state is QueryState.DRAINING:
                    self._fleet.remove(entry.id)
                    self._retire_now(entry)
                    changed = True
                elif (entry.state is QueryState.ACTIVE
                        and entry.pending_spec is not None):
                    entry.spec = entry.pending_spec
                    entry.pending_spec = None
                    entry.since_version = self._version + 1
                    changed = True
            self._dirty = False
            if changed:
                self._version += 1
                self.repads.inc()
            return changed

    def active_entries(self) -> List[QueryEntry]:
        """The serving fleet in slot order (ACTIVE and DRAINING)."""
        with self._lock:
            return [self._entries[q] for q in self._fleet]

    def has_interactive(self) -> bool:
        """Any serving query of ``latency_class: interactive``: the chunk
        governor's fast-lane signal (read once per tick)."""
        with self._lock:
            return any(
                self._entries[q].spec.latency_class == "interactive"
                for q in self._fleet)

    def set_shedding(self, shedding: bool) -> bool:
        """Set admission shedding (the governor's stall verdict). Lifting
        it releases every parked ``shed`` entry to PENDING (they join the
        fleet at the next apply). True when the flag changed."""
        shedding = bool(shedding)
        released = []
        with self._lock:
            if shedding == self.shedding:
                return False
            self.shedding = shedding
            if not shedding:
                for entry in self._entries.values():
                    if entry.state is QueryState.SHED:
                        entry.state = QueryState.PENDING
                        released.append(entry.id)
                if released:
                    self._dirty = True
        for qid in released:
            _metrics.REGISTRY.counter("queries-admitted").inc()
            _emit("query-admitted", id=qid, released_from_shed=True)
        return True

    def staged_count(self) -> int:
        """Fleet changes staged but not landed yet (PENDING admissions,
        DRAINING retirements, staged updates)."""
        with self._lock:
            return sum(
                1 for e in self._entries.values()
                if e.state in (QueryState.PENDING, QueryState.DRAINING)
                or (e.state is QueryState.ACTIVE
                    and e.pending_spec is not None))

    def padded_fleet(self, grid) -> Tuple[List[QueryEntry], list,
                                          np.ndarray]:
        """``(entries, padded_query_points, valid)`` for the Q axis: the
        live fleet's query Points padded to :func:`bucket_size` with copies
        of the last live point; ``valid`` is the (B,) bool gate the
        evaluators AND into the masks and the pruning counters."""
        from spatialflink_tpu_torch.models import Point

        entries = self.active_entries()
        pts = [Point.create(e.spec.x, e.spec.y, grid) for e in entries]
        b = bucket_size(len(pts))
        valid = np.zeros(b, bool)
        valid[:len(pts)] = True
        while pts and len(pts) < b:
            pts.append(pts[-1])
        return entries, pts, valid

    def attach_control(self, consumer: "ControlTopicConsumer") -> None:
        """Wire the control-topic consumer (drained inside :meth:`apply`);
        a checkpoint-restored position seeks it first, so a resumed run
        does not apply again what the restored fleet reflects."""
        with self._lock:
            if self._restored_control_pos is not None:
                consumer.seek(self._restored_control_pos)
                self._restored_control_pos = None
            self._control = consumer

    # ------------------------------ checkpoint ------------------------ #

    def register_checkpoint(self, coordinator) -> bool:
        """Register as the checkpoint component ``queries``; True when a
        loaded manifest restored a fleet (the caller then seeds none)."""
        return coordinator.register(
            "queries", lambda: ({}, self.snapshot()),
            lambda _arrays, meta: self.restore(meta))

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "fleet_version": self._version,
                "shedding": self.shedding,
                "default_tenant": self.default_tenant,
                "tenant_quotas": {t: dict(q)
                                  for t, q in self.tenant_quotas.items()},
                "fleet": list(self._fleet),
                "entries": [
                    {"spec": e.spec.to_dict(), "state": e.state.value,
                     "pending_spec": (e.pending_spec.to_dict()
                                      if e.pending_spec else None),
                     "admitted_ms": e.admitted_ms,
                     "since_version": e.since_version}
                    for e in self._entries.values()
                    if e.state is not QueryState.RETIRED],
                "control_pos":
                    None if self._control is None else self._control.position,
            }

    def restore(self, meta: dict) -> None:
        """Rebuild the live fleet (mid-drain entries, staged updates,
        parked entries, the shed state and the quotas too) from the
        checkpoint component."""
        with self._lock:
            self._entries = {}
            self.shedding = bool(meta.get("shedding", False))
            self.default_tenant = str(meta.get("default_tenant")
                                      or self.default_tenant)
            if meta.get("tenant_quotas") is not None:
                self.tenant_quotas = {
                    str(t): dict(q or {})
                    for t, q in meta["tenant_quotas"].items()}
            for row in meta.get("entries", []):
                spec = QuerySpec.from_dict(
                    row["spec"], default_family=self.family,
                    default_latency_class=self.default_latency_class,
                    default_tenant=self.default_tenant)
                entry = QueryEntry(
                    spec=spec, state=QueryState(row["state"]),
                    admitted_ms=int(row.get("admitted_ms", 0)),
                    since_version=int(row.get("since_version", 0)))
                if row.get("pending_spec"):
                    entry.pending_spec = QuerySpec.from_dict(
                        row["pending_spec"], default_family=self.family,
                        default_latency_class=self.default_latency_class,
                        default_tenant=self.default_tenant)
                self._entries[entry.id] = entry
            self._fleet = [q for q in meta.get("fleet", [])
                           if q in self._entries]
            self._version = int(meta.get("fleet_version", 0))
            # admissions and drains staged before the checkpoint still
            # need an apply
            self._dirty = any(
                e.state in (QueryState.PENDING, QueryState.DRAINING)
                or e.pending_spec is not None
                for e in self._entries.values())
            pos = meta.get("control_pos")
            if pos is not None:
                if self._control is not None:
                    self._control.seek(int(pos))
                else:
                    self._restored_control_pos = int(pos)
        _metrics.REGISTRY.counter("queries-restored").inc(len(self._entries))

    def install(self) -> "QueryRegistry":
        global _ACTIVE
        _ACTIVE = self
        return self

    def uninstall(self) -> None:
        global _ACTIVE
        if _ACTIVE is self:
            _ACTIVE = None

    def note_window(self, entry: QueryEntry, n_records: int,
                    emit_p99_ms: Optional[float] = None) -> None:
        """Per-query accounting for one demultiplexed window: the registry
        counters, with a session the ``window-records@<id>`` histogram and
        the tenant ledger, and the SLO verdict (counted on transitions).
        ``emit_p99_ms`` is the query's record→emit p99 from the latency
        plane; None (no session, no ingest stamps yet) counts healthy."""
        from spatialflink_tpu_torch.utils import telemetry as _telemetry

        qid = entry.id
        _metrics.REGISTRY.counter(f"windows-emitted@{qid}").inc()
        _metrics.REGISTRY.counter(f"records-out@{qid}").inc(n_records)
        tel = _telemetry.active()
        if tel is not None:
            tel.histogram(f"window-records@{qid}").record(n_records)
            tel.tenants.note_window(entry.spec.tenant, qid, n_records)
        slo = entry.spec.slo
        if not slo:
            return
        ok = True
        if "min_window_records" in slo and \
                n_records < slo["min_window_records"]:
            ok = False
        if "max_window_records" in slo and \
                n_records > slo["max_window_records"]:
            ok = False
        if "p99_emit_ms" in slo and emit_p99_ms is not None \
                and emit_p99_ms > slo["p99_emit_ms"]:
            ok = False
        if ok is not entry.slo_ok:
            if not ok:
                entry.slo_breaches += 1
                _metrics.REGISTRY.counter("query-slo-breaches").inc()
                _emit("query-slo-breach", id=qid, records=n_records)
                if tel is not None:
                    tel.tenants.note_breach(entry.spec.tenant)
                self._recorder_breach(entry, n_records, emit_p99_ms)
            elif entry.slo_ok is False:
                _emit("query-slo-recovered", id=qid)
            entry.slo_ok = ok

    @staticmethod
    def _recorder_breach(entry: QueryEntry, n_records: int,
                         emit_p99_ms: Optional[float]) -> None:
        """A per-query breach transition dumps one flight-recorder bundle
        per query id per run (nothing without a recorder)."""
        from spatialflink_tpu_torch.utils.deviceplane import active_recorder

        rec = active_recorder()
        if rec is None:
            return
        qid = entry.id
        detail = {"query": qid, "records": n_records,
                  "latency_class": entry.spec.latency_class,
                  "p99_emit_ms": emit_p99_ms,
                  "slo": dict(entry.spec.slo or {})}
        rec.note("query-slo-breach", **detail)
        rec.dump_once(f"query-slo-{qid}", "query-slo-breach", detail=detail)

    def status(self) -> dict:
        """The ``GET /queries`` payload: the ledger (live and recently
        retired), composition, version, padding bucket, shed state,
        quotas and the control topic's position."""
        with self._lock:
            entries = [e.to_dict() for e in self._entries.values()]
            fleet = list(self._fleet)
        live = len(fleet)
        return {"family": self.family, "radius": self.radius, "k": self.k,
                "fleet_version": self._version,
                "fleet": fleet, "live": live,
                "bucket": bucket_size(live),
                "shedding": self.shedding,
                "default_tenant": self.default_tenant,
                "tenant_quotas": {t: dict(q)
                                  for t, q in self.tenant_quotas.items()},
                "queries": entries,
                "control_position":
                    None if self._control is None else self._control.position}


class ControlTopicConsumer:
    """Admissions from a Kafka control topic, interleaved with the data
    plane. Records are JSON objects::

        {"action": "admit",  "query": {"id": "q9", "x": ..., "y": ...}}
        {"action": "update", "id": "q9", "query": {"route": "kafka:out9"}}
        {"action": "retire", "id": "q9"}

    :meth:`poll` (inside :meth:`QueryRegistry.apply`, at window
    boundaries) applies every record past ``position``; a malformed or
    rejected record (a quota refusal too) is counted (``rejected``, the
    ``control-records-rejected`` counter, a ``control-record-rejected``
    event) and warned about, never fatal to the queries already
    serving. The position commits to the
    group ``<group>-control`` after each poll that applied something, and
    rides the ``queries`` checkpoint component."""

    def __init__(self, broker, topic: str, group: str = "spatialflink"):
        self.broker = broker
        self.topic = topic
        self.group = group + "-control"
        self.position = int(broker.committed(topic, self.group))
        self.applied = 0
        self.rejected = 0

    def seek(self, position: int) -> None:
        self.position = int(position)

    def poll(self, registry: QueryRegistry) -> int:
        """Apply every control record past ``position``; the number
        applied. A fetch error leaves the position for the next poll."""
        n = 0
        while True:
            try:
                batch = self.broker.fetch(self.topic, self.position, 256)
            except Exception as e:  # the control plane never stalls data
                _metrics.REGISTRY.counter("control-fetch-errors").inc()
                _emit("control-fetch-error", error=str(e)[:200])
                print(f"warning: control topic {self.topic!r}: fetch "
                      f"failed ({str(e)[:200]})", file=sys.stderr)
                return n
            if not batch:
                break
            for rec in batch:
                self.position = rec.offset + 1
                n += self._apply_one(registry, rec.value)
        if n:
            self.broker.commit(self.topic, self.group, self.position)
            self.applied += n
        return n

    def _apply_one(self, registry: QueryRegistry, value) -> int:
        try:
            d = json.loads(value) if isinstance(value, (str, bytes)) else value
            if not isinstance(d, dict):
                raise QuerySpecError("control record must be a JSON object")
            action = d.get("action")
            if action == "admit":
                registry.admit(d.get("query"))
            elif action == "update":
                qid = d.get("id") or (d.get("query") or {}).get("id")
                if not qid:
                    raise QuerySpecError("'update' needs an 'id'")
                registry.update(qid, d.get("query") or {})
            elif action == "retire":
                if not d.get("id"):
                    raise QuerySpecError("'retire' needs an 'id'")
                registry.retire(d["id"])
            else:
                raise QuerySpecError(
                    f"'action' must be admit/update/retire, got {action!r}")
            return 1
        except KeyError as e:
            self._reject(f"unknown query id {e}", value)
        except (QuerySpecError, QuotaExceeded, json.JSONDecodeError,
                UnicodeDecodeError) as e:
            self._reject(str(e), value)
        return 0

    def _reject(self, reason: str, value) -> None:
        self.rejected += 1
        _metrics.REGISTRY.counter("control-records-rejected").inc()
        _emit("control-record-rejected", reason=reason[:200])
        print(f"warning: control topic {self.topic!r}: rejected record "
              f"({reason}): {str(value)[:120]}", file=sys.stderr)


class QueryRouter:
    """Demultiplex one dynamic window's per-query record lists to each
    query's route: ``stdout`` queries ride the driver's own emission (the
    router only keeps the SLO verdict); ``file:<path>`` appends one JSON
    line per (window, query), and ``kafka:<topic>`` produces the same
    document to the topic through ``broker``. Files open on first use and
    are shared by the queries that name them."""

    def __init__(self, registry: QueryRegistry, broker=None):
        self.registry = registry
        self.broker = broker
        self._files: Dict[str, Any] = {}
        self.routed = _metrics.REGISTRY.counter("query-windows-routed")

    @staticmethod
    def _doc(qid: str, result, recs) -> str:
        from spatialflink_tpu_torch.models import SpatialObject
        from spatialflink_tpu_torch.streams.formats import serialize_spatial

        out = []
        for r in recs:
            if isinstance(r, SpatialObject):
                out.append(serialize_spatial(r, "GeoJSON"))
            elif isinstance(r, tuple):  # kNN (objID, distance)
                out.append([r[0], float(r[1])])
            else:
                out.append(str(r))
        return json.dumps({
            "query": qid,
            "window": [result.window_start, result.window_end],
            "count": len(recs), "records": out}, sort_keys=True)

    def route(self, result) -> None:
        """Account and fan out one WindowResult carrying
        ``extras['query_ids']``. This demultiplexing point is where every
        route passes, so with a session it is also where per-query latency
        is observed: the window's record→emit on ``record-emit-ms@<id>``
        (its first ingest stamp from the latency plane's completed-window
        ring) and each routed record's ``now - ingestion_time`` on
        ``record-latency-ms``."""
        from spatialflink_tpu_torch.utils import telemetry as _telemetry

        ids = result.extras.get("query_ids") or []
        entries = {e.id: e for e in self.registry.active_entries()}
        tel = _telemetry.active()
        rec_hist = (tel.histogram("record-latency-ms")
                    if tel is not None else None)
        now_s = time.time() if tel is not None else 0.0
        for qid, recs in zip(ids, result.records):
            entry = entries.get(qid)
            if entry is None:
                continue  # retired between dispatch and readback
            emit_p99 = None
            if tel is not None:
                tel.latency.query_emit(qid, result.window_start, now_s)
                emit_p99 = tel.latency.query_p99(qid)
                if len(recs):
                    _record_latencies(rec_hist, recs, now_s * 1e3)
            self.registry.note_window(entry, len(recs), emit_p99_ms=emit_p99)
            route = entry.spec.route
            if route == "stdout":
                continue  # the driver's own sinks carry it
            self.routed.inc()
            doc = self._doc(qid, result, recs)
            if route.startswith("file:"):
                path = route[5:]
                f = self._files.get(path)
                if f is None:
                    f = self._files[path] = open(path, "a")
                f.write(doc + "\n")
                f.flush()
            elif route.startswith("kafka:") and self.broker is not None:
                self.broker.produce(route[6:], doc)

    def close(self) -> None:
        for f in self._files.values():
            try:
                f.close()
            except OSError:
                pass
        self._files.clear()


def _record_latencies(hist, recs, now_ms: float) -> None:
    """``now - ingestion_time`` of each routed record onto ``hist``: the
    columns' ingest stamps of selected point rows, else each record's
    ``ingestion_time``."""
    cols = getattr(recs, "columns", None)
    if cols is not None:
        for base in cols()[5].tolist():
            if base > 0:
                hist.record(now_ms - base)
        return
    for rec in recs:
        obj = rec[0] if isinstance(rec, tuple) else rec
        base = getattr(obj, "ingestion_time", None)
        if isinstance(base, (int, float)) and base > 0:
            hist.record(now_ms - base)


def load_queries_file(path: str, family: str,
                      default_latency_class: str = "batch",
                      default_tenant: str = DEFAULT_TENANT
                      ) -> List[QuerySpec]:
    """Parse a ``--queries-file``: a JSON array of query specs, or an
    object ``{"queries": [...]}``. Validation errors name the entry."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = data.get("queries", [])
    if not isinstance(data, list):
        raise QuerySpecError(f"{path}: expected a JSON array of query "
                             "specs (or {'queries': [...]})")
    out = []
    for i, d in enumerate(data):
        try:
            out.append(QuerySpec.from_dict(
                d, default_family=family,
                default_latency_class=default_latency_class,
                default_tenant=default_tenant))
        except QuerySpecError as e:
            raise QuerySpecError(f"{path}: query[{i}]: {e}")
    return out
