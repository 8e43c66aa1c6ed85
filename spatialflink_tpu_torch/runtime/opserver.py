"""The operations plane (port of ``spatialflink_tpu.runtime.opserver``):
the status server and the ``--live-stats`` digest, stdlib only.

- :class:`OpServer`: a threaded HTTP server (``--status-port``; 0 binds
  an ephemeral port, which the driver prints) serving

  =============== ====================================================
  endpoint         payload
  =============== ====================================================
  /healthz         the SLO verdict, ``200`` healthy / ``503`` breached
  /status          the shared status snapshot (one JSON document)
  /metrics         Prometheus text, rendered per request
  /events          the lifecycle event ring; ``?since=<seq>`` returns
                   only newer events
  /trace/recent    the newest window traces' summaries
  /trace/<id>      one window's trace lineage (``--trace-dir``)
  /profile/cells   per-cell / per-family cost profiles and their series
  /latency         the stage-residency decomposition, record→emit
                   (global and per query), the backpressure series and
                   the chunk governor's ``controller`` block
  /partition       the adaptive grid's layout and epochs
  /queries         GET: the standing-query ledger; POST: admit or update
                   a query (a JSON body, applied at the next window
                   boundary)
  /queries/<id>    GET: one query's record; DELETE: drain it
  /tenants         the per-tenant cost ledger and its fairness summary
  /tenants/<id>    one tenant's row and series
  /device          provenance, card memory, transfers, compile summary,
                   the flight recorder's state
  /compile         the compile registry (kernel libraries and entry
                   signatures)
  /fleet, /fleet/* the single-process note (no fleet in this process)
  =============== ====================================================

  A known route hit with another method answers a JSON ``405`` with an
  ``Allow:`` header; an unknown path is ``404`` whatever the method.
  ``POST /queries`` answers 400 for a bad spec, 429 ``quota-exceeded``
  for a tenant over its quota (no entry made), 429 for an admission
  parked by shedding, and 409 when the run has no query registry.

- :class:`LiveStats`: a daemon thread printing a one-line stderr digest
  per interval (``--live-stats``).

Both render :func:`~spatialflink_tpu_torch.utils.telemetry.
status_snapshot`, the document the telemetry reporter writes, and build
it only per request or per interval, never per record. Without a
telemetry session the server serves the always-on registry counters and
``/healthz`` evaluates the checks that have data. Handler threads read
the registry, the governor and the ledger under their locks.
"""

from __future__ import annotations

import json
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, unquote

from spatialflink_tpu_torch.utils import telemetry as _telemetry

#: the server the process runs (the driver starts at most one): how
#: in-process tooling and tests find the ephemeral port
_ACTIVE_SERVER: Optional["OpServer"] = None


def active_server() -> Optional["OpServer"]:
    """The process's running :class:`OpServer`, or None."""
    return _ACTIVE_SERVER


#: known routes -> the methods they answer; prefix routes (one level of
#: <id>) below. Anything else is 404; another method on a known route is
#: a JSON 405 with an ``Allow:`` header.
_ROUTES = {
    "/healthz": ("GET",), "/status": ("GET",), "/metrics": ("GET",),
    "/events": ("GET",), "/trace/recent": ("GET",),
    "/profile/cells": ("GET",), "/partition": ("GET",),
    "/queries": ("GET", "POST"),
    "/tenants": ("GET",),
    "/device": ("GET",), "/compile": ("GET",), "/latency": ("GET",),
    "/fleet": ("GET",), "/fleet/latency": ("GET",),
    "/fleet/timeline": ("GET",), "/fleet/events": ("GET",),
    "/fleet/metrics": ("GET",), "/fleet/tenants": ("GET",),
}
_PREFIX_ROUTES = {"/trace/": ("GET",), "/queries/": ("GET", "DELETE"),
                  "/tenants/": ("GET",)}

_ENDPOINTS = ["/healthz", "/status", "/metrics", "/events", "/trace/recent",
              "/trace/<id>", "/profile/cells", "/partition", "/queries",
              "/queries/<id>", "/tenants", "/tenants/<id>", "/device",
              "/compile", "/latency", "/fleet",
              "/fleet/latency", "/fleet/timeline", "/fleet/events",
              "/fleet/metrics", "/fleet/tenants"]


def _allowed_methods(path: str):
    """The methods a path answers, or None for an unknown path."""
    m = _ROUTES.get(path)
    if m is not None:
        return m
    for prefix, pm in _PREFIX_ROUTES.items():
        if path.startswith(prefix) and len(path) > len(prefix):
            return pm
    return None


def _since(query: str):
    """``?since=<seq>`` as (int or None, None), or (None, error)."""
    raw = parse_qs(query).get("since", [None])[0]
    try:
        return (None if raw is None else int(raw)), None
    except ValueError:
        return None, {"error": f"?since must be an integer event seq, "
                               f"got {raw!r}"}


class _Handler(BaseHTTPRequestHandler):
    server_version = "spatialflink-opserver/1"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet: stderr is the digest's
        pass

    def _send(self, code: int, body: bytes, ctype: str,
              headers: Optional[dict] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        # one response per connection: a kept-alive handler would outlive
        # close() (shutdown() stops only the listener)
        self.send_header("Connection", "close")
        self.close_connection = True
        self.end_headers()
        if self.command != "HEAD":  # HEAD: headers only
            self.wfile.write(body)

    def _send_json(self, code: int, payload: dict,
                   headers: Optional[dict] = None) -> None:
        self._send(code, json.dumps(payload, sort_keys=True).encode(),
                   "application/json", headers)

    def _read_body(self):
        """The request body parsed as JSON, or (None, error payload)."""
        try:
            length = int(self.headers.get("Content-Length") or 0)
        except ValueError:
            length = 0
        if length <= 0:
            return None, {"error": "a JSON body is required "
                                   "(send Content-Length)"}
        if length > 1 << 20:
            return None, {"error": "body too large (1 MiB max)"}
        raw = self.rfile.read(length)
        try:
            return json.loads(raw), None
        except (json.JSONDecodeError, UnicodeDecodeError) as e:
            return None, {"error": f"invalid JSON body: {e}"}

    def _dispatch(self, method: str) -> None:
        srv: "OpServer" = self.server.opserver  # type: ignore[attr-defined]
        srv.note_request()
        path, _, query = self.path.partition("?")
        path = path.rstrip("/") or "/"
        try:
            allowed = _allowed_methods(path)
            if allowed is None:
                self._send_json(404, {"error": f"unknown path {path!r}",
                                      "endpoints": _ENDPOINTS})
                return
            if method not in allowed:
                self._send_json(
                    405, {"error": f"method {method} not allowed for "
                                   f"{path!r}", "allow": list(allowed)},
                    headers={"Allow": ", ".join(allowed)})
                return
            self._route(srv, method, path, query)
        except (BrokenPipeError, ConnectionResetError):
            pass  # the client went away mid-write
        except Exception as e:
            # a payload fault answers 500 for the one request
            try:
                self._send_json(500, {"error": repr(e)})
            except Exception:
                pass

    def _route(self, srv: "OpServer", method: str, path: str,
               query: str) -> None:
        if path == "/healthz":
            code, payload = srv.healthz_payload()
            self._send_json(code, payload)
        elif path == "/status":
            self._send_json(200, srv.status_payload())
        elif path == "/metrics":
            self._send(200, srv.metrics_text().encode(),
                       "text/plain; version=0.0.4")
        elif path in ("/events", "/fleet/events"):
            since, err = _since(query)
            if err is not None:
                self._send_json(400, err)
            elif path == "/events":
                self._send_json(200, srv.events_payload(since))
            else:
                self._send_json(200, srv.fleet_events_payload(since))
        elif path == "/trace/recent":
            self._send_json(200, srv.traces_payload())
        elif path.startswith("/trace/"):
            code, payload = srv.trace_payload(
                unquote(path[len("/trace/"):]))
            self._send_json(code, payload)
        elif path == "/profile/cells":
            self._send_json(200, srv.profile_cells_payload())
        elif path == "/latency":
            self._send_json(200, srv.latency_payload())
        elif path == "/partition":
            self._send_json(200, srv.partition_payload())
        elif path == "/fleet":
            self._send_json(200, srv.fleet_payload())
        elif path == "/fleet/latency":
            self._send_json(200, srv.fleet_latency_payload())
        elif path == "/fleet/timeline":
            self._send_json(200, srv.fleet_timeline_payload())
        elif path == "/fleet/metrics":
            self._send(200, srv.fleet_metrics_text().encode(),
                       "text/plain; version=0.0.4")
        elif path == "/fleet/tenants":
            self._send_json(200, srv.fleet_tenants_payload())
        elif path == "/device":
            self._send_json(200, srv.device_payload())
        elif path == "/compile":
            cost_raw = parse_qs(query).get("cost", ["0"])[0]
            self._send_json(200, srv.compile_payload(
                with_cost=cost_raw not in ("0", "", "false")))
        elif path == "/queries" and method == "GET":
            self._send_json(200, srv.queries_payload())
        elif path == "/queries" and method == "POST":
            body, err = self._read_body()
            if err is not None:
                self._send_json(400, err)
                return
            code, payload = srv.admit_query_payload(body)
            self._send_json(code, payload)
        elif path.startswith("/queries/"):
            qid = unquote(path[len("/queries/"):])
            if method == "DELETE":
                code, payload = srv.retire_query_payload(qid)
            else:
                code, payload = srv.query_payload(qid)
            self._send_json(code, payload)
        elif path == "/tenants":
            self._send_json(200, srv.tenants_payload())
        elif path.startswith("/tenants/"):
            code, payload = srv.tenant_payload(
                unquote(path[len("/tenants/"):]))
            self._send_json(code, payload)
        else:  # unreachable while _ROUTES and this dispatch agree
            self._send_json(404, {"error": f"unknown path {path!r}",
                                  "endpoints": _ENDPOINTS})

    # http.server calls do_<METHOD>; every verb goes through _dispatch
    def do_GET(self) -> None:  # noqa: N802 (http.server API)
        self._dispatch("GET")

    def do_POST(self) -> None:  # noqa: N802
        self._dispatch("POST")

    def do_DELETE(self) -> None:  # noqa: N802
        self._dispatch("DELETE")

    def do_PUT(self) -> None:  # noqa: N802
        self._dispatch("PUT")

    def do_PATCH(self) -> None:  # noqa: N802
        self._dispatch("PATCH")

    def do_HEAD(self) -> None:  # noqa: N802
        self._dispatch("HEAD")


class OpServer:
    """Threaded in-run status server. ``port=0`` binds an ephemeral port
    (read it back from :attr:`port`); it binds loopback by default. Every
    endpoint renders a fresh document from the active telemetry session
    (or the registry alone) per request, so a server nobody asks costs the
    pipeline nothing. A failed bind raises from :meth:`start`."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 telemetry=None, health=None, registry=None):
        self._requested_port = int(port)
        self.host = host
        #: a pinned session; None reads the active session per request
        self.telemetry = telemetry
        #: the SLO evaluator for /healthz when no session carries one
        self.health = health
        self.registry = registry
        self.port: Optional[int] = None
        self.requests_served = 0
        self._lock = threading.Lock()
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None

    def note_request(self) -> None:
        with self._lock:
            self.requests_served += 1

    # ------------------------- endpoint payloads ----------------------- #
    # (public: tests and in-process tools call them without HTTP)

    def _tel(self):
        return (self.telemetry if self.telemetry is not None
                else _telemetry.active())

    def status_payload(self) -> dict:
        return _telemetry.status_snapshot(self.telemetry, health=self.health,
                                          registry=self.registry)

    def healthz_payload(self):
        """(http code, payload): 200 when every configured check passes
        (or no evaluator is configured: a bare liveness probe), 503
        otherwise."""
        snap = self.status_payload()
        verdict = snap.get("health")
        if verdict is None:
            return 200, {"healthy": True, "status": "ok", "checks": {}}
        return (200 if verdict["healthy"] else 503), verdict

    def metrics_text(self) -> str:
        return _telemetry.prometheus_text(self._tel(), registry=self.registry)

    def events_payload(self, since: Optional[int] = None) -> dict:
        tel = self._tel()
        if tel is None:
            return {"events": [], "total": 0, "latest_seq": 0,
                    "note": "lifecycle events need a telemetry session "
                            "(--telemetry-dir / --live-stats)"}
        # latest_seq never runs ahead of the delivered list: the last seq
        # in the response, else the counter read before the copy
        latest = tel.events.total
        evs = tel.events.list(since)
        if evs:
            latest = evs[-1]["seq"]
        elif since is not None:
            latest = max(latest, since)
        return {"events": evs, "total": tel.events.total,
                "latest_seq": latest}

    _TRACE_NOTE = ("window tracing needs a telemetry session with tracing "
                   "enabled (--trace-dir)")

    def _trace_book(self):
        tel = self._tel()
        return tel.traces if tel is not None else None

    def traces_payload(self) -> dict:
        book = self._trace_book()
        if book is None:
            return {"traces": [], "total": 0, "evicted": 0, "latest_seq": 0,
                    "note": self._TRACE_NOTE}
        return {"traces": book.recent(), "total": book.total,
                "evicted": book.evicted, "latest_seq": book.total}

    def trace_payload(self, trace_id: str):
        """(http code, payload) for ``/trace/<id>``."""
        book = self._trace_book()
        if book is None:
            return 404, {"error": self._TRACE_NOTE}
        tr = book.get(trace_id)
        if tr is None:
            return 404, {"error": f"unknown or evicted trace {trace_id!r} "
                                  "(ids are '<family>:<window_start>'; see "
                                  "/trace/recent)"}
        return 200, tr

    def profile_cells_payload(self) -> dict:
        tel = self._tel()
        if tel is None:
            return {"cells": [], "families": {}, "series": [],
                    "note": "cost profiles need a telemetry session "
                            "(--telemetry-dir / --live-stats / --trace-dir)"}
        return tel.costs.cells_payload()

    def latency_payload(self) -> dict:
        """``GET /latency``: the latency plane's document, with the chunk
        governor's ``controller`` block."""
        tel = self._tel()
        if tel is None:
            return {"stages": {}, "recent": [], "queries": {},
                    "backpressure": {"series": []},
                    "note": "the latency plane needs a telemetry session "
                            "(--telemetry-dir / --live-stats / --trace-dir "
                            "/ --postmortem-dir)"}
        return tel.latency.payload(tel=tel)

    # ---------------------- standing-query plane ----------------------- #

    _QUERIES_NOTE = ("no dynamic query registry in this run (enable with "
                     "--queries-file / --control-topic)")

    @staticmethod
    def _registry():
        from spatialflink_tpu_torch.runtime.queryplane import active_registry

        return active_registry()

    def queries_payload(self) -> dict:
        """``GET /queries``: the standing-query ledger."""
        reg = self._registry()
        if reg is None:
            return {"queries": [], "live": 0, "note": self._QUERIES_NOTE}
        return reg.status()

    def query_payload(self, qid: str):
        """(http code, payload) for ``GET /queries/<id>``."""
        reg = self._registry()
        if reg is None:
            return 404, {"error": self._QUERIES_NOTE}
        for row in reg.status()["queries"]:
            if row["id"] == qid:
                return 200, row
        return 404, {"error": f"unknown query {qid!r} (see /queries)"}

    def admit_query_payload(self, body):
        """(http code, payload) for ``POST /queries``: admit a query, or
        stage an update when the id names a live one; it applies at the
        next window boundary."""
        from spatialflink_tpu_torch.runtime.queryplane import (QuerySpecError,
                                                               QueryState)
        from spatialflink_tpu_torch.utils.accounting import QuotaExceeded

        reg = self._registry()
        if reg is None:
            return 409, {"error": self._QUERIES_NOTE}
        try:
            entry = reg.admit(body)
        except QuerySpecError as e:
            return 400, {"error": str(e)}
        except QuotaExceeded as e:
            # a quota refusal makes no entry (shedding parks one)
            return 429, {"error": f"quota-exceeded: {e}",
                         "tenant": e.tenant}
        if entry.state is QueryState.SHED:
            return 429, {"query": entry.to_dict(),
                         "fleet_version": reg.fleet_version,
                         "error": "admission shed: pipeline is under "
                                  "sustained backpressure; the query is "
                                  "parked and admits when pressure clears "
                                  "(see /latency controller block)"}
        return 200, {"query": entry.to_dict(),
                     "fleet_version": reg.fleet_version,
                     "applies": "at the next window boundary"}

    def retire_query_payload(self, qid: str):
        """(http code, payload) for ``DELETE /queries/<id>``: an active
        query drains, a pending one retires at once."""
        reg = self._registry()
        if reg is None:
            return 409, {"error": self._QUERIES_NOTE}
        try:
            entry = reg.retire(qid)
        except KeyError:
            return 404, {"error": f"unknown or already-retired query "
                                  f"{qid!r} (see /queries)"}
        return 200, {"query": entry.to_dict(),
                     "fleet_version": reg.fleet_version}

    # ---------------------- tenant accounting plane -------------------- #

    _TENANTS_NOTE = ("the tenant ledger needs a telemetry session "
                     "(--telemetry-dir / --live-stats / --trace-dir "
                     "/ --postmortem-dir)")

    def tenants_payload(self) -> dict:
        """``GET /tenants``: the per-tenant cost ledger."""
        tel = self._tel()
        if tel is None:
            return {"tenants": {}, "n": 0, "note": self._TENANTS_NOTE}
        return tel.tenants.payload()

    def tenant_payload(self, tenant: str):
        """(http code, payload) for ``GET /tenants/<id>``."""
        tel = self._tel()
        if tel is None:
            return 404, {"error": self._TENANTS_NOTE}
        payload = tel.tenants.tenant_payload(tenant)
        if payload is None:
            return 404, {"error": f"unknown tenant {tenant!r} "
                                  "(see /tenants)"}
        return 200, payload

    # ----------------------- the device plane -------------------------- #

    def device_payload(self) -> dict:
        """``GET /device`` (``utils.deviceplane.device_payload``): process
        truth, with the session's per-family transfer and overlap views
        when one is active."""
        from spatialflink_tpu_torch.utils import deviceplane

        return deviceplane.device_payload(self._tel())

    def compile_payload(self, with_cost: bool = False) -> dict:
        """``GET /compile``: the compile registry (``?cost=1`` is
        accepted; the port's entries carry no cost analysis)."""
        from spatialflink_tpu_torch.utils import deviceplane

        return deviceplane.registry().snapshot(cost=with_cost)

    def partition_payload(self) -> dict:
        """``/partition``: the adaptive grid's layout, policy, epochs and
        recent decisions, or a note on the uniform grid."""
        from spatialflink_tpu_torch.runtime.repartition import (
            active_controller)

        ctl = active_controller()
        if ctl is None:
            return {"adaptive": False,
                    "note": "no adaptive grid in this run "
                            "(enable with --adaptive-grid)"}
        payload = ctl.status()
        payload["adaptive"] = True
        return payload

    # ------------------ the fleet (not in this process) ---------------- #

    _FLEET_NOTE = "not a fleet supervisor (start one with --fleet N)"

    def fleet_payload(self) -> dict:
        return {"fleet": False, "note": self._FLEET_NOTE}

    def fleet_latency_payload(self) -> dict:
        return {"stages": {}, "recent": [], "note": self._FLEET_NOTE}

    def fleet_timeline_payload(self) -> dict:
        return {"events": [], "lanes": {}, "total": 0,
                "note": self._FLEET_NOTE}

    def fleet_events_payload(self, since: Optional[int] = None) -> dict:
        return {"events": [], "total": 0, "latest_seq": 0,
                "note": self._FLEET_NOTE}

    def fleet_metrics_text(self) -> str:
        return f"# {self._FLEET_NOTE}\n"

    def fleet_tenants_payload(self) -> dict:
        return {"tenants": {}, "n": 0, "workers": 0,
                "note": self._FLEET_NOTE}

    # ------------------------------ lifecycle -------------------------- #

    def start(self) -> "OpServer":
        global _ACTIVE_SERVER
        self._httpd = ThreadingHTTPServer((self.host, self._requested_port),
                                          _Handler)
        self._httpd.daemon_threads = True
        self._httpd.opserver = self  # type: ignore[attr-defined]
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        name="opserver", daemon=True)
        self._thread.start()
        _ACTIVE_SERVER = self
        return self

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        global _ACTIVE_SERVER
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
            self._httpd = None
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if _ACTIVE_SERVER is self:
            _ACTIVE_SERVER = None


# --------------------------------------------------------------------- #
# the stderr digest


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
