"""The operations plane on the CPU: the port's ``runtime.health`` and
``runtime.opserver`` against the JAX package's.

The JAX ``tests/test_opserver.py`` cases (all but the live Kafka follow
runs, which come with ``--kafka-follow``) run against the port: the SLO
evaluator's spec parsing, unknown data as healthy, breach transitions
counted once, the status digest's fields, the event ring, the server's
endpoints on an ephemeral port, the 405-with-``Allow`` / 404 handling, the
``/queries`` surface, the 200 -> 503 ``/healthz`` flip, the registry-only
server, the live ``metrics.prom`` and the ``--live-stats`` lines. Then the
two packages side by side: the same status documents give the same
verdicts, breach counts and events, and with the same registry and ledger
state every route answers the same code and the same JSON (clocks
aside; ``/status``, ``/device``, ``/compile`` and ``/metrics`` hold a
backend's own provenance and compile entries, so those compare by
schema), the 405/404 matrix and the 400 / 409 / 429 admissions included.

Every test puts back both packages' process-wide state: the compile
registries' sentinel, the installed server, registry, governor and
session (:func:`_isolated`, which the other operations-plane test files
import).
"""

import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from spatialflink_tpu.runtime import control as JC
from spatialflink_tpu.runtime import health as JH
from spatialflink_tpu.runtime import opserver as JO
from spatialflink_tpu.runtime import queryplane as JQ
from spatialflink_tpu.utils import deviceplane as JDP
from spatialflink_tpu.utils import metrics as JM
from spatialflink_tpu.utils import telemetry as JT

from spatialflink_tpu_torch.runtime import control as TC
from spatialflink_tpu_torch.runtime import health as TH
from spatialflink_tpu_torch.runtime import opserver as TO
from spatialflink_tpu_torch.runtime import queryplane as TQ
from spatialflink_tpu_torch.utils import deviceplane as TDP
from spatialflink_tpu_torch.utils import metrics as TM
from spatialflink_tpu_torch.utils import telemetry as TT

RAW_KEYS = {"ts_ms", "uptime_s", "spans", "histograms", "gauges",
            "counters", "degradation", "grid", "costs", "traces"}
STATUS_KEYS = {"records_in", "throughput_rps", "windows_evaluated",
               "record_latency_ms", "window_latency_ms", "watermark_lag_ms",
               "commit_backlog", "window_backlog", "pane_cache",
               "checkpoint", "breaker_state", "dlq_depth",
               "mesh_degradations", "slo_breaches", "top_cells",
               "skew", "top_cost_cells", "device", "dispatch_overlap",
               "latency", "controller", "tenants"}
#: wall clocks and process stamps: the only values two runs may differ in
CLOCKS = {"ts_ms", "mono_ms", "uptime_s", "admitted_ms", "retired_ms",
          "run_id", "snapshot_seq", "kernel_ms_rate"}

#: the sentinel's run state in both packages' compile registries
_SENTINEL = ("warm", "warm_reason", "warm_at_ms", "strict", "run_compiles",
             "run_recompiles")
_SLOTS = ((JC, "_ACTIVE"), (TC, "_ACTIVE"), (JO, "_ACTIVE_SERVER"),
          (TO, "_ACTIVE_SERVER"), (JQ, "_ACTIVE"), (TQ, "_ACTIVE"),
          (JT, "_ACTIVE"), (TT, "_ACTIVE"), (JDP, "_ACTIVE_RECORDER"),
          (TDP, "_ACTIVE_RECORDER"))


@pytest.fixture(autouse=True)
def _isolated():
    """Both packages' process-wide state put back after each test: the
    compile registries' sentinel (a JAX test reading a status block must
    not see this file's runs) and the installed governor, server,
    registry, session and recorder."""
    regs = (JDP.registry(), TDP.registry())
    saved = [{k: getattr(r, k) for k in _SENTINEL} for r in regs]
    slots = [(mod, name, getattr(mod, name)) for mod, name in _SLOTS]
    yield
    for r, state in zip(regs, saved):
        for k, v in state.items():
            setattr(r, k, v)
    for mod, name, old in slots:
        cur = getattr(mod, name)
        if cur is not old and hasattr(cur, "close") and mod in (JO, TO):
            cur.close()
        setattr(mod, name, old)


def strip(doc):
    """``doc`` without its clock fields, at every depth."""
    if isinstance(doc, dict):
        return {k: strip(v) for k, v in doc.items() if k not in CLOCKS}
    if isinstance(doc, list):
        return [strip(v) for v in doc]
    return doc


def request(url, method="GET", body=None, raw=None):
    """(code, parsed-or-text body, headers) of one request, 4xx/5xx
    included; a few seconds' timeout."""
    data = raw if raw is not None else (
        None if body is None else json.dumps(body).encode())
    req = urllib.request.Request(url, method=method, data=data)
    try:
        resp = urllib.request.urlopen(req, timeout=5)
        code, payload, hdrs = resp.status, resp.read(), resp.headers
    except urllib.error.HTTPError as e:
        code, payload, hdrs = e.code, e.read(), e.headers
    if payload and "json" in hdrs.get("Content-Type", ""):
        return code, json.loads(payload), hdrs
    return code, payload.decode() if payload else None, hdrs


def _get(url):
    code, body, _ = request(url)
    return code, body


# ----------------------------------------------------- the evaluator


class TestHealthEvaluator:
    def test_spec_parsing(self):
        h = TH.HealthEvaluator.from_spec(
            "watermark_lag_ms=5000, p99_window_ms=250,commit_backlog=1e4")
        assert h.thresholds == {"watermark_lag_ms": 5000.0,
                                "p99_window_ms": 250.0,
                                "commit_backlog": 10000.0}

    @pytest.mark.parametrize("spec", ["wobble=3", "watermark_lag_ms",
                                      "watermark_lag_ms=fast", "",
                                      "p99_window_ms=1,,shedding=x"])
    def test_spec_errors_match_jax(self, spec):
        def err(cls):
            with pytest.raises(ValueError) as e:
                cls.from_spec(spec)
            return str(e.value)
        assert err(TH.HealthEvaluator) == err(JH.HealthEvaluator)

    def test_known_checks_match_jax(self):
        assert list(TH.KNOWN_CHECKS) == list(JH.KNOWN_CHECKS)
        assert [d for _, d in TH.KNOWN_CHECKS.values()] == \
            [d for _, d in JH.KNOWN_CHECKS.values()]

    def test_missing_data_is_healthy_not_breached(self):
        h = TH.HealthEvaluator({k: 1.0 for k in TH.KNOWN_CHECKS})
        with TM.scoped_registry():
            verdict = h.evaluate(TT.registry_snapshot())
        assert verdict["healthy"] and verdict["status"] == "ok"
        assert set(verdict["checks"]) == set(TH.KNOWN_CHECKS)
        # the CPU has no device memory (None), the counters read 0
        assert all(c["ok"] and c["value"] in (None, 0)
                   for c in verdict["checks"].values())

    def test_breach_transition_counts_once_and_recovers(self):
        with TM.scoped_registry() as reg, TT.telemetry_session() as tel:
            h = TH.HealthEvaluator.from_spec("watermark_lag_ms=10")
            tel.gauge("kafka.watermark-lag-ms").set(50.0)
            for _ in range(3):  # a sustained breach is ONE transition
                verdict = h.evaluate(tel.snapshot())
                assert not verdict["healthy"]
                assert verdict["status"] == "breach"
                assert verdict["checks"]["watermark_lag_ms"] == {
                    "value": 50.0, "threshold": 10.0, "ok": False}
            assert reg.counter("slo-breaches").count == 1
            kinds = [e["kind"] for e in tel.events.list()]
            assert kinds == ["slo-breach", "watermark-stall"]
            tel.gauge("kafka.watermark-lag-ms").set(2.0)
            assert h.evaluate(tel.snapshot())["healthy"]
            assert tel.events.list()[-1]["kind"] == "slo-recovered"
            tel.gauge("kafka.watermark-lag-ms").set(99.0)
            h.evaluate(tel.snapshot())
            assert reg.counter("slo-breaches").count == 2

    def test_min_throughput_breaches_low_not_high(self):
        with TM.scoped_registry() as reg:
            h = TH.HealthEvaluator.from_spec("min_throughput_rps=100")
            assert h.evaluate(TT.registry_snapshot())["healthy"]
            reg.meter("ingest-throughput").mark(5)
            assert not h.evaluate(TT.registry_snapshot())["healthy"]

    def test_hook_fires_once_per_transition_and_faults_are_contained(self):
        h = TH.HealthEvaluator.from_spec("window_backlog=1")
        seen = []
        h.hooks += [lambda *a: seen.append(a), lambda *a: 1 / 0]
        doc = {"status": {"window_backlog": 5.0}}
        with TM.scoped_registry():
            for _ in range(3):
                assert not h.evaluate(doc)["healthy"]
        assert seen == [("window_backlog", 5.0, 1.0)]


def _status_docs(n=40, seed=3):
    """Status digests that walk every check across its threshold (None
    for a field with no data yet)."""
    rng = np.random.default_rng(seed)

    def v(lo, hi):
        return None if rng.random() < 0.2 else float(rng.uniform(lo, hi))

    docs = []
    for _ in range(n):
        hist = {"count": int(rng.integers(0, 3)),
                "p99": float(rng.uniform(0, 400))}
        emit = {"count": int(rng.integers(0, 3)),
                "p99": float(rng.uniform(0, 400))}
        chunk = None if rng.random() < 0.3 else 2048
        docs.append({"status": {
            "watermark_lag_ms": v(0, 2000),
            "window_latency_ms": dict(hist),
            "record_latency_ms": {"count": hist["count"],
                                  "p99": hist["p99"] / 2},
            "commit_backlog": v(0, 200), "window_backlog": v(0, 4),
            "checkpoint": {"age_s": v(0, 90)},
            "dlq_depth": int(rng.integers(0, 3)),
            "breaker_state": v(0, 1),
            "records_in": int(rng.integers(0, 2) * 1000),
            "throughput_rps": float(rng.uniform(0, 300)),
            "device": {"recompiles": int(rng.integers(0, 2)),
                       "mem_bytes_in_use": v(0, 2e9)},
            "latency": {"record_emit_ms": emit},
            "controller": {"chunk": chunk,
                           "shedding": bool(rng.integers(0, 2))},
        }})
    return docs + [{"status": {}}]  # nothing known: healthy, all recover


SLO = ("watermark_lag_ms=1000,p99_window_ms=200,p99_record_ms=150,"
       "commit_backlog=100,window_backlog=2,checkpoint_age_s=60,"
       "dlq_depth=1,breaker_state=0.5,min_throughput_rps=100,recompiles=0,"
       "device_mem_bytes=1e9,p99_emit_ms=250,shedding=0")


def _evaluate_all(evaluator_cls, registry_mod, telemetry_mod, docs):
    h = evaluator_cls.from_spec(SLO)
    with registry_mod.scoped_registry() as reg, \
            telemetry_mod.telemetry_session() as tel:
        verdicts = [h.evaluate(d) for d in docs]
        events = [{k: v for k, v in e.items() if k not in CLOCKS}
                  for e in tel.events.list()]
        return verdicts, reg.counter("slo-breaches").count, events


def test_same_documents_give_the_same_verdicts_as_jax():
    docs = _status_docs()
    got = _evaluate_all(TH.HealthEvaluator, TM, TT, docs)
    want = _evaluate_all(JH.HealthEvaluator, JM, JT, docs)
    assert got == want
    assert want[1] >= 10 and any(not v["healthy"] for v in want[0])
    assert any(v["healthy"] for v in want[0])
    assert {e["kind"] for e in want[2]} == {
        "slo-breach", "slo-recovered", "watermark-stall"}


# ----------------------------------------------------- the snapshot


class TestStatusSnapshot:
    def test_digest_surfaces_operator_fields(self):
        with TM.scoped_registry() as reg, TT.telemetry_session() as tel:
            reg.counter("pane-cache-hits").inc(30)
            reg.counter("pane-cache-misses").inc(10)
            reg.counter("checkpoints-written").inc(2)
            reg.counter("dlq-records").inc(1)
            reg.counter("batches-evaluated").inc(7)
            reg.meter("ingest-throughput").mark(100)
            tel.gauge("checkpoint.seq").set(2.0)
            tel.gauge("checkpoint.age-s").set(1.25)
            tel.gauge("broker.breaker-state").set(0.5)
            tel.gauge("kafka.watermark-lag-ms").set(42.0)
            tel.histogram("window-latency-ms").record(8.0)
            tel.record_cells(np.array([3, 3, 9]))
            snap = TT.status_snapshot(tel)
        assert RAW_KEYS <= set(snap)
        st = snap["status"]
        assert set(st) == STATUS_KEYS
        assert st["pane_cache"] == {"hits": 30, "misses": 10,
                                    "hit_rate": 0.75}
        assert (st["checkpoint"]["seq"], st["checkpoint"]["age_s"],
                st["checkpoint"]["written"]) == (2.0, 1.25, 2)
        assert (st["breaker_state"], st["dlq_depth"], st["records_in"],
                st["windows_evaluated"], st["watermark_lag_ms"]) == (
            0.5, 1, 100, 7, 42.0)
        assert st["top_cells"][0][0] == 3
        assert st["skew"]["top_share"] == pytest.approx(2 / 3, abs=1e-3)
        json.dumps(snap)

    def test_registry_only_fallback_without_session(self):
        assert TT.active() is None
        with TM.scoped_registry() as reg:
            reg.counter("batches-evaluated").inc(3)
            snap = TT.status_snapshot()
        assert RAW_KEYS <= set(snap)
        assert snap["uptime_s"] is None and snap["spans"] == {}
        assert snap["status"]["windows_evaluated"] == 3
        assert snap["status"]["watermark_lag_ms"] is None

    def test_health_stamped_from_session(self):
        h = TH.HealthEvaluator.from_spec("dlq_depth=0")
        with TM.scoped_registry() as reg, \
                TT.telemetry_session(health=h) as tel:
            assert TT.status_snapshot(tel)["health"]["healthy"]
            reg.counter("dlq-records").inc()
            assert TT.status_snapshot(tel)["health"]["status"] == "breach"

    def test_format_digest_one_line(self):
        with TM.scoped_registry(), TT.telemetry_session() as tel:
            tel.gauge("kafka.watermark-lag-ms").set(130.0)
            line = TO.format_digest(TT.status_snapshot(tel))
        assert line.startswith("# live: ") and "\n" not in line
        assert "wm lag 130ms" in line


class TestEventRing:
    def test_capacity_eviction_and_total(self):
        ring = TT.EventRing(capacity=4)
        for i in range(10):
            ring.append("e", i=i)
        evs = ring.list()
        assert len(evs) == 4 and ring.total == 10
        assert [e["i"] for e in evs] == [6, 7, 8, 9]

    def test_emit_event_noop_without_session(self):
        assert TT.active() is None
        TT.emit_event("orphan", x=1)
        with TT.telemetry_session() as tel:
            TT.emit_event("kept", x=2)
            assert [e["kind"] for e in tel.events.list()] == ["kept"]


# ----------------------------------------------------- the server


GET_ONLY = ("/status", "/healthz", "/metrics", "/events", "/partition",
            "/trace/recent", "/trace/some-id", "/profile/cells",
            "/latency", "/tenants", "/tenants/acme", "/device", "/compile",
            "/fleet", "/fleet/latency", "/fleet/timeline", "/fleet/events",
            "/fleet/metrics", "/fleet/tenants")


class TestOpServer:
    def test_endpoints_schemas_ephemeral_port_and_shutdown(self):
        with TM.scoped_registry() as reg, TT.telemetry_session() as tel:
            reg.counter("batches-evaluated").inc(5)
            tel.event("checkpoint-committed", seq=1)
            srv = TO.OpServer(port=0).start()
            try:
                assert srv.port and srv.port > 0
                assert TO.active_server() is srv
                code, health = _get(srv.url + "/healthz")
                assert code == 200 and health == {
                    "healthy": True, "status": "ok", "checks": {}}
                code, status = _get(srv.url + "/status")
                assert code == 200 and RAW_KEYS | {"status"} <= set(status)
                assert status["status"]["windows_evaluated"] == 5
                code, prom = _get(srv.url + "/metrics")
                assert 'spatialflink_counter{name="batches-evaluated"} 5' \
                    in prom
                code, events = _get(srv.url + "/events")
                assert code == 200 and events["total"] == 1
                assert events["events"][0]["kind"] == "checkpoint-committed"
                code, missing = _get(srv.url + "/nope")
                assert code == 404 and "/status" in missing["endpoints"]
                assert srv.requests_served == 5
            finally:
                port = srv.port
                srv.close()
        assert TO.active_server() is None
        with pytest.raises(urllib.error.URLError):
            urllib.request.urlopen(f"http://127.0.0.1:{port}/status",
                                   timeout=1)

    def test_bind_failure_raises(self):
        srv = TO.OpServer(port=0).start()
        try:
            with pytest.raises(OSError):
                TO.OpServer(port=srv.port).start()
            assert TO.active_server() is srv
        finally:
            srv.close()

    def test_method_handling_405_with_allow_and_404_elsewhere(self):
        srv = TO.OpServer(port=0).start()
        try:
            u = srv.url
            for path in GET_ONLY:
                for method in ("POST", "DELETE", "PUT", "PATCH", "HEAD"):
                    code, payload, hdrs = request(u + path, method, body={})
                    assert code == 405, (path, method, code)
                    assert hdrs.get("Allow") == "GET", (path, method)
                    if method != "HEAD":
                        assert payload["allow"] == ["GET"]
                        assert path in payload["error"]
            for method in ("GET", "POST", "DELETE", "PUT", "PATCH"):
                code, payload, _ = request(u + "/wat", method, body={})
                assert code == 404 and "/queries" in payload["endpoints"]
            code, _, hdrs = request(u + "/queries", "DELETE")
            assert code == 405 and hdrs.get("Allow") == "GET, POST"
            code, _, hdrs = request(u + "/queries/some-id", "POST", body={})
            assert code == 405 and hdrs.get("Allow") == "GET, DELETE"
            assert request(u + "/queries")[0] == 200
            assert request(u + "/queries", "POST", {"id": "x"})[0] == 409
            assert request(u + "/queries/x", "DELETE")[0] == 409
            assert request(u + "/queries", "POST", raw=b"{nope")[0] == 400
            assert request(u + "/events?since=x")[0] == 400
        finally:
            srv.close()

    def test_queries_surface_with_live_registry(self):
        srv = TO.OpServer(port=0).start()
        reg = TQ.QueryRegistry("range", radius=0.5).install()
        try:
            u = srv.url
            code, body, _ = request(u + "/queries", "POST",
                                    {"id": "q1", "x": 116.5, "y": 40.3})
            assert code == 200 and body["query"]["state"] == "pending"
            assert body["applies"] == "at the next window boundary"
            assert request(u + "/queries", "POST", {"id": "q1"})[0] == 400
            reg.apply()
            code, body, _ = request(u + "/queries")
            assert code == 200 and body["fleet"] == ["q1"]
            assert body["live"] == 1 and body["bucket"] == 1
            code, body, _ = request(u + "/queries/q1")
            assert code == 200 and body["state"] == "active"
            assert request(u + "/queries/ghost")[0] == 404
            code, body, _ = request(u + "/queries/q1", "DELETE")
            assert code == 200 and body["query"]["state"] == "draining"
            reg.apply()
            assert request(u + "/queries/q1", "DELETE")[0] == 404
        finally:
            reg.uninstall()
            srv.close()

    def test_healthz_flips_200_to_503_on_injected_breach(self):
        h = TH.HealthEvaluator.from_spec("watermark_lag_ms=10")
        with TM.scoped_registry() as reg, \
                TT.telemetry_session(health=h) as tel:
            srv = TO.OpServer(port=0).start()
            try:
                tel.gauge("kafka.watermark-lag-ms").set(3.0)
                code, verdict = _get(srv.url + "/healthz")
                assert code == 200 and verdict["healthy"]
                tel.gauge("kafka.watermark-lag-ms").set(5000.0)
                code, verdict = _get(srv.url + "/healthz")
                assert code == 503 and not verdict["healthy"]
                assert verdict["checks"]["watermark_lag_ms"]["ok"] is False
                assert reg.counter("slo-breaches").count == 1
                _, status = _get(srv.url + "/status")
                assert status["health"]["status"] == "breach"
                assert status["status"]["slo_breaches"] == 1
                tel.gauge("kafka.watermark-lag-ms").set(3.0)
                assert _get(srv.url + "/healthz")[0] == 200
            finally:
                srv.close()

    def test_no_session_serves_registry_counters(self):
        assert TT.active() is None
        with TM.scoped_registry() as reg:
            reg.counter("records-evaluated").inc(11)
            srv = TO.OpServer(port=0, health=TH.HealthEvaluator.from_spec(
                "commit_backlog=5")).start()
            try:
                code, status = _get(srv.url + "/status")
                assert code == 200
                assert status["counters"]["records-evaluated"] == 11
                assert status["spans"] == {}
                assert _get(srv.url + "/healthz")[0] == 200
                _, events = _get(srv.url + "/events")
                assert events["events"] == [] and "note" in events
            finally:
                srv.close()

    def test_device_and_compile_name_the_libraries(self):
        """``/device`` reads the port's device plane (no card here: the
        memory row says so) and ``/compile`` lists every registered
        kernel entry point (a library appears once built, on the
        card)."""
        from spatialflink_tpu_torch.ops import knn, range as R  # noqa: F401

        srv = TO.OpServer(port=0).start()
        try:
            code, dev = _get(srv.url + "/device")
            assert code == 200 and dev["backend"]["platform"] == "cpu"
            assert dev["memory"]["available"] is False
            code, comp = _get(srv.url + "/compile?cost=1")
            assert code == 200
            names = {e["name"] for e in comp["entries"]}
            assert {"range_filter_point_stats", "knn_point_stats"} <= names
            assert comp["functions"] == len(comp["entries"])
            assert all(e["cost_analysis"] is None for e in comp["entries"])
        finally:
            srv.close()


class TestLivePromRewrite:
    def test_metrics_prom_rewritten_per_snapshot(self, tmp_path):
        with TM.scoped_registry() as reg, \
                TT.telemetry_session(str(tmp_path), interval_s=0.05):
            reg.counter("batches-evaluated").inc(1)
            deadline = time.monotonic() + 5.0
            prom = os.path.join(str(tmp_path), "metrics.prom")
            while time.monotonic() < deadline:
                if os.path.exists(prom) and \
                        'name="batches-evaluated"} 1' in open(prom).read():
                    break
                time.sleep(0.02)
            else:
                pytest.fail("live metrics.prom never showed the counter")
            reg.counter("batches-evaluated").inc(41)
            while time.monotonic() < deadline:
                if 'name="batches-evaluated"} 42' in open(prom).read():
                    break
                time.sleep(0.02)
            else:
                pytest.fail("metrics.prom was not rewritten mid-run")
        assert 'name="batches-evaluated"} 42' in open(prom).read()


class TestLiveStats:
    def test_periodic_digest_lines(self, capsys):
        with TM.scoped_registry() as reg, TT.telemetry_session():
            reg.meter("ingest-throughput").mark(10)
            live = TO.LiveStats(interval_s=0.05).start()
            time.sleep(0.2)
            live.close()
        lines = [ln for ln in capsys.readouterr().err.splitlines()
                 if ln.startswith("# live: ")]
        assert len(lines) >= 2 and live.emitted == len(lines)
        assert any("in 10 rec" in ln for ln in lines)


# ------------------------------------- both servers, route by route


def _fed(ledger, weights, kernel_s=0.004, start=1_700_000_000_000):
    ledger.note_dispatch("op", start, kernel_s, 100, 4096)
    ledger.resolve("op", start, [(f"q-{t}", t, w) for t, w in weights])


def _state(Q, tel):
    """The same registry and ledger state in one package: a fleet with
    quotas, an update, a drain, a parked admission and a tenant ledger."""
    reg = Q.QueryRegistry("range", radius=0.5, default_tenant="house",
                          tenant_quotas={"acme": {"max_active": 2}})
    for i, (x, y) in enumerate([(116.5, 40.3), (116.0, 40.0),
                                (117.0, 40.9)]):
        reg.admit({"id": f"q{i}", "x": x, "y": y,
                   "tenant": "acme" if i < 2 else "free",
                   "latency_class": "interactive" if i == 2 else "batch"})
    reg.apply()
    reg.update("q1", {"slo": {"max_window_records": 3}})
    reg.retire("q0")
    reg.apply()
    _fed(tel.tenants, [("acme", 3.0), ("free", 1.0)])
    _fed(tel.tenants, [("house", 2.0)], kernel_s=0.002,
         start=1_700_000_005_000)
    tel.event("checkpoint-committed", seq=1)
    return reg.install()


def _script(url):
    """Every route and the admission cases, in one order: (request,
    code, body, Allow) each."""
    out = []
    reqs = [("GET", p, None) for p in (
        "/healthz", "/events", "/events?since=1", "/events?since=x",
        "/trace/recent", "/trace/op:1", "/profile/cells", "/latency",
        "/partition", "/queries", "/queries/q1", "/queries/q0",
        "/queries/ghost", "/tenants", "/tenants/acme", "/tenants/ghost",
        "/fleet", "/fleet/latency", "/fleet/timeline", "/fleet/events",
        "/fleet/events?since=2", "/fleet/metrics", "/fleet/tenants",
        "/nope")]
    reqs += [("POST", "/queries", {"id": "bad", "x": "wat", "y": 1}),
             ("POST", "/queries", {"id": "q9", "x": 116.1, "y": 40.1,
                                   "tenant": "acme"}),
             ("POST", "/queries", {"id": "q8", "x": 116.1, "y": 40.1,
                                   "tenant": "acme"}),
             ("POST", "/queries", {"id": "q7", "x": 116.2, "y": 40.2}),
             ("SHED", None, None),
             ("POST", "/queries", {"id": "q6", "x": 116.3, "y": 40.3,
                                   "route": "file:x"}),
             ("GET", "/queries/q6", None),
             ("DELETE", "/queries/q7", None),
             ("DELETE", "/queries/q6", None),
             ("DELETE", "/queries/ghost", None),
             ("GET", "/queries", None), ("GET", "/events", None)]
    reqs += [(m, p, {}) for p in GET_ONLY[:6] for m in ("POST", "DELETE")]
    reqs += [("DELETE", "/queries", None), ("PUT", "/queries/q1", {})]
    for method, path, body in reqs:
        if method == "SHED":
            TQ.active_registry() and TQ.active_registry().set_shedding(True)
            JQ.active_registry() and JQ.active_registry().set_shedding(True)
            continue
        code, payload, hdrs = request(url + path, method, body)
        out.append((method, path, code, strip(payload),
                    hdrs.get("Allow")))
    return out


def test_routes_answer_as_jax():
    """One script of GETs, POSTs and DELETEs against each package's
    server over the same registry and ledger state: every answer's code,
    body (clocks aside) and ``Allow`` header equal."""
    results = {}
    for name, (Q, M, T, O) in {"port": (TQ, TM, TT, TO),
                               "jax": (JQ, JM, JT, JO)}.items():
        with M.scoped_registry(), T.telemetry_session() as tel:
            reg = _state(Q, tel)
            srv = O.OpServer(port=0).start()
            try:
                results[name] = _script(srv.url)
                schema = {p: _get(srv.url + p)[1] for p in
                          ("/status", "/device", "/compile")}
                prom = _get(srv.url + "/metrics")[1]
            finally:
                srv.close()
                reg.uninstall()
        results[name + "-schema"] = (
            sorted(schema["/status"]), sorted(schema["/status"]["status"]),
            sorted(schema["/device"]), sorted(schema["/compile"]),
            sorted({ln.split("{")[0] for ln in prom.splitlines()
                    if ln and not ln.startswith("#")}))
    assert len(results["port"]) == len(results["jax"]) > 40
    for got, want in zip(results["port"], results["jax"]):
        assert got == want, (got[:3], want[:3])
    codes = {c for _, _, c, _, _ in results["jax"]}
    assert codes == {200, 400, 404, 405, 429}
    assert results["port-schema"] == results["jax-schema"]


def test_no_registry_admissions_answer_409_as_jax():
    out = {}
    for name, O in (("port", TO), ("jax", JO)):
        srv = O.OpServer(port=0).start()
        try:
            out[name] = [request(srv.url + p, m, b)[:2] for m, p, b in (
                ("POST", "/queries", {"id": "x", "x": 1, "y": 2}),
                ("DELETE", "/queries/x", None), ("GET", "/queries", None),
                ("GET", "/queries/x", None), ("GET", "/tenants", None),
                ("GET", "/tenants/x", None), ("GET", "/latency", None),
                ("GET", "/profile/cells", None), ("GET", "/trace/x", None),
                ("POST", "/queries", None))]
        finally:
            srv.close()
    assert out["port"] == out["jax"]
    assert [c for c, _ in out["jax"]][:2] == [409, 409]


def test_occupancy_reads_a_copy_while_a_writer_counts():
    """The reporter (or a scrape) reads the cell occupancy while the
    decode thread counts into it and grows it: ``to_dict`` reads one copy,
    so it never sees the array change under ``np.nonzero`` (which raises
    "number of non-zero array elements changed")."""
    import threading

    occ = TT.CellOccupancy()
    stop, started = threading.Event(), threading.Event()
    rng = np.random.default_rng(1)

    def write():
        # fresh cells over a growing range: zero counts turn non-zero and
        # the array grows while the reader works (the JAX occupancy
        # raises within 0.1 s of this)
        i = 0
        started.set()
        while not stop.is_set():
            occ.record(rng.integers(0, 1 << (12 + (i // 20) % 6), 4096))
            i += 1

    t = threading.Thread(target=write, daemon=True)
    t.start()
    started.wait(5)
    t0 = time.monotonic()
    try:
        while time.monotonic() - t0 < 1.5:
            d = occ.to_dict()
            assert d["occupied_cells"] >= len(d["top_cells"])
    finally:
        stop.set()
        t.join(timeout=5)
