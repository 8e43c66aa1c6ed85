"""The port's telemetry pieces against the JAX package's, on the same
seeded inputs: the streaming histogram, cell occupancy and cost profiles
(injected ``dt_s``), the tenant ledger's split and residual, the latency
plane's budget rows (injected clocks), the Prometheus text, the Chrome
trace (patched clock), the status digest and the ``--live-stats`` line;
then the device plane on the CPU (signatures, the sentinel, provenance,
memory rows) and two writers on one session's cost profiles."""

import json
import threading

import numpy as np
import pytest
import torch

from spatialflink_tpu.runtime import opserver as JO
from spatialflink_tpu.utils import accounting as JA
from spatialflink_tpu.utils import latencyplane as JL
from spatialflink_tpu.utils import metrics as JM
from spatialflink_tpu.utils import telemetry as JT

from spatialflink_tpu_torch.runtime import opserver as TO
from spatialflink_tpu_torch.utils import accounting as TA
from spatialflink_tpu_torch.utils import deviceplane as TDP
from spatialflink_tpu_torch.utils import latencyplane as TL
from spatialflink_tpu_torch.utils import metrics as TM
from spatialflink_tpu_torch.utils import telemetry as TT

torch.set_num_threads(1)


def _values(seed=0, n=4000):
    rng = np.random.default_rng(seed)
    v = np.concatenate([rng.lognormal(2.0, 2.5, n), np.zeros(20),
                        -rng.random(10), [1e-3, 1e9, 3.5e7]])
    rng.shuffle(v)
    return v.tolist()


def test_streaming_histogram_matches_jax():
    for kw in ({}, {"lo": 0.01, "hi": 1e4, "growth": 1.5}):
        j, t = JT.StreamingHistogram("h", **kw), TT.StreamingHistogram("h", **kw)
        for v in _values():
            j.record(v)
            t.record(v)
        assert j.counts == t.counts
        assert j.to_dict() == t.to_dict()
        for p in (0, 1, 25, 50, 90, 95, 99, 99.9, 100):
            assert j.percentile(p) == t.percentile(p)


def _cell_feed(seed=1):
    rng = np.random.default_rng(seed)
    feed = []
    for i in range(40):
        if i % 7 == 3:
            feed.append(int(rng.integers(-1, 900)))  # one record
        else:
            c = rng.zipf(1.6, int(rng.integers(1, 400))) % 1200 - 1
            feed.append(c.astype(np.int32 if i % 2 else np.int64))
    return feed


def test_occupancy_and_cost_profiles_match_jax(monkeypatch):
    clock = [1000.0]
    for mod in (JT, TT):
        monkeypatch.setattr(mod.time, "time", lambda: clock[0])
    j, t = JT.Telemetry(), TT.Telemetry()
    rng = np.random.default_rng(2)
    for i, cells in enumerate(_cell_feed()):
        j.record_cells(cells)
        t.record_cells(cells)
        if i % 3 == 2:
            dt = float(rng.random() * 0.01)
            fam = ("range", "knn")[i % 2]
            for x in (j, t):
                x.costs.attribute_kernel(fam, dt, records=i * 10,
                                         nbytes=i * 320)
                x.costs.attribute_merge(fam, dt / 3)
                x.costs.note_pane(fam, i % 4, i % 3)
                x.costs.note_readback(fam, 64 * i)
        if i % 10 == 9:
            clock[0] += 6.0
            for x in (j, t):
                x.costs.maybe_tick()
    for k in (1, 8, 30):
        assert j.cells.top_k(k) == t.cells.top_k(k)
    assert j.cells.to_dict() == t.cells.to_dict()
    assert j.cells.skew() == t.cells.skew()
    assert j.cells.gini() == t.cells.gini()
    assert j.cells.top_share() == t.cells.top_share()
    assert j.costs.to_dict() == t.costs.to_dict()
    assert j.costs.cells_payload() == t.costs.cells_payload()
    assert list(j.costs.series) == list(t.costs.series)
    np.testing.assert_array_equal(j.costs.cell_costs(1500),
                                  t.costs.cell_costs(1500))
    assert JT.normalize_cells(np.array([-1, -1]), np) is None
    assert TT.normalize_cells(np.array([-1, -1]), np) is None


def test_tenant_ledger_matches_jax(monkeypatch):
    clock = [50.0]
    for mod in (JA, TA):
        monkeypatch.setattr(mod.time, "time", lambda: clock[0])
    j, t = JA.TenantLedger(), TA.TenantLedger()
    rng = np.random.default_rng(3)
    for w in range(60):
        slots = [(f"q{i}", ("acme", "free", None)[i % 3],
                  float(rng.integers(0, 50)) if w % 5 else 0.0)
                 for i in range(int(rng.integers(1, 7)))]
        kms = float(rng.random() * 0.003)
        for x in (j, t):
            x.note_dispatch("range", w * 5000, kms, 100 + w, 3200 + w)
            if w % 4:
                x.resolve("range", w * 5000, slots)
            x.note_window(slots[0][1], slots[0][0], w)
            if w % 9 == 0:
                x.note_breach("acme")
                x.note_pane("free", w, w % 2)
        if w % 20 == 19:
            clock[0] += 10.0
            for x in (j, t):
                x.maybe_tick()
    assert j.to_dict() == t.to_dict()
    assert j.payload() | {"ts_ms": 0} == t.payload() | {"ts_ms": 0}
    assert j.snapshot() == t.snapshot()
    assert j.tenant_payload("acme") | {"ts_ms": 0} == \
        t.tenant_payload("acme") | {"ts_ms": 0}
    for x in (j, t):
        assert x.max_residual_ms < 1e-12
    r = TA.TenantLedger()
    r.restore(j.snapshot())
    assert r.snapshot() == j.snapshot()
    docs = [j.payload(), None, t.payload()]
    assert JA.merge_tenant_payloads(docs) | {"ts_ms": 0} == \
        TA.merge_tenant_payloads(docs) | {"ts_ms": 0}
    assert JA.gini([3, 1, 0, 7]) == TA.gini([3, 1, 0, 7])
    spec = "acme:4,kernel_ms_s=250;free:1"
    assert JA.parse_tenant_quotas(spec) == TA.parse_tenant_quotas(spec)
    for bad in ("acme", "acme:x", "a:1,foo=2", "a:1;a:2"):
        with pytest.raises(ValueError):
            TA.parse_tenant_quotas(bad)


def test_latency_plane_rows_match_jax(monkeypatch):
    clock = [2000.0]
    for mod in (JL, TL):
        monkeypatch.setattr(mod.time, "time", lambda: clock[0])
    j, t = JL.LatencyPlane(), TL.LatencyPlane()
    rng = np.random.default_rng(4)
    for w in range(50):
        ws = w * 5000
        fi = None if w % 6 == 0 else 1.9e6 + w * 7
        stages = {s: float(rng.random() * 5) for s in JL.CHAIN_STAGES}
        emit = 2000.0 + w * 0.01
        for x in (j, t):
            x.note_seal(ws, emit - 0.004)
            assert x.pop_seal(ws, 0.0) == emit - 0.004
            x.note_dispatch(ws, emit - 0.002)
            x.window_complete("knn", ws, ws + 10000, fi, stages, emit,
                              last_ingest_ms=None if fi is None else fi + 3)
            x.note_downstream("sink", ws, emit, emit + 0.001)
            x.query_emit(f"q{w % 3}", ws, emit + 0.002)
    assert j.to_dict() == t.to_dict()
    assert j.recent_rows(64) == t.recent_rows(64)
    assert j.budget_row(245000) == t.budget_row(245000)
    for q in ("q0", "q1", "q2", "none"):
        assert j.query_p99(q) == t.query_p99(q)
    clock[0] += 10
    jb, tb = j.tick(), t.tick()
    assert jb == tb
    assert j.payload() | {"ts_ms": 0} == t.payload() | {"ts_ms": 0}


def _fill(mod, tel, clock):
    """The same spans, histograms, gauges and tenant rows in a session."""
    for name, q, dt in (("kernel", "range", 0.002), ("merge", "range", 0.004),
                        ("window", "knn", 0.001), ("sink", None, 0.0005),
                        ("kernel", "knn", 0.003)):
        for i in range(3):
            tel.observe(name, dt * (i + 1), query=q)
    for name in ("window-latency-ms", "record-emit-ms@q7", "knn.rec"):
        h = tel.histogram(name)
        for v in _values(5, 300):
            h.record(v)
    tel.gauge("window-backlog").set(2)
    tel.gauge("kafka.watermark-lag-ms").set(1234.5)
    tel.gauge("checkpoint.seq", lambda: 7.0)
    tel.gauge("checkpoint.age-s", lambda: 3.5)
    tel.tenants.note_window("acme", "q7", 12)
    tel.tenants.note_dispatch("range", 0, 0.004, 10, 320)
    tel.tenants.resolve("range", 0, [("q7", "acme", 3.0), ("q8", "b", 1.0)])
    tel.record_cells(np.array([3, 3, 9, -1]))


def test_prometheus_text_and_digest_match_jax(monkeypatch):
    clock = [3000.0]
    for mod in (JT, TT, JA, TA, JL, TL):
        monkeypatch.setattr(mod.time, "time", lambda: clock[0])
    texts, snaps = [], []
    for mmod, tmod in ((JM, JT), (TM, TT)):
        with mmod.scoped_registry() as reg:
            reg.counter("batches-evaluated").inc(13)
            reg.counter("windows-emitted@q7").inc(2)
            reg.counter("retry-attempts").inc(4)
            tel = tmod.Telemetry(reg)
            tel.started_at = clock[0] - 12.0
            _fill(tmod, tel, clock)
            texts.append(tmod.prometheus_text(tel))
            texts.append(tmod.prometheus_text(None, registry=reg))
            snap = tel.snapshot()
            snaps.append(snap)
            snaps.append(tmod.registry_snapshot(reg))
    assert texts[0] == texts[2] and texts[1] == texts[3]
    assert 'spatialflink_span_count{stage="kernel",family="range"} 3' \
        in texts[2]
    assert 'name="windows-emitted",query="q7"' in texts[2]
    assert JT.relabel_prometheus_lines(texts[0], "worker", "w1") == \
        TT.relabel_prometheus_lines(texts[2], "worker", "w1")
    for s in snaps:
        s["device"] = {"backend": {"platform": "cpu"}}
    assert JT.status_digest(snaps[0]) == TT.status_digest(snaps[2])
    assert JT.status_digest(snaps[1]) == TT.status_digest(snaps[3])
    for s in (snaps[0], snaps[2]):
        s["status"] = JT.status_digest(s)
    assert JO.format_digest(snaps[0]) == TO.format_digest(snaps[2])
    line = TO.format_digest(snaps[2])
    assert line.startswith("# live: up 12s") and "dev cpu" in line


def test_chrome_trace_matches_jax(monkeypatch):
    clock = [4000.0]
    for mod in (JT, TT):
        monkeypatch.setattr(mod.time, "time", lambda: clock[0])
    books = [JT.WindowTraceBook(capacity=5), TT.WindowTraceBook(capacity=5)]
    with JM.scoped_registry(), TM.scoped_registry():
        for w in range(8):
            for b in books:
                q = ("range", "knn")[w % 2]
                b.first_record(q, w * 5000, 1_700_000_000_000 + w)
                b.note(q, w * 5000, "window", clock[0], clock[0] + 0.001)
                b.note(q, w * 5000, "pane-seal", clock[0], clock[0] + 2e-7,
                       pane=w * 5000, records=w)
                b.note(q, w * 5000, "kernel", clock[0] + 0.001)
                b.seal(q, w * 5000, w * 5000 + 10000)
                b.note_any(w * 5000, "sink", clock[0], clock[0] + 0.002)
            clock[0] += 0.25
    j, t = books
    assert j.chrome_trace() == t.chrome_trace()
    assert j.recent(3) == t.recent(3)
    assert j.get("knn:35000") == t.get("knn:35000")
    assert (j.total, j.evicted) == (t.total, t.evicted) == (8, 3)
    rings = [JT.EventRing(3), TT.EventRing(3)]
    for r in rings:
        for k in range(5):
            r.append("checkpoint-committed", seq=k)
    assert [e["seq"] for e in rings[0].list(since=3)] == \
        [e["seq"] for e in rings[1].list(since=3)] == [4, 5]


def test_two_writers_grow_one_session_without_a_race():
    """Two threads record cells on one session while the arrays keep
    growing (every call reaches a cell past the current size): no writer
    indexes a grown array beside one not yet grown, and the three per-cell
    arrays end the same length. The JAX ``_ensure`` grows them one after
    another, which this interleaving breaks."""
    import sys

    tel = TT.Telemetry()
    errors = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def writer(seed):
        rng = np.random.default_rng(seed)
        try:
            for i in range(3000):
                hi = 8 + i * 3 + int(rng.integers(0, 3))
                if i % 2:
                    tel.record_cells(hi)
                else:
                    tel.record_cells(rng.integers(0, hi + 1, 16))
        except Exception as e:  # pragma: no cover - the failure mode
            errors.append(e)

    try:
        threads = [threading.Thread(target=writer, args=(s,))
                   for s in (1, 2)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
    finally:
        sys.setswitchinterval(old)
    assert errors == []
    sizes = {a.size for a in tel.costs._arrays}
    assert len(sizes) == 1 and sizes.pop() >= 9000
    assert tel.costs._records.sum() <= 2 * (1500 + 1500 * 16)


def test_device_plane_on_the_cpu():
    """Signatures (the JAX form), the sentinel's counts and strict abort,
    CPU provenance and memory rows, and a library noted once."""
    from spatialflink_tpu_torch.models import PointBatch

    reg = TDP.CompileRegistry()
    monkey_reg = TDP._REGISTRY
    TDP._REGISTRY = reg
    try:
        calls = []

        @TDP.instrumented_kernel(static=("n",))
        def kern(points, qx, radius, *, n, approximate=False):
            calls.append(1)
            return points.x.sum()

        pts = {k: PointBatch.from_arrays(
            np.zeros(k, np.float32), np.zeros(k, np.float32),
            device=torch.device("cpu")) for k in (100, 200, 300)}
        reg.begin_run(strict=False)
        kern(pts[100], 116.5, 0.5, n=100)
        kern(pts[200], 116.4, 0.25, n=100)   # same bucket: no compile
        assert reg.run_compiles == 1
        kern(pts[300], 116.4, 0.25, n=100)   # bucket 512
        kern(pts[300], 116.4, 0.25, n=50)    # a new static value
        assert reg.run_compiles == 3 and len(calls) == 4
        entry = kern.compile_entry
        sig = entry.signatures[0]["signature"]
        assert sig.startswith("(float32[256], float32[256], int32[256]")
        assert sig.endswith("float32[], float32[], n=100)")
        reg.mark_warm("test")
        kern(pts[100], 1.0, 1.0, n=100, approximate=True)
        assert reg.run_recompiles == 1 and entry.recompiles == 1
        reg.strict = True
        with pytest.raises(TDP.RecompileError):
            kern(pts[100], 1.0, 1.0, n=7)
        reg.strict = False
        reg.note_library("range_mask", 2.5, "")
        reg.note_library("range_mask")
        snap = reg.snapshot()
        assert snap["functions"] == 2 and snap["post_warmup_compiles"] == 3
        lib = [e for e in snap["entries"] if e["kind"] == "library"][0]
        assert lib["compiles"] == 1 and lib["backend_compile_ms"] == 2500.0
        reg.end_run()
        assert not reg.warm and not reg.strict
    finally:
        TDP._REGISTRY = monkey_reg
    prov = TDP.backend_provenance(device="cpu")
    assert prov["platform"] == "cpu" and not prov["valid_for_target"]
    assert prov["target"] == "gpu"
    assert TDP.device_memory("cpu") == [{"id": 0, "kind": "cpu",
                                         "available": False}]
    assert TDP.memory_gauges(device="cpu")["available"] is False
    block = TDP.status_block(None, TM.MetricsRegistry())
    assert set(block) == {"backend", "compiles", "run_compiles",
                          "recompiles", "warm", "strict", "mem_available",
                          "mem_bytes_in_use", "mem_peak_bytes", "d2h_bytes"}


def test_session_restores_the_observer_and_reporter_files(tmp_path):
    """The session chains onto the grid's cell observer (an observer
    already there stays first), restores it on exit even after an error,
    and the reporter writes >= 2 snapshots and a parseable metrics.prom."""
    from spatialflink_tpu_torch.index import uniform_grid as ug

    seen = []

    def prev(cells):
        seen.append(np.asarray(cells).copy())

    prev.each = lambda cells: seen.append(("each", len(cells)))
    ug._CELL_OBSERVER = prev
    try:
        with pytest.raises(KeyError), TM.scoped_registry():
            with TT.telemetry_session(str(tmp_path), 1000) as tel:
                ug.observe_cells(np.array([5, 5, 2]))
                ug.observe_each(np.array([1, 2]))
                raise KeyError("boom")
        assert ug._CELL_OBSERVER is prev and TT.active() is None
        assert tel.cells.top_k(3) == [(5, 2), (2, 2), (1, 1)]
        assert seen[0].tolist() == [5, 5, 2] and seen[1] == ("each", 2)
    finally:
        ug._CELL_OBSERVER = None
    lines = (tmp_path / "telemetry.jsonl").read_text().splitlines()
    assert len(lines) == 2
    snap = json.loads(lines[-1])
    assert snap["status"]["records_in"] == 0
    for line in (tmp_path / "metrics.prom").read_text().splitlines():
        assert line.startswith("# TYPE ") or " " in line


def test_degradation_snapshot_and_metered_match_jax():
    regs = [JM.MetricsRegistry(), TM.MetricsRegistry()]
    for reg in regs:
        for name, n in (("retry-attempts", 3), ("breaker-open", 0),
                        ("dlq-records", 2), ("batches-evaluated", 9)):
            reg.counter(name).inc(n)
    assert JM.degradation_snapshot(regs[0]) == \
        TM.degradation_snapshot(regs[1]) == {"dlq-records": 2,
                                              "retry-attempts": 3}
    m = TM.Meter("m")
    assert list(TM.metered(iter([1, 2, 3]), m)) == [1, 2, 3] and m.count == 3
    with pytest.raises(TM.ControlTupleExit):
        list(TM.metered(iter(['{"geometry": {"type": "control"}}']), m,
                        control_check=True))
    # outside a capture every range is the one shared null context
    assert TM.trace("x") is TM.trace("y")
    with TM.trace("x"):
        pass
