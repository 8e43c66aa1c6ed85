"""The chunk governor, the fast lane, tenant quotas and admission shedding
on the CPU: the port's ``runtime.control`` and ``runtime.queryplane``
against the JAX package's.

The JAX ``tests/test_control.py`` cases run against the port: the
power-of-two buckets, the policy's spec and its refusals, the control
law's directions, hysteresis, cooldown and bounds, the decisions ring and
``status()``, no new kernel signature across chunk resizes, the per-flush
callback and the ``SPATIALFLINK_DECODE_CHUNK`` pin, the fast lane (it
engages with an interactive fleet only, and its drain bound keeps the
results), the shed lifecycle end to end (429 on ``POST /queries``), the
realtime micro-batches' independence of the decode chunk, and the
``controller`` checkpoint component. The quota and shed cases of JAX
``tests/test_queryplane.py`` and ``tests/test_accounting.py`` follow.

Then the two packages side by side: the same scripted tick sequences give
the same chunk trajectory, decisions (clocks aside), ``status()``,
counters, events and ``controller`` component; a JAX-written component
resumes in the port and clamps to the port's bounds; the same admission
script gives the same states, quota refusals and shed parking.
"""

import json

import numpy as np
import pytest
import torch

from spatialflink_tpu import driver as JD
from spatialflink_tpu import operators as JOps
from spatialflink_tpu.config import StreamConfig as JStreamConfig
from spatialflink_tpu.index import UniformGrid as JGrid
from spatialflink_tpu.models import Point as JPoint
from spatialflink_tpu.runtime import checkpoint as JCK
from spatialflink_tpu.runtime import control as JC
from spatialflink_tpu.runtime import queryplane as JQ
from spatialflink_tpu.utils import metrics as JM
from spatialflink_tpu.utils import telemetry as JT
from spatialflink_tpu.utils.accounting import QuotaExceeded as JQuota

from spatialflink_tpu_torch import driver as TD
from spatialflink_tpu_torch.config import StreamConfig
from spatialflink_tpu_torch.index import UniformGrid
from spatialflink_tpu_torch.models import Point
from spatialflink_tpu_torch.operators import (PointPointKNNQuery,
                                              PointPointRangeQuery,
                                              QueryConfiguration, QueryType)
from spatialflink_tpu_torch.runtime import checkpoint as TCK
from spatialflink_tpu_torch.runtime import control as TC
from spatialflink_tpu_torch.runtime import queryplane as TQ
from spatialflink_tpu_torch.runtime.control import (KNEE_CHUNK, ChunkGovernor,
                                                    GovernorPolicy,
                                                    chunk_bucket)
from spatialflink_tpu_torch.runtime.opserver import OpServer
from spatialflink_tpu_torch.runtime.queryplane import (QueryRegistry,
                                                       QueryState)
from spatialflink_tpu_torch.runtime.windows import MicroBatcher
from spatialflink_tpu_torch.utils import deviceplane
from spatialflink_tpu_torch.utils import metrics as TM
from spatialflink_tpu_torch.utils import telemetry as TT
from spatialflink_tpu_torch.utils.accounting import QuotaExceeded

from test_torch_opserver import _isolated, strip  # noqa: F401

torch.set_num_threads(1)

GRID = UniformGrid(115.5, 117.6, 39.6, 41.1, num_grid_partitions=100)
JGRID = JGrid(115.5, 117.6, 39.6, 41.1, num_grid_partitions=100)
CFG = StreamConfig(format="CSV", date_format=None, csv_tsv_schema=[0, 1, 2, 3])
JCFG = JStreamConfig(format="CSV", date_format=None,
                     csv_tsv_schema=[0, 1, 2, 3])


def _lines(n, span_ms=100_000, seed=0):
    rng = np.random.default_rng(seed)
    t0 = 1_700_000_000_000
    return [f"v{i % 97},{t0 + i * span_ms // n},"
            f"{115.5 + rng.random() * 2:.6f},"
            f"{39.6 + rng.random() * 1.5:.6f}" for i in range(n)]


def _bucket(dominant=None, stall=False, depth=0):
    deltas = {} if dominant is None else {dominant: 1.0, "emit": 0.1}
    return {"stage_delta_s": deltas, "stall": stall,
            "decode_buffer_depth": depth}


def _stream(lines, chunk):
    return TD.ChunkedStream(TD.decode_chunks(iter(lines), CFG, GRID, chunk))


def _range(conf, lines, chunk=4096, radius=0.5, q=(116.5, 40.3)):
    op = PointPointRangeQuery(conf, GRID, device="cpu")
    qp = Point.create(*q, GRID, obj_id="q")
    return [(r.window_start, r.window_end,
             sorted(p.obj_id for p in r.records))
            for r in op.run(_stream(lines, chunk), qp, radius)]


# ------------------------------------------------------------------ units


class TestChunkBucket:
    def test_snaps_to_nearest_power_of_two(self):
        assert chunk_bucket(1000) == 1024
        assert chunk_bucket(1536) == 1024   # an exact tie keeps the floor
        assert chunk_bucket(1537) == 2048
        assert chunk_bucket(4096) == 4096

    def test_clamps_to_bounds(self):
        assert chunk_bucket(100000, 256, 8192) == 8192
        assert chunk_bucket(3, 256, 8192) == 256

    def test_matches_jax(self):
        for n in list(range(1, 70)) + [1535, 1536, 1537, 3 << 20]:
            for lo, hi in ((1, 1 << 20), (256, 8192)):
                assert chunk_bucket(n, lo, hi) == JC.chunk_bucket(n, lo, hi)


class TestPolicy:
    def test_from_spec_roundtrip_and_defaults(self):
        p = GovernorPolicy.from_spec("")
        assert p.target_p99_ms == GovernorPolicy().target_p99_ms
        p = GovernorPolicy.from_spec(
            "target_p99_ms=150,min_chunk=512,confirm_ticks=1")
        assert (p.target_p99_ms, p.min_chunk, p.confirm_ticks) == (
            150.0, 512, 1)
        assert p == GovernorPolicy(**JC.GovernorPolicy.from_spec(
            "target_p99_ms=150,min_chunk=512,confirm_ticks=1").__dict__)

    @pytest.mark.parametrize("spec", [
        "min_chunk=1000", "min_chunk=8192,max_chunk=256", "target_p99_ms=0",
        "nonsense=5", "confirm_ticks=oops", "confirm_ticks",
        "idle_headroom=2", "fast_lane_depth=0", "cooldown_ticks=-1",
    ])
    def test_bad_specs_raise_as_jax(self, spec):
        with pytest.raises(ValueError) as got:
            GovernorPolicy.from_spec(spec)
        with pytest.raises(ValueError) as want:
            JC.GovernorPolicy.from_spec(spec)
        assert str(got.value) == str(want.value)


class TestGovernorConvergence:
    def _gov(self, **kw):
        kw.setdefault("confirm_ticks", 2)
        kw.setdefault("cooldown_ticks", 0)
        return ChunkGovernor(policy=GovernorPolicy(**kw))

    @pytest.mark.parametrize("dominant,stall,p99,want", [
        ("queue", False, 400.0, KNEE_CHUNK // 2),
        ("buffer", False, 400.0, KNEE_CHUNK // 2),
        ("dispatch", True, 10.0, KNEE_CHUNK // 2),
        ("dispatch", False, 100.0, KNEE_CHUNK * 2),
        (None, False, 10.0, KNEE_CHUNK * 2),
    ])
    def test_direction(self, dominant, stall, p99, want):
        gov = self._gov()
        for _ in range(2):
            gov.on_tick(_bucket(dominant=dominant, stall=stall), p99)
        assert gov.chunk() == want
        assert (gov.grows, gov.shrinks) == ((1, 0) if want > KNEE_CHUNK
                                            else (0, 1))

    def test_breach_without_wait_dominance_holds(self):
        gov = self._gov()
        for _ in range(6):
            gov.on_tick(_bucket(dominant="dispatch"), 400.0)
        assert gov.chunk() == KNEE_CHUNK

    def test_hysteresis_single_tick_never_steps(self):
        gov = self._gov(confirm_ticks=2)
        gov.on_tick(_bucket(dominant="queue"), 400.0)
        assert gov.chunk() == KNEE_CHUNK

    def test_hysteresis_alternating_directions_never_step(self):
        gov = self._gov(confirm_ticks=2)
        for _ in range(4):
            gov.on_tick(_bucket(dominant="queue"), 400.0)
            gov.on_tick(_bucket(dominant="dispatch"), 10.0)
        assert gov.chunk() == KNEE_CHUNK

    def test_cooldown_quiets_after_step(self):
        gov = self._gov(confirm_ticks=1, cooldown_ticks=2)
        gov.on_tick(_bucket(dominant="queue"), 400.0)
        assert gov.chunk() == KNEE_CHUNK // 2
        gov.on_tick(_bucket(dominant="queue"), 400.0)
        gov.on_tick(_bucket(dominant="queue"), 400.0)
        assert gov.chunk() == KNEE_CHUNK // 2
        gov.on_tick(_bucket(dominant="queue"), 400.0)
        assert gov.chunk() == KNEE_CHUNK // 4

    def test_bounds_clamp_and_count_no_phantom_steps(self):
        gov = self._gov(confirm_ticks=1, min_chunk=1024, max_chunk=4096)
        for _ in range(10):
            gov.on_tick(_bucket(dominant="queue"), 400.0)
        assert gov.chunk() == 1024 and gov.shrinks == 1
        for _ in range(10):
            gov.on_tick(_bucket(dominant="dispatch"), 10.0)
        assert gov.chunk() == 4096 and gov.grows == 2

    def test_decisions_ring_bounded_with_schema(self):
        gov = self._gov(confirm_ticks=1)
        for i in range(80):
            gov.on_tick(_bucket(dominant="queue" if i % 2 else "dispatch"),
                        400.0 if i % 2 else 10.0)
        st = gov.status()
        assert len(st["decisions"]) <= 32
        assert {"ts_ms", "tick", "action", "chunk",
                "p99_emit_ms"} <= set(st["decisions"][-1])
        assert st["ticks"] == 80

    def test_status_schema(self):
        st = ChunkGovernor().status()
        assert set(st) == set(JC.ChunkGovernor().status())
        assert st["chunk"] == KNEE_CHUNK

    def test_export_sets_the_gauges(self):
        with TM.scoped_registry() as reg, TT.telemetry_session() as tel:
            gov = self._gov(confirm_ticks=1).install()
            try:
                gov.on_tick(_bucket(dominant="queue"), 400.0)
            finally:
                gov.uninstall()
            digest = TT.status_snapshot(tel)["status"]["controller"]
            assert digest == {"chunk": KNEE_CHUNK // 2, "fast_lane": False,
                              "shedding": False, "grows": 0, "shrinks": 1,
                              "sheds": 0}
            assert reg.counter("chunk-shrink").count == 1
            assert [e["kind"] for e in tel.events.list()] == [
                "chunk-governor"]


# ----------------------------------------- no new signature on a resize


class TestZeroRecompileAcrossResizes:
    def test_live_resizes_never_recompile(self):
        """The same windowed run at every chunk bucket the governor can
        visit: after the first warms, the compile registry sees no new
        kernel signature (the chunk sizes host buffers only)."""
        lines = _lines(1200)
        conf = QueryConfiguration(QueryType.WindowBased, 10_000, 5_000)
        reg = deviceplane.registry()
        reg.begin_run(strict=False)
        try:
            base = _range(conf, lines, 256)
            reg.mark_warm("chunk-resize test (first bucket warmed)")
            for chunk in (512, 1024, 2048, 4096, 8192):
                assert _range(conf, lines, chunk) == base, chunk
            assert reg.run_recompiles == 0
        finally:
            reg.end_run()

    def test_governed_callback_resolves_per_flush(self):
        gov = ChunkGovernor(policy=GovernorPolicy(confirm_ticks=1,
                                                  cooldown_ticks=0))
        gov.install()
        try:
            cb = TD._governed_chunk(4096)
            assert callable(cb) and cb() == KNEE_CHUNK
            gov.on_tick(_bucket(dominant="queue"), 999.0)
            assert cb() == KNEE_CHUNK // 2
        finally:
            gov.uninstall()
        assert cb() == 4096

    def test_env_pin_wins_over_governor(self, monkeypatch):
        monkeypatch.setenv("SPATIALFLINK_DECODE_CHUNK", "64")
        gov = ChunkGovernor().install()
        try:
            assert TD._governed_chunk(TD._decode_chunk_env(4096)) == 64
            assert TD._governed_chunk(300, pinned=True) == 300
        finally:
            gov.uninstall()

    def test_decode_reads_the_callback_at_each_buffer_start(self):
        """A resize lands between chunks: each chunk is as long as the
        size read when its buffer started."""
        sizes = iter([100, 40, 40, 7, 1000])
        chunks = list(TD.decode_chunks(iter(_lines(300)), CFG, GRID,
                                       lambda: next(sizes)))
        assert [len(c) for c in chunks] == [100, 40, 40, 7, 113]

    def test_kafka_tap_reads_the_callback_at_each_take(self):
        from spatialflink_tpu_torch.streams import kafka as K

        sizes = iter([64, 16, 1000])
        tap = K.WindowCommitTap.__new__(K.WindowCommitTap)
        tap._bulk_chunk = lambda: next(sizes)
        assert [tap.bulk_chunk, tap.bulk_chunk, tap.bulk_chunk] == [
            64, 16, 1000]
        tap._bulk_chunk = 7
        assert tap.bulk_chunk == 7


# ------------------------------------------------------ fast lane / shed


def _registry_with(*classes, Q=TQ):
    reg = Q.QueryRegistry("range", radius=0.5)
    for i, lclass in enumerate(classes):
        reg.admit({"id": f"q{i}", "x": 116.5, "y": 40.3,
                   "latency_class": lclass})
    reg.apply()
    return reg


class TestFastLane:
    def test_engages_with_interactive_fleet_only(self):
        gov = ChunkGovernor(policy=GovernorPolicy(interactive_max_chunk=512,
                                                  fast_lane_depth=1))
        reg = _registry_with("batch", "batch").install()
        try:
            gov.on_tick(_bucket(), None)
            assert not gov.fast_lane and gov.chunk() == KNEE_CHUNK
            assert gov.drain_depth(4) == 4
        finally:
            reg.uninstall()
        reg = _registry_with("batch", "interactive").install()
        try:
            gov.on_tick(_bucket(), None)
            assert gov.fast_lane and gov.chunk() == 512
            assert gov.drain_depth(4) == 1
        finally:
            reg.uninstall()

    def test_disengages_when_interactive_retires(self):
        gov = ChunkGovernor(policy=GovernorPolicy(interactive_max_chunk=512))
        reg = _registry_with("interactive").install()
        try:
            gov.on_tick(_bucket(dominant="dispatch"), 400.0)
            assert gov.fast_lane
            reg.retire("q0")
            reg.apply()
            gov.on_tick(_bucket(dominant="dispatch"), 400.0)
            assert not gov.fast_lane and gov.chunk() == KNEE_CHUNK
        finally:
            reg.uninstall()

    @pytest.mark.parametrize("depth", [1, 2, 4])
    def test_fast_lane_depth_bound_keeps_results_identical(self, depth):
        """The fast lane's drain bound changes the scheduling only: a
        deep pipeline under the engaged lane (in flight bounded to
        ``depth``) gives the ungoverned run's windows, which equal the
        JAX operator's."""
        lines = _lines(800)
        conf = QueryConfiguration(QueryType.WindowBased, 10_000, 5_000,
                                  pipeline_depth=4)
        base = _range(conf, lines)
        gov = ChunkGovernor(policy=GovernorPolicy(
            fast_lane_depth=depth)).install()
        reg = _registry_with("interactive").install()
        try:
            gov.on_tick(_bucket(), None)
            assert gov.fast_lane and gov.drain_depth(4) == depth
            assert _range(conf, lines) == base
        finally:
            reg.uninstall()
            gov.uninstall()
        jop = JOps.PointPointRangeQuery(
            JOps.QueryConfiguration(JOps.QueryType.WindowBased, 10_000,
                                    5_000), JGRID)
        want = [(r.window_start, r.window_end,
                 sorted(p.obj_id for p in r.records))
                for r in jop.run(JD.decode_stream(iter(lines), JCFG, JGRID),
                                 JPoint.create(116.5, 40.3, JGRID), 0.5)]
        assert base == want

    def test_latency_class_validation_and_serialization(self):
        reg = QueryRegistry("range", radius=0.5)
        with pytest.raises(ValueError):
            reg.admit({"id": "bad", "x": 116.5, "y": 40.3,
                       "latency_class": "urgent"})
        e = reg.admit({"id": "q", "x": 116.5, "y": 40.3,
                       "latency_class": "interactive"})
        assert e.spec.to_dict()["latency_class"] == "interactive"
        e2 = reg.admit({"id": "q2", "x": 116.5, "y": 40.3})
        assert "latency_class" not in e2.spec.to_dict()
        assert e2.spec.latency_class == "batch"

    def test_default_latency_class_applies_to_admissions(self):
        reg = QueryRegistry("range", radius=0.5,
                            default_latency_class="interactive")
        e = reg.admit({"id": "q", "x": 116.5, "y": 40.3})
        assert e.spec.latency_class == "interactive"
        assert not reg.has_interactive()  # PENDING: not serving yet
        reg.apply()
        assert reg.has_interactive()


class TestShedLifecycle:
    def _gov(self):
        return ChunkGovernor(policy=GovernorPolicy(shed_after_stalls=2,
                                                   unshed_after_clean=2))

    def test_shed_and_unshed_transitions(self):
        gov = self._gov()
        reg = _registry_with("batch").install()
        try:
            gov.on_tick(_bucket(stall=True), None)
            assert not reg.shedding
            gov.on_tick(_bucket(stall=True), None)
            assert reg.shedding and gov.shedding
            e = reg.admit({"id": "late", "x": 116.5, "y": 40.3})
            assert e.state is QueryState.SHED
            assert reg.staged_count() == 0
            gov.on_tick(_bucket(), None)
            assert reg.shedding
            gov.on_tick(_bucket(), None)
            assert not reg.shedding
            assert reg._entries["late"].state is QueryState.PENDING
            reg.apply()
            assert reg._entries["late"].state is QueryState.ACTIVE
        finally:
            reg.uninstall()

    def test_post_queries_returns_429_while_shedding(self):
        reg = _registry_with("batch").install()
        try:
            srv = OpServer(port=0)
            reg.set_shedding(True)
            code, payload = srv.admit_query_payload(
                {"id": "nope", "x": 116.5, "y": 40.3})
            assert code == 429 and payload["query"]["state"] == "shed"
            assert "shed" in payload["error"]
            reg.set_shedding(False)
            code, payload = srv.admit_query_payload(
                {"id": "nope", "x": 116.5, "y": 40.3})
            assert code == 200
        finally:
            reg.uninstall()

    def test_retire_while_shed_is_immediate(self):
        reg = _registry_with("batch")
        reg.set_shedding(True)
        reg.admit({"id": "parked", "x": 116.5, "y": 40.3})
        assert reg.retire("parked").state is QueryState.RETIRED

    def test_shed_state_rides_registry_snapshot(self):
        reg = _registry_with("batch")
        reg.set_shedding(True)
        reg.admit({"id": "parked", "x": 116.5, "y": 40.3})
        reg2 = QueryRegistry("range", radius=0.5)
        reg2.restore(reg.snapshot())
        assert reg2.shedding
        assert reg2._entries["parked"].state is QueryState.SHED

    def test_shed_flip_asks_for_a_repartition_epoch(self):
        calls = []

        class Ctl:
            def request_epoch(self):
                calls.append(1)

        from spatialflink_tpu_torch.runtime import repartition as R

        old = R._ACTIVE
        R._ACTIVE = Ctl()
        try:
            gov = self._gov()
            for _ in range(2):
                gov.on_tick(_bucket(stall=True), None)
        finally:
            R._ACTIVE = old
        assert calls == [1]


# ------------------------------------------------ quotas (queryplane /
# accounting cases)


class TestQuotaAdmission:
    def test_max_active_blocks_then_releases(self):
        with TM.scoped_registry() as counters:
            reg = QueryRegistry("range", radius=0.5,
                                tenant_quotas={"acme": {"max_active": 1}})
            reg.admit({"id": "a", "x": 1, "y": 2, "tenant": "acme"})
            with pytest.raises(QuotaExceeded, match="max_active"):
                reg.admit({"id": "b", "x": 1, "y": 2, "tenant": "acme"})
            assert counters.counter("queries-quota-rejected").count == 1
            reg.admit({"id": "c", "x": 1, "y": 2, "tenant": "free"})
            reg.admit({"id": "a", "x": 3, "y": 3, "tenant": "acme"})
            assert "b" not in {e["id"] for e in reg.status()["queries"]}
            reg.retire("a")
            reg.apply()
            reg.admit({"id": "b", "x": 1, "y": 2, "tenant": "acme"})

    def test_rate_quota_uses_the_ledger(self):
        with TM.scoped_registry(), TT.telemetry_session() as tel:
            tel.tenants.note_dispatch("op", 1_700_000_000_000, 5.0, 100,
                                      4096)
            tel.tenants.resolve("op", 1_700_000_000_000,
                                [("q-acme", "acme", 1.0)])
            reg = QueryRegistry("range", radius=0.5, tenant_quotas={
                "acme": {"max_active": 99, "kernel_ms_s": 0.001}})
            with pytest.raises(QuotaExceeded, match="kernel_ms_s"):
                reg.admit({"id": "a", "x": 1, "y": 2, "tenant": "acme"})
            assert tel.tenants.to_dict()["tenants"]["acme"][
                "quota_rejections"] == 1

    def test_quota_state_rides_registry_snapshot(self):
        reg = QueryRegistry("range", radius=0.5, default_tenant="house",
                            tenant_quotas={"acme": {"max_active": 2}})
        reg.admit({"id": "a", "x": 1, "y": 2})
        reg.apply()
        snap = json.loads(json.dumps(reg.snapshot()))
        reg2 = QueryRegistry("range", radius=0.5)
        reg2.restore(snap)
        assert reg2.default_tenant == "house"
        assert reg2.tenant_quotas == {"acme": {"max_active": 2}}
        assert reg2.active_entries()[0].spec.tenant == "house"
        st = reg2.status()
        assert st["default_tenant"] == "house"
        assert st["tenant_quotas"]["acme"]["max_active"] == 2

    def test_shed_is_not_quota(self):
        with TM.scoped_registry(), TT.telemetry_session() as tel:
            reg = QueryRegistry("range", radius=0.5)
            reg.shedding = True
            e = reg.admit({"id": "a", "x": 1, "y": 2, "tenant": "acme"})
            assert e.state.value == "shed"
            assert tel.tenants.to_dict()["tenants"]["acme"]["shed"] == 1

    def test_quota_429_distinct_from_shed_on_post(self):
        reg = QueryRegistry("range", radius=0.5, tenant_quotas={
            "acme": {"max_active": 1}}).install()
        try:
            srv = OpServer()
            assert srv.admit_query_payload(
                {"id": "a", "x": 1, "y": 2, "tenant": "acme"})[0] == 200
            code, doc = srv.admit_query_payload(
                {"id": "b", "x": 1, "y": 2, "tenant": "acme"})
            assert code == 429 and doc["error"].startswith("quota-exceeded")
            assert doc["tenant"] == "acme"
            reg.shedding = True
            code, doc = srv.admit_query_payload(
                {"id": "c", "x": 1, "y": 2, "tenant": "free"})
            assert code == 429 and "admission shed" in doc["error"]
            assert doc["query"]["state"] == "shed"
        finally:
            reg.uninstall()

    def test_control_topic_rejects_a_quota_breach(self):
        from spatialflink_tpu_torch.streams import kafka as K

        K.reset_memory_brokers()
        broker = K.resolve_broker("memory://quota")
        for rec in ({"action": "admit", "query": {"id": "a", "x": 1, "y": 2,
                                                  "tenant": "acme"}},
                    {"action": "admit", "query": {"id": "b", "x": 1, "y": 2,
                                                  "tenant": "acme"}}):
            broker.produce("ctl", json.dumps(rec))
        reg = QueryRegistry("range", radius=0.5, tenant_quotas={
            "acme": {"max_active": 1}})
        with TM.scoped_registry() as counters:
            consumer = TQ.ControlTopicConsumer(broker, "ctl")
            reg.attach_control(consumer)
            reg.apply()
            assert counters.counter("control-records-rejected").count == 1
        assert [e.id for e in reg.active_entries()] == ["a"]
        assert consumer.rejected == 1
        K.reset_memory_brokers()


# ------------------------------------- realtime on the vectorized path


class TestRealtimeVectorizedIdentity:
    def _conf(self, batch=64, depth=2):
        return QueryConfiguration(QueryType.RealTime,
                                  realtime_batch_size=batch,
                                  pipeline_depth=depth)

    def test_microbatcher_cuts_match_scalar_micro_batches(self):
        """The port's cuts at a 176-record decode chunk equal the JAX
        operator's scalar count cuts (its pre-vectorized oracle)."""
        lines = _lines(1000)
        got = [(a, b, len(recs)) for a, b, recs in
               MicroBatcher(64).batches(TD.decode_chunks(
                   iter(lines), CFG, GRID, 176))]
        jop = JOps.PointPointRangeQuery(JOps.QueryConfiguration(
            JOps.QueryType.RealTime, realtime_batch_size=64), JGRID)
        want = [(r[0].timestamp, r[-1].timestamp, len(r))
                for r in jop._micro_batches(iter(
                    JD.decode_stream(iter(lines), JCFG, JGRID))) if r]
        assert got == want

    @pytest.mark.parametrize("chunk", [32, 176, 512, 4096])
    def test_realtime_results_identical_across_decode_chunks(self, chunk):
        lines = _lines(900)
        assert _range(self._conf(), lines, chunk) == \
            _range(self._conf(), lines, 64)

    def test_realtime_vs_scalar_oracle_full_results(self):
        """The port's realtime windows equal the JAX operator's drive
        loop fed by its scalar micro-batch generator (the pre-vectorized
        branch), at a decode chunk that is no multiple of the batch."""
        lines = _lines(700)
        got = _range(self._conf(), lines, 200)
        jop = JOps.PointPointRangeQuery(JOps.QueryConfiguration(
            JOps.QueryType.RealTime, realtime_batch_size=64,
            pipeline_depth=2), JGRID)
        qp = JPoint.create(116.5, 40.3, JGRID, obj_id="q")
        batched = ((r[0].timestamp, r[-1].timestamp, r)
                   for r in jop._micro_batches(iter(JD.decode_stream(
                       iter(lines), JCFG, JGRID))) if r)
        mask_cache = jop._leaf_mask_cache(
            lambda: jop.conf.adaptive_grid.neighboring_leaf_mask(
                0.5, qp.cell, point=(qp.x, qp.y)))
        want = [(r.window_start, r.window_end,
                 sorted(p.obj_id for p in r.records))
                for r in jop._drive_batched(
                    batched,
                    lambda recs, ts: jop._eval(recs, qp, 0.5, ts,
                                               mask_cache),
                    realtime=True)]
        assert got == want and len(got) > 5

    def test_realtime_under_a_governor_equals_the_jax_run(self):
        """Realtime through run_option's decode with a governor installed
        at a chunk far from the micro-batch: the JAX driver's windows."""
        from spatialflink_tpu.config import Params as JParams
        from spatialflink_tpu_torch.config import Params as TParams

        import test_torch_realtime as RT

        gov = ChunkGovernor(seed_chunk=256, policy=GovernorPolicy(
            min_chunk=256)).install()
        try:
            got = RT._windows(TD.run_option(RT._params(TParams, 2),
                                            iter(RT.LINES), device="cpu"))
        finally:
            gov.uninstall()
        want = RT._windows(JD.run_option(RT._params(JParams, 2),
                                         iter(RT.LINES)))
        assert got == want and len(got) > 3

    def test_realtime_knn_rides_the_vectorized_path_too(self):
        lines = _lines(600)
        qp = Point.create(116.5, 40.3, GRID, obj_id="q")

        def run(c):
            op = PointPointKNNQuery(self._conf(), GRID, device="cpu")
            return [(r.window_start,
                     sorted((oid, round(float(d), 6))
                            for oid, d in r.records))
                    for r in op.run(_stream(lines, c), qp, 0.5)]

        assert run(100) == run(64)

    def test_trailing_partial_batch_fires(self):
        sizes = [len(recs) for _, _, recs in MicroBatcher(64).batches(
            TD.decode_chunks(iter(_lines(130)), CFG, GRID, 4096))]
        assert sizes == [64, 64, 2]

    def test_realtime_never_emits_empty_selections(self):
        assert _range(self._conf(), _lines(300), radius=0.0001,
                      q=(115.6, 39.7)) == []

    def test_realtime_feeds_latency_plane(self):
        with TT.telemetry_session(None) as tel:
            out = _range(self._conf(), _lines(400))
            assert out
            snap = tel.latency.to_dict()
        assert snap["record_emit"]["count"] >= len(out)


# --------------------------------------------- checkpoint / resume


class TestCheckpointMidAdjustment:
    def _mid_adjustment(self, gov):
        for _ in range(2):
            gov.on_tick(_bucket(dominant="queue"), 999.0)
        gov.on_tick(_bucket(dominant="queue", stall=True), 999.0)

    def test_controller_component_roundtrips(self, tmp_path):
        coord = TCK.CheckpointCoordinator(str(tmp_path), job="j")
        gov = ChunkGovernor(policy=GovernorPolicy(
            confirm_ticks=2, cooldown_ticks=1, shed_after_stalls=3))
        gov.register_checkpoint(coord)
        self._mid_adjustment(gov)
        st = gov.status()
        assert st["base_chunk"] == KNEE_CHUNK // 2
        coord.commit()
        coord2 = TCK.CheckpointCoordinator(str(tmp_path), job="j")
        assert coord2.load()
        gov2 = ChunkGovernor()
        gov2.register_checkpoint(coord2)
        st2 = gov2.status()
        assert (st2["base_chunk"], st2["streak"], st2["shedding"]) == (
            st["base_chunk"], st["streak"], st["shedding"])

    def test_restored_chunk_clamps_to_new_policy_bounds(self, tmp_path):
        coord = TCK.CheckpointCoordinator(str(tmp_path), job="j")
        ChunkGovernor(seed_chunk=8192).register_checkpoint(coord)
        coord.commit()
        coord2 = TCK.CheckpointCoordinator(str(tmp_path), job="j")
        assert coord2.load()
        gov2 = ChunkGovernor(policy=GovernorPolicy(max_chunk=1024))
        gov2.register_checkpoint(coord2)
        assert gov2.chunk() == 1024

    def test_open_micro_batch_snapshot_restore_identity(self):
        """A stream cut mid-batch: the open batch snapshotted (through
        JSON, as a checkpoint holds it), restored into a new batcher and
        continued with the remaining chunks gives the uninterrupted
        batches: no record lost or doubled, no boundary moved."""
        lines = _lines(500)
        enc, dec = TCK.record_codec(GRID)

        def form(a, b, recs):
            cols = recs.columns()
            return a, b, cols[2].tolist(), cols[0].tolist()

        want = [form(*b) for b in MicroBatcher(64).batches(
            TD.decode_chunks(iter(lines), CFG, GRID, 96))]
        chunks = TD.decode_chunks(iter(lines), CFG, GRID, 96)
        mb, got = MicroBatcher(64), []
        for i, ch in enumerate(chunks):
            got.extend(form(*b) for b in mb.add_chunk(ch))
            if i == 2:
                break
        state = json.loads(json.dumps(mb.snapshot(enc)))
        assert state["records"], "the cut holds an open micro-batch"
        mb2 = MicroBatcher(64)
        mb2.restore(state, dec)
        got.extend(form(*b) for b in mb2.batches(chunks))
        assert got == want

    def test_realtime_drive_registers_batcher_with_coordinator(self,
                                                               tmp_path):
        coord = TCK.CheckpointCoordinator(str(tmp_path), job="j")
        conf = QueryConfiguration(QueryType.RealTime, realtime_batch_size=64,
                                  checkpointer=coord)
        op = PointPointRangeQuery(conf, GRID, device="cpu")
        list(op.run(_stream(_lines(300), 4096),
                    Point.create(116.5, 40.3, GRID, obj_id="q"), 0.5))
        assert "realtime-batcher" in coord._snapshots

    @pytest.mark.parametrize("max_chunk", [8192, 512])
    def test_jax_written_component_resumes_in_the_port(self, tmp_path,
                                                       max_chunk):
        """A JAX governor's checkpoint (mid-streak, a stall banked)
        resumes in the port's: the same streaks, shed state and ticks,
        the chunk clamped to the port policy's bounds."""
        coord = JCK.CheckpointCoordinator(str(tmp_path), job="j")
        jgov = JC.ChunkGovernor(seed_chunk=4096, policy=JC.GovernorPolicy(
            confirm_ticks=2, cooldown_ticks=1, shed_after_stalls=3))
        jgov.register_checkpoint(coord)
        self._mid_adjustment(jgov)
        coord.commit()
        coord2 = TCK.CheckpointCoordinator(str(tmp_path), job="j")
        assert coord2.load()
        gov = ChunkGovernor(policy=GovernorPolicy(
            min_chunk=256, max_chunk=max_chunk, confirm_ticks=2,
            cooldown_ticks=1, shed_after_stalls=3))
        gov.register_checkpoint(coord2)
        got, want = gov.status(), jgov.status()
        assert got["base_chunk"] == min(want["base_chunk"], max_chunk)
        for key in ("streak", "shedding", "ticks"):
            assert got[key] == want[key]
        # the resumed law continues where the JAX one stood
        gov.on_tick(_bucket(dominant="queue", stall=True), 999.0)
        jgov.on_tick(_bucket(dominant="queue", stall=True), 999.0)
        got, want = gov.status(), jgov.status()
        for key in ("streak", "shedding", "ticks", "sheds"):
            assert got[key] == want[key]
        if max_chunk == 8192:
            assert got["chunk"] == want["chunk"]


# ----------------------------------------- both packages side by side


def _tick_script(seed=5, n=120):
    """(bucket, p99) ticks over every branch of the law: waits with and
    without a breach, dispatch-bound, idle, stalls in runs (shedding)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        dom = rng.choice(["queue", "buffer", "dispatch", "emit", "none"])
        stall = bool(i % 37 in (10, 11, 12, 13)) or rng.random() < 0.05
        p99 = None if rng.random() < 0.1 else float(rng.uniform(0, 500))
        b = _bucket(None if dom == "none" else str(dom), stall=stall)
        if rng.random() < 0.1:
            b["stage_delta_s"] = {"queue": 0.0, "dispatch": 0.0}
        out.append((b, p99))
    return out


def _drive(C, Q, M, T, policy, script, classes):
    """One package's governor over ``script`` with a registry of
    ``classes`` installed; the interactive query retires midway and a
    late admission meets the shed state."""
    with M.scoped_registry() as reg, T.telemetry_session() as tel:
        fleet = _registry_with(*classes, Q=Q).install()
        gov = C.ChunkGovernor(policy=C.GovernorPolicy(**policy)).install()
        trail = []
        try:
            for i, (bucket, p99) in enumerate(script):
                if i == len(script) // 2 and "interactive" in classes:
                    fleet.retire(f"q{classes.index('interactive')}")
                    fleet.apply()
                if i % 25 == 24:
                    fleet.admit({"id": f"late{i}", "x": 116.0, "y": 40.0})
                gov.on_tick(bucket, p99)
                trail.append((gov.chunk(), gov.status()["base_chunk"],
                              gov.fast_lane, gov.shedding,
                              gov.drain_depth(3)))
            component = {}

            class Coord:
                def register(self, name, snap, restore):
                    component[name] = snap()

            gov.register_checkpoint(Coord())
            counters = {k: v for k, v in reg.snapshot().items()
                        if not k.endswith(".rate")}
            events = strip(tel.events.list())
            status = strip(gov.status())
            digest = T.status_snapshot(tel)["status"]["controller"]
            states = {e["id"]: e["state"]
                      for e in fleet.status()["queries"]}
        finally:
            gov.uninstall()
            fleet.uninstall()
    return {"trail": trail, "status": status, "counters": counters,
            "events": events, "component": component, "digest": digest,
            "states": states}


@pytest.mark.parametrize("policy,classes", [
    ({}, ("batch",)),
    ({"confirm_ticks": 1, "cooldown_ticks": 0, "min_chunk": 512,
      "max_chunk": 4096}, ("batch", "interactive")),
    ({"confirm_ticks": 3, "cooldown_ticks": 2, "target_p99_ms": 150.0,
      "shed_after_stalls": 1, "unshed_after_clean": 3,
      "interactive_max_chunk": 256, "idle_headroom": 0.9},
     ("interactive",)),
])
def test_tick_sequences_match_jax(policy, classes):
    script = _tick_script()
    got = _drive(TC, TQ, TM, TT, policy, script, classes)
    want = _drive(JC, JQ, JM, JT, policy, script, classes)
    for key in want:
        assert got[key] == want[key], key
    assert len({base for _, base, *_ in want["trail"]}) > 2
    assert want["status"]["grows"] + want["status"]["shrinks"] >= 2
    assert want["status"]["sheds"]


def test_admission_script_matches_jax():
    """Quotas, shedding, updates of parked specs, retirements and the
    registry's checkpoint component: the same states, errors, counters
    and events in both packages."""
    steps = [
        ("admit", {"id": "a", "x": 1, "y": 2, "tenant": "acme"}),
        ("admit", {"id": "b", "x": 1, "y": 2, "tenant": "acme"}),
        ("admit", {"id": "c", "x": 1, "y": 2, "tenant": "acme"}),
        ("apply",), ("shed", True),
        ("admit", {"id": "d", "x": 3, "y": 4}),
        ("admit", {"id": "d", "x": 5, "y": 6}),
        ("update", "d", {"route": "file:x"}),
        ("admit", {"id": "e", "x": 3, "y": 4, "tenant": "acme"}),
        ("update", "a", {"latency_class": "interactive"}),
        ("retire", "b"), ("apply",), ("shed", False), ("shed", False),
        ("apply",), ("retire", "d"),
        ("admit", {"id": "f", "x": 3, "y": 4, "tenant": "acme"}),
        ("admit", {"id": "g", "x": 3, "y": 4, "tenant": "acme"}),
        ("apply",),
    ]

    def run(Q, M, T, Quota):
        with M.scoped_registry() as reg, T.telemetry_session() as tel:
            r = Q.QueryRegistry("range", radius=0.5, default_tenant="house",
                                tenant_quotas={"acme": {"max_active": 2}})
            out = []
            for op, *args in steps:
                try:
                    if op == "shed":
                        res = r.set_shedding(*args)
                    else:
                        res = getattr(r, op)(*args)
                        res = (res if isinstance(res, bool)
                               else getattr(res, "state", None))
                    out.append(("ok", getattr(res, "value", res)))
                except Quota as e:
                    out.append(("quota", e.tenant, e.reason))
                except KeyError as e:
                    out.append(("key", str(e)))
                out.append((r.has_interactive(), r.staged_count(),
                            r.fleet_version, r.shedding))
            return (out, strip(r.status()), strip(r.snapshot()),
                    {k: v for k, v in reg.snapshot().items()
                     if not k.endswith(".rate")},
                    strip(tel.events.list()),
                    tel.tenants.to_dict()["tenants"])

    got = run(TQ, TM, TT, QuotaExceeded)
    want = run(JQ, JM, JT, JQuota)
    for a, b in zip(got, want):
        assert a == b
    assert ("quota", "acme", "max_active 2 reached (2 queries held)") \
        in want[0]
