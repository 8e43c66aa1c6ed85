"""The port's Kafka topology against the JAX package's: the in-memory
broker, the source, the sinks and the real-client adapter (over a fake
kafka-python module), then ``driver.main --kafka`` through both drivers
on the same seeded topics, the output topics held equal: ids, order, keys
and commit markers exactly, floats within 1e-6 relative: the file path's
records, the control tuple, preproduce across a restart, ``kafka:``
routes and ``--control-topic``, ``--limit`` and ``--seed-scan-limit``
(the family matrix and ``--kafka --bulk``: test_torch_kafka_driver.py).

Each package has its own process-wide memory-broker registry, so both
drivers use the same ``memory://`` URL; every test resets both."""

import json
import math
import os

import numpy as np
import pytest
import yaml

from spatialflink_tpu import driver as JD
from spatialflink_tpu.streams import kafka as JK
from spatialflink_tpu.streams.formats import serialize_spatial as j_ser

from spatialflink_tpu_torch import driver as TD
from spatialflink_tpu_torch.streams import kafka as TK
from spatialflink_tpu_torch.streams.formats import serialize_spatial as t_ser
from spatialflink_tpu_torch.streams.sources import kafka_source

import test_kafka as JKT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "conf", "spatialflink-conf.yml")
IN1, IN2, OUT = "points.geojson", "queries.geojson", "output"
GROUP = "spatialflink"


@pytest.fixture(autouse=True)
def _fresh_brokers():
    TK.reset_memory_brokers()
    JK.reset_memory_brokers()
    yield
    TK.reset_memory_brokers()
    JK.reset_memory_brokers()


# ------------------------------------------------------------------ helpers


def conf(tmp_path, name, fname=None, window=None, **query):
    """The sample config on the ``memory://<name>`` broker."""
    with open(CONF) as f:
        d = yaml.safe_load(f)
    d["kafkaBootStrapServers"] = f"memory://{name}"
    d["query"].update(query)
    if window:
        d["window"].update(window)
    p = tmp_path / (fname or f"{name}.yml")
    p.write_text(yaml.safe_dump(d))
    return str(p), f"memory://{name}"


def lines(n_traj=6, steps=40, seed=3):
    """A seeded GeoJSON point stream (the JAX recovery suite's)."""
    from spatialflink_tpu.index import UniformGrid
    from spatialflink_tpu.streams import SyntheticPointSource

    grid = UniformGrid(115.5, 117.6, 39.6, 41.1, num_grid_partitions=100)
    return [j_ser(p, "GeoJSON") for p in SyntheticPointSource(
        grid, num_trajectories=n_traj, steps=steps, seed=seed)]


def brokers(url):
    """(JAX broker, port broker) of ``url``."""
    return JK.resolve_broker(url), TK.resolve_broker(url)


def produce(url, topic, records):
    for b in brokers(url):
        for r in records:
            b.produce(topic, r)


def norm(v):
    """A topic value in a package-free form: spatial objects serialized
    (GeoJSON, each by its own package), JSON summary records parsed."""
    if hasattr(v, "obj_id"):
        ser = t_ser if type(v).__module__.startswith(
            "spatialflink_tpu_torch") else j_ser
        return ser(v, "GeoJSON")
    if isinstance(v, (tuple, list)):
        return [norm(x) for x in v]
    if isinstance(v, str) and v.startswith('{"window"'):
        return json.loads(v)
    return v


def close(a, b, rel=1e-6) -> bool:
    """Equal, floats within ``rel`` relative (ids and order exact)."""
    if isinstance(a, float) or isinstance(b, float):
        return isinstance(a, (int, float)) and isinstance(b, (int, float)) \
            and math.isclose(a, b, rel_tol=rel, abs_tol=1e-12)
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(close(a[k], b[k], rel)
                                            for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(close(x, y, rel)
                                        for x, y in zip(a, b))
    return a == b


def topic(broker, name=OUT):
    """The topic as (key, normalized value) pairs."""
    return [(r.key, norm(r.value)) for r in broker.fetch(name, 0, 10 ** 7)]


def window_table(broker, name=OUT):
    """{window key: [marker values]} (a key marked twice shows up)."""
    out = {}
    for r in broker.fetch(name, 0, 10 ** 7):
        if isinstance(r.key, str) and r.key.startswith(TK.KafkaWindowSink
                                                       .MARKER):
            out.setdefault(r.key[len(TK.KafkaWindowSink.MARKER):],
                           []).append(int(r.value))
    return out


def run_both(argv, url):
    """``main(argv)`` through both drivers; (JAX topic, port topic)."""
    assert JD.main(argv) == 0
    assert TD.main(argv + ["--device", "cpu"]) == 0
    jb, tb = brokers(url)
    return topic(jb), topic(tb)


#: tStats spatial lengths: the JAX package takes each as a difference of
#: one f32 cumsum over the batch (ROADMAP's known differences), so they
#: agree within 4 * 2**-23 times the total spatial length of the records
#: under one key (test_torch_trajectory.py's bound)
SPATIAL_ULPS = 4 * 2.0 ** -23


def _tstats_row(v) -> bool:
    return (isinstance(v, list) and len(v) == 4 and isinstance(v[0], str)
            and isinstance(v[1], float) and isinstance(v[2], int))


def assert_topics_equal(want, got):
    assert len(want) == len(got)
    totals = {}
    for k, v in want:
        if _tstats_row(v):
            per = totals.setdefault(k, {})
            per[v[0]] = max(per.get(v[0], 0.0), v[1])
    for i, (w, g) in enumerate(zip(want, got)):
        if _tstats_row(w[1]) and _tstats_row(g[1]):
            (_, (jo, js, jt, jv)), (gk, (to, ts, tt, tv)) = w, g
            bound = SPATIAL_ULPS * sum(totals[w[0]].values())
            assert (gk, to, tt) == (w[0], jo, jt), (w, g)
            assert abs(ts - js) <= bound, (w, g, bound)
            assert abs(tv - jv) <= bound / max(jt, 1) + 1e-6 * abs(jv)
            continue
        assert close(w, g), f"record {i}: {str(w)[:300]} != {str(g)[:300]}"


# ------------------------------------------------------ broker and source


def test_broker_matches_jax():
    jb, tb = JK.InMemoryBroker(), TK.InMemoryBroker()
    for b in (jb, tb):
        assert b.produce("t", "a", key="k", timestamp_ms=5) == 0
        assert b.produce_many("t", ["b", "c", "d"], key="m") == 1
        b.commit("t", "g", 3)
        b.commit("t", "g", 1)  # never rewinds
    for b in (jb, tb):
        assert b.committed("t", "g") == 3 and b.committed("t", "h") == 0
    assert [(r.offset, r.key, r.value) for r in jb.fetch("t", 1, 2)] == \
        [(r.offset, r.key, r.value) for r in tb.fetch("t", 1, 2)]
    assert tb.end_offset("t") == jb.end_offset("t") == 4
    assert tb.topic_values("t") == jb.topic_values("t")
    assert tb.fetch("nope", 0) == []


def test_resequence_batch_matches_jax():
    rng = np.random.default_rng(5)
    for _ in range(200):
        start = int(rng.integers(0, 20))
        offs = rng.integers(max(0, start - 5), start + 30,
                            int(rng.integers(0, 40))).tolist()
        if rng.random() < 0.3:
            offs = list(range(start, start + len(offs)))
        jb = [JK.BrokerRecord(o, None, o) for o in offs]
        tb = [TK.BrokerRecord(o, None, o) for o in offs]
        assert [r.offset for r in TK.resequence_batch(tb, start)] == \
            [r.offset for r in JK.resequence_batch(jb, start)]


@pytest.mark.parametrize("kw", [dict(), dict(commit_every=3),
                                dict(limit=7), dict(poll_batch=4, limit=11)])
def test_source_matches_jax(kw):
    """Values, positions and commits of the auto-committing source, and of
    the batched form with its lagged commit."""
    out = []
    for K in (JK, TK):
        b = K.InMemoryBroker()
        for i in range(20):
            b.produce("in", f"r{i}")
        b.commit("in", "g", 2)
        src = K.KafkaSource(b, "in", "g", **kw)
        vals = list(src)
        b2 = K.InMemoryBroker()
        for i in range(20):
            b2.produce("in", f"r{i}")
        src2 = K.KafkaSource(b2, "in", "g", auto_commit=False,
                             commit_lag=5, **kw)
        batches = list(src2.iter_batches())
        out.append((vals, src.position, b.committed("in", "g"), batches,
                    src2.position, b2.committed("in", "g")))
    assert out[0] == out[1]


def test_window_sink_dedup_and_seed_scan_match_jax(capsys):
    """Markers, dedup across a new sink instance (the seed scan), the
    pre-fingerprint bare marker, and the bounded scan's warning."""
    from spatialflink_tpu.operators import WindowResult as JW
    from spatialflink_tpu_torch.operators import WindowResult as TW

    rows = []
    for K, W in ((JK, JW), (TK, TW)):
        b = K.InMemoryBroker()
        s = K.KafkaWindowSink(b, OUT, fmt="GeoJSON", job_id="job1")
        s.emit(W(0, 10, [("a", 1.0), ("b", 2.0)], {"k": 2}))
        s.emit(W(5, 15, [], {"cell": 7}))
        s.emit(W(0, 10, [("a", 1.0)]))
        b.produce(OUT, "1", key=K.KafkaWindowSink.MARKER + "10:20:None")
        again = K.KafkaWindowSink(b, OUT, job_id="job1")
        again.emit(W(5, 15, [], {"cell": 7}))
        again.emit(W(10, 20, []))
        again.emit(W(20, 30, [("c", 3.0)]))
        tail = K.KafkaWindowSink(b, OUT, job_id="job1", seed_scan_limit=2)
        rows.append(([(r.key, norm(r.value)) for r in b.fetch(OUT, 0, 99)],
                     s.duplicates_suppressed, again.duplicates_suppressed,
                     sorted(tail.delivered)))
    assert rows[0] == rows[1]
    err = capsys.readouterr().err
    assert err.count("seeding the dedup set from the last 2 only") == 2


def test_idempotent_window_sink_matches_jax():
    from spatialflink_tpu.operators import WindowResult as JW
    from spatialflink_tpu_torch.operators import WindowResult as TW

    got = []
    for K, W in ((JK, JW), (TK, TW)):
        inner = []
        s = K.IdempotentWindowSink(type("S", (), {
            "emit": lambda self, r: inner.append(r.window_start),
            "close": lambda self: None})())
        for w in (W(0, 1, [1]), W(0, 1, [1]), W(0, 1, [2]),
                  W(1, 2, [], {"heatmap": np.arange(3)}),
                  W(1, 2, [], {"heatmap": np.arange(3)})):
            s.emit(w)
        got.append((inner, s.duplicates_suppressed,
                    s.duplicates_value_differing, s.delivered_count))
    assert got[0] == got[1]


class TestRealKafkaAdapter:
    """The adapter over the JAX suite's fake kafka-python module: the same
    calls give the same records, offsets and commits."""

    @staticmethod
    def _brokers():
        return (JK.connect_kafka("fake:9092",
                                 kafka_module=JKT.FakeKafkaModule()),
                TK.connect_kafka("fake:9092",
                                 kafka_module=JKT.FakeKafkaModule()))

    def test_produce_fetch_commit_match_jax(self):
        out = []
        for b in self._brokers():
            offs = [b.produce("t", f"v{i}", key=f"k{i}", timestamp_ms=i)
                    for i in range(6)]
            b.commit("t", "g", 4)
            b.commit("t", "g", 2)
            recs = b.fetch("t", 2, max_records=10)
            out.append((offs, [(r.offset, r.key, r.value) for r in recs],
                        b.committed("t", "g"), b.committed("t", "h"),
                        b.end_offset("t")))
        assert out[0] == out[1]

    def test_source_replays_from_the_commit_over_the_adapter(self):
        _, b = self._brokers()
        for i in range(8):
            b.produce("in", f"r{i}")
        src = iter(TK.KafkaSource(b, "in", "g", commit_every=2))
        assert [next(src) for _ in range(5)] == [f"r{i}" for i in range(5)]
        del src  # a crash before the fifth record's commit
        assert b.committed("in", "g") == 4
        assert list(TK.KafkaSource(b, "in", "g", commit_every=2)) == \
            [f"r{i}" for i in range(4, 8)]

    def test_missing_package_and_close(self, monkeypatch):
        import sys

        monkeypatch.setitem(sys.modules, "kafka", None)
        with pytest.raises(RuntimeError, match="kafka-python"):
            TK.connect_kafka("real:9092")
        with pytest.raises(RuntimeError, match="kafka-python"):
            TK.resolve_broker("real:9092")
        _, b = self._brokers()
        b.produce("t", "x")
        b.fetch("t", 0)
        b.commit("t", "g", 1)
        b.close()
        assert b._producer.closed and b._fetch_c.closed
        assert all(c.closed for c in b._group_c.values())


def test_memory_broker_registry_is_process_shared():
    a = TK.resolve_broker("memory://shared")
    assert TK.resolve_broker("memory://shared") is a
    assert TK.resolve_broker("memory://other") is not a
    a.produce("t", "x")
    assert list(kafka_source("t", "memory://shared", group="g")) == ["x"]
    assert a.committed("t", "g") == 1
    assert list(kafka_source("t", broker=a, group="g")) == []
    TK.reset_memory_brokers()
    assert TK.resolve_broker("memory://shared") is not a


def test_latency_sink_and_json_writes(tmp_path):
    """``KafkaLatencySink`` (now minus the ingestion or event time, keyed
    by object) and ``atomic_write_json`` (no temporary file left)."""
    from spatialflink_tpu_torch.models import Point
    from spatialflink_tpu_torch.runtime.checkpoint import atomic_write_json

    b = TK.InMemoryBroker()
    p = Point(obj_id="a", timestamp=1_000, x=1.0, y=2.0,
              ingestion_time=2_000)
    TK.KafkaLatencySink(b, "lat").emit(p)
    TK.KafkaLatencySink(b, "lat", use_event_time=True).emit(p)
    (ing, ev) = b.fetch("lat", 0)
    # the two emits read the wall clock apart: within a second of 1,000
    assert ing.key == ev.key == "a"
    assert 1_000 <= ev.value - ing.value < 2_000
    path = tmp_path / "doc.json"
    atomic_write_json(str(path), {"b": 1, "a": [2]})
    assert json.loads(path.read_text()) == {"a": [2], "b": 1}
    assert os.listdir(tmp_path) == ["doc.json"]


@pytest.mark.parametrize("opt", [1, 51])
def test_kafka_records_equal_the_file_path(tmp_path, opt):
    """The records of the output topic are the file path's ``--output``
    records, window by window, and the marker counts its window counts."""
    cfg, url = conf(tmp_path, f"f{opt}")
    recs = lines()
    inp = tmp_path / "in.geojson"
    inp.write_text("\n".join(recs) + "\n")
    out = tmp_path / "out.txt"
    assert TD.main(["--config", cfg, "--option", str(opt), "--input1",
                    str(inp), "--output", str(out), "--device", "cpu"]) == 0
    assert TD.main(["--config", cfg, "--kafka", "--option", str(opt),
                    "--input1", str(inp), "--device", "cpu"]) == 0
    tb = brokers(url)[1]
    kafka_recs = [json.dumps(v) if isinstance(v, list) else v
                  for k, v in topic(tb) if not str(k).startswith(
                      TK.KafkaWindowSink.MARKER)
                  and not isinstance(v, dict)]
    assert kafka_recs == out.read_text().splitlines()


def test_control_tuple_stops_the_job(tmp_path, capsys):
    """A control tuple ends the run with exit code 0: the windows sealed
    by the records before it are produced, the commits stay window-aligned
    (no full commit). The JAX driver's output is a prefix of the port's:
    the port also emits the windows still in flight at the stop (the JAX
    driver drops them, and its commits re-deliver their records)."""
    cfg, url = conf(tmp_path, "ctl")
    recs = lines()
    stop = json.dumps({"geometry": {"type": "control"}, "properties": {}})
    produce(url, IN1, recs[:150] + [stop] + recs[150:])
    want, got = run_both(["--config", cfg, "--kafka", "--option", "1"], url)
    assert want and got[:len(want)] == want
    jb, tb = brokers(url)
    assert jb.committed(IN1, GROUP) <= tb.committed(IN1, GROUP) < 150
    assert capsys.readouterr().err.count("control-tuple stop") == 2


def test_preproduce_across_a_restart(tmp_path, capsys):
    """``--input1`` with ``--kafka``: produced once; a rerun finds the
    topic whole and produces nothing, a topic cut short is completed."""
    cfg, url = conf(tmp_path, "pre")
    recs = lines()
    inp = tmp_path / "in.geojson"
    inp.write_text("\n".join(recs) + "\n")
    tb = brokers(url)[1]
    for r in recs[:100]:
        tb.produce(IN1, r)  # an interrupted produce
    argv = ["--config", cfg, "--kafka", "--option", "1", "--input1",
            str(inp), "--device", "cpu"]
    assert TD.main(argv) == 0
    assert "resumed" in capsys.readouterr().err
    assert tb.topic_values(IN1) == recs
    assert TD.main(argv) == 0
    assert "NOT re-producing" in capsys.readouterr().err
    assert tb.end_offset(IN1) == len(recs)
    # the second run found the group committed at the end: nothing new
    assert len(window_table(tb)) == sum(
        1 for k in window_table(tb))


def test_limit_bounds_consumption(tmp_path):
    """``--limit`` counts this run's records from the group's resume
    point; a second run takes the next ones."""
    cfg, url = conf(tmp_path, "lim")
    produce(url, IN1, lines())
    argv = ["--config", cfg, "--kafka", "--option", "1", "--limit", "100"]
    for _ in range(2):
        want, got = run_both(argv, url)
        assert_topics_equal(want, got)
    assert brokers(url)[1].committed(IN1, GROUP) == 200


def test_kafka_routes_and_control_topic_match_jax(tmp_path):
    """The dynamic plane over the broker: a ``kafka:`` route and admissions
    and a retirement from ``--control-topic``; the routed topic, the
    control group's commit and the output topic equal the JAX driver's."""
    cfg, url = conf(tmp_path, "dyn")
    produce(url, IN1, lines())
    q = tmp_path / "q.json"
    q.write_text(json.dumps([{"id": "a", "x": 116.5, "y": 40.5},
                             {"id": "b", "x": 116.2, "y": 40.2,
                              "route": "kafka:routed"}]))
    produce(url, "ctl", [
        json.dumps({"action": "admit", "query": {
            "id": "c", "x": 116.8, "y": 40.6, "route": "kafka:routed"}}),
        json.dumps({"action": "retire", "id": "a"}),
        "not json"])
    argv = ["--config", cfg, "--kafka", "--option", "51", "--queries-file",
            str(q), "--control-topic", "ctl"]
    want, got = run_both(argv, url)
    assert_topics_equal(want, got)
    jb, tb = brokers(url)
    routed = [json.loads(v) for v in tb.topic_values("routed")]
    assert close([json.loads(v) for v in jb.topic_values("routed")], routed)
    assert {d["query"] for d in routed} == {"b", "c"}
    assert tb.committed("ctl", GROUP + "-control") == 3


def test_seed_scan_limit_matches_jax(tmp_path, capsys):
    cfg, url = conf(tmp_path, "scan")
    produce(url, IN1, lines())
    produce(url, OUT, [f"old{i}" for i in range(50)])
    want, got = run_both(["--config", cfg, "--kafka", "--option", "1",
                          "--seed-scan-limit", "10"], url)
    assert_topics_equal(want, got)
    assert capsys.readouterr().err.count(
        "seeding the dedup set from the last 10 only") == 2
