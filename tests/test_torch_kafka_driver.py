"""The port's ``driver.main --kafka`` (and ``--kafka --bulk``) against the
JAX driver's over the family matrix: windowed, realtime, multiQuery,
panes, joins over two topics, geometry streams and the trajectory
options, the apps and a ser/de option through the plain sink. Both
drivers read the same seeded topics; their output topics are held equal
(ids, order, keys and commit markers exactly, floats within 1e-6
relative, tStats spatial lengths within test_torch_kafka's bound), and so
are their committed offsets. The helpers are test_torch_kafka's."""

import numpy as np
import pytest
import yaml

from spatialflink_tpu_torch import driver as TD

import test_torch_geom_stream as GS
import test_torch_kafka as KF
from test_torch_kafka import (GROUP, IN1, IN2, OUT, assert_topics_equal,
                              brokers, conf, lines, produce, run_both)


@pytest.fixture(autouse=True)
def _fresh_brokers():
    KF.TK.reset_memory_brokers()
    KF.JK.reset_memory_brokers()
    yield
    KF.TK.reset_memory_brokers()
    KF.JK.reset_memory_brokers()


# ------------------------------------------------------- the driver matrix


def _geom_lines(n=120):
    return GS.GEOJSON[:n]


@pytest.mark.parametrize("opt,extra", [
    (1, []), (6, []), (51, []), (56, []), (2, []), (52, []), (8, []),
    (1, ["--multi-query"]), (51, ["--multi-query"]), (51, ["--panes"]),
    (101, []), (102, []), (21, []), (71, []), (22, []),
    (202, []), (204, []), (205, []), (206, []), (208, []), (207, []),
    (210, []), (212, []),
])
def test_family_matrix_matches_jax(tmp_path, opt, extra):
    """``--kafka`` through both drivers: the output topic (window records
    under their keys, summary records, commit markers) and the committed
    offsets are the JAX driver's."""
    spec = TD.CASES[opt]
    cfg, url = conf(tmp_path, f"m{opt}{len(extra)}", k=5)
    geom = spec.stream != "Point"
    produce(url, IN1, _geom_lines() if geom else lines())
    two = spec.family in ("join", "tjoin")
    if two:
        produce(url, IN2, lines(n_traj=4, steps=40, seed=8))
    want, got = run_both(["--config", cfg, "--kafka", "--option", str(opt)]
                         + extra, url)
    # realtime tAggregate's results are heatmaps with no records: the
    # plain sink produces nothing, in both drivers
    assert want or opt == 207, "nothing reached the output topic"
    assert_topics_equal(want, got)
    jb, tb = brokers(url)
    for t in (IN1, IN2) if two else (IN1,):
        assert tb.committed(t, GROUP) == jb.committed(t, GROUP) == \
            tb.end_offset(t)
    # the latency variants' per-record latencies (wall clock: counted)
    assert tb.end_offset(OUT + "-latency") == jb.end_offset(OUT + "-latency")
    assert (tb.end_offset(OUT + "-latency") > 0) == spec.latency


@pytest.mark.parametrize("opt,fmt", [(1010, None), (2000, None),
                                     (504, "WKT")])
def test_plain_sink_families_match_jax(tmp_path, opt, fmt):
    """The apps and a ser/de option over the broker: plain records on the
    output topic, the group committed on drain (JAX
    ``tests/test_kafka_driver.py:485``)."""
    cfg, url = conf(tmp_path, f"p{opt}")
    if opt == 504:
        records = ["GEOMETRYCOLLECTION (POINT (116.5 40.5), "
                   "LINESTRING (116 40, 117 41))"]
    elif opt == 2000:
        records = [f"e{i},room{i % 3}-{'in' if i % 2 == 0 else 'out'},"
                   f"u{i % 4},{1_700_000_000_000 + i * 1000},116.5,40.5"
                   for i in range(24)]
    else:
        records = lines(steps=12)
    produce(url, IN1, records)
    argv = ["--config", cfg, "--kafka", "--option", str(opt)]
    want, got = run_both(argv + (["--format", fmt] if fmt else []), url)
    assert want
    if opt == 2000:
        # a check-in tuple ends with its emission's wall clock
        want, got = ([(k, v[:-1]) for k, v in t] for t in (want, got))
    assert_topics_equal(want, got)
    assert brokers(url)[1].committed(IN1, GROUP) == len(records)


@pytest.mark.parametrize("opt", [1, 51, 101, 21])
def test_kafka_bulk_matches_jax(tmp_path, opt):
    """``--kafka --bulk``: the topics drained whole, the same output topic
    as the JAX driver's, and the drained offsets committed."""
    cfg, url = conf(tmp_path, f"b{opt}")
    produce(url, IN1, _geom_lines() if opt == 21 else lines())
    if opt == 101:
        produce(url, IN2, lines(n_traj=4, seed=8))
    want, got = run_both(["--config", cfg, "--kafka", "--bulk", "--option",
                          str(opt)], url)
    assert want
    assert_topics_equal(want, got)
    assert brokers(url)[1].committed(IN1, GROUP) == \
        brokers(url)[1].end_offset(IN1)


def test_decode_chunk_orders_knn_ties_alike_in_both_packages(tmp_path,
                                                             monkeypatch):
    """A decode chunk interns its new ids in hash order, so the chunk size
    orders kNN ties: option 56's points inside its query polygon all lie
    at distance 0, and which k of them a window lists follows the chunk
    (the Kafka path decodes in chunks of 2,048 and the file path in
    chunks of 4,096 by default). Both packages list alike at each chunk
    size; the two chunk sizes give the same distances and other ids."""
    rng = np.random.default_rng(11)
    n = 512
    ts = 1_700_000_000_000 + np.arange(n) * 20_000 // n
    x, y = rng.uniform(116.3, 116.9, n), rng.uniform(40.3, 40.8, n)
    records = [f"o{i},{t},{a!r},{b!r}"
               for i, (t, a, b) in enumerate(zip(ts.tolist(), x.tolist(),
                                                 y.tolist()))]
    topics = {}
    for chunk in ("32", "64"):
        monkeypatch.setenv("SPATIALFLINK_DECODE_CHUNK", chunk)
        with open(KF.CONF) as f:
            d = yaml.safe_load(f)
        d["kafkaBootStrapServers"] = url = f"memory://ties{chunk}"
        d["inputStream1"]["format"] = "CSV"
        d["query"]["k"] = 5
        cfg = tmp_path / f"ties{chunk}.yml"
        cfg.write_text(yaml.safe_dump(d))
        produce(url, d["inputStream1"]["topicName"], records)
        want, got = run_both(["--config", str(cfg), "--kafka", "--option",
                              "56"], url)
        assert want
        assert_topics_equal(want, got)
        topics[chunk] = got
    # each neighbour is one [objID, distance] record under its window key
    a, b = ([(k, v) for k, v in topics[c] if isinstance(v, list)]
            for c in ("32", "64"))
    assert a and [(k, v[1]) for k, v in a] == [(k, v[1]) for k, v in b]
    assert {v[1] for _, v in a} == {0.0}
    assert [v[0] for _, v in a] != [v[0] for _, v in b]
