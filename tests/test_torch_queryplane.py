"""The dynamic standing-query plane on the CPU: the port's own
``runtime.queryplane`` against the JAX package's (spec validation and its
messages, the lifecycle state machine, the padding buckets, the padded
fleet, no version bump without a change, the SLO verdict), ``run_dynamic``
of options 1, 16, 31 and 51 against the JAX package's with the same
admissions, updates and retirements landing at the same windows, each
query's windows against a dedicated single-query run, the empty fleet,
and the CLI with ``--queries-file``: stdout byte for byte and a ``file:``
route's JSON lines against the JAX driver's, and the refusals.

Admissions are made when the stream's reader pulls a given line: both
packages decode the same chunks lazily and apply the fleet once per
window, so a change lands before the first window dispatched after its
chunk, in both.
"""

import json
import os

import numpy as np
import pytest
import torch
import yaml

from spatialflink_tpu import driver as JD
from spatialflink_tpu import operators as JO
from spatialflink_tpu.config import Params as JParams
from spatialflink_tpu.runtime import queryplane as JQ
from spatialflink_tpu.utils.metrics import REGISTRY

from spatialflink_tpu_torch import driver as TD
from spatialflink_tpu_torch import operators as TO
from spatialflink_tpu_torch.config import Params as TParams
from spatialflink_tpu_torch.runtime import queryplane as TQ

import test_torch_geom_stream as GS
import test_torch_realtime as RT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "conf", "spatialflink-conf.yml")

torch.set_num_threads(1)

BAD_SPECS = [
    {"x": 1, "y": 2},
    {"id": "", "x": 1, "y": 2},
    {"id": "a", "x": 1, "y": 2, "family": "join"},
    {"id": "a", "y": 2},
    {"id": "a", "x": "wat", "y": 2},
    {"id": "a", "x": 1, "y": 2, "radius": "far"},
    {"id": "a", "x": 1, "y": 2, "route": "smoke:sig"},
    {"id": "a", "x": 1, "y": 2, "route": "file:"},
    {"id": "a", "x": 1, "y": 2, "slo": {"wat": 1}},
    {"id": "a", "x": 1, "y": 2, "slo": {"min_window_records": "x"}},
    {"id": "a", "x": 1, "y": 2, "k": "many"},
    {"id": "a", "x": 1, "y": 2, "wobble": 3},
    {"id": "a", "x": 1, "y": 2, "latency_class": "urgent"},
    {"id": "a", "x": 1, "y": 2, "tenant": ""},
    "not-a-dict",
]


def _error(fn):
    try:
        fn()
    except (ValueError, KeyError) as e:
        return type(e).__name__, str(e)
    return None


@pytest.mark.parametrize("i", range(len(BAD_SPECS)))
def test_schema_errors_match_jax(i):
    bad = BAD_SPECS[i]
    got = _error(lambda: TQ.QuerySpec.from_dict(bad, default_family="range"))
    want = _error(lambda: JQ.QuerySpec.from_dict(bad,
                                                 default_family="range"))
    assert got is not None and got == want


def test_fleet_validation_matches_jax():
    cases = [("range", {"id": "a", "x": 1, "y": 2, "radius": 0.7}),
             ("knn", {"id": "b", "family": "knn", "x": 1, "y": 2, "k": 3}),
             ("knn", {"id": "c", "family": "range", "x": 1, "y": 2})]
    for fam, spec in cases:
        got = _error(lambda: TQ.QueryRegistry(fam, radius=0.5, k=10)
                     .admit(spec))
        want = _error(lambda: JQ.QueryRegistry(fam, radius=0.5, k=10)
                      .admit(spec))
        assert got is not None and got == want
    spec = {"id": "a", "x": 1, "y": 2, "radius": 0.5, "k": 10,
            "route": "file:/tmp/x", "slo": {"max_window_records": 3},
            "latency_class": "interactive", "tenant": "t1"}
    t = TQ.QuerySpec.from_dict(spec, default_family="knn")
    j = JQ.QuerySpec.from_dict(spec, default_family="knn")
    assert t.to_dict() == j.to_dict()


def test_kafka_routes_and_quotas_are_refused():
    """``kafka:`` routes, refused until the Kafka slice, are admitted and
    updated to now (tests/test_torch_kafka.py routes them); tenant quotas,
    refused until the operations plane, are taken too and refuse a tenant
    over its ceiling as the JAX registry does
    (tests/test_torch_control.py holds them against it)."""
    reg = TQ.QueryRegistry("range", radius=0.5)
    reg.admit({"id": "a", "x": 1, "y": 2, "route": "kafka:out"})
    reg.admit({"id": "b", "x": 1, "y": 2})
    reg.apply()
    reg.update("b", {"route": "kafka:out2"})
    reg.apply()
    assert [e.spec.route for e in reg.active_entries()] == [
        "kafka:out", "kafka:out2"]
    quota = TQ.QueryRegistry("range", tenant_quotas={"t": {"max_active": 1}})
    quota.admit({"id": "a", "x": 1, "y": 2, "tenant": "t"})
    with pytest.raises(TQ.QuotaExceeded, match="max_active 1 reached"):
        quota.admit({"id": "b", "x": 1, "y": 2, "tenant": "t"})


def _states(reg):
    return ({e.id: e.state.value for e in reg._entries.values()},
            [e.id for e in reg.active_entries()], reg.fleet_version,
            reg.staged_count())


def test_state_machine_matches_jax():
    """One script of admissions, re-admissions (staged updates), updates
    and retirements through both registries: the same states, fleet,
    versions and staged counts after every step."""
    steps = [
        ("admit", {"id": "a", "x": 1, "y": 2}), ("apply",),
        ("admit", {"id": "a", "x": 9, "y": 9, "route": "file:/tmp/x"}),
        ("admit", {"id": "b", "x": 3, "y": 4}), ("apply",), ("apply",),
        ("update", "b", {"slo": {"min_window_records": 2}}),
        ("retire", "a"), ("admit", {"id": "c", "x": 5, "y": 6}),
        ("retire", "c"), ("apply",), ("retire", "a"), ("update", "zz", {}),
        ("admit", {"id": "a", "x": 1, "y": 1}), ("apply",),
    ]
    regs = [TQ.QueryRegistry("range", radius=0.5),
            JQ.QueryRegistry("range", radius=0.5)]
    for step in steps:
        out = []
        for reg in regs:
            op, *args = step
            out.append((_error(lambda: getattr(reg, op)(*args)),
                        _states(reg)))
        assert out[0] == out[1], step
    t, j = (r.active_entries() for r in regs)
    assert [e.spec.to_dict() for e in t] == [e.spec.to_dict() for e in j]
    assert regs[0].fleet_version == 4
    st = regs[0].status()
    assert st["fleet"] == ["b", "a"] and st["live"] == 2 and \
        st["bucket"] == 2


def test_no_change_no_version_bump():
    reg = TQ.QueryRegistry("range", radius=0.5)
    assert not reg.apply() and reg.fleet_version == 0
    reg.admit({"id": "a", "x": 1, "y": 2})
    assert reg.apply() and reg.fleet_version == 1
    assert not reg.apply() and reg.fleet_version == 1


def test_buckets_and_padded_fleet_match_jax():
    assert [TQ.bucket_size(n) for n in range(40)] == \
        [JQ.bucket_size(n) for n in range(40)]
    grid_t = TParams.from_yaml(CONF).grids()[0]
    grid_j = JParams.from_yaml(CONF).grids()[0]
    for n in (0, 1, 3, 5, 8):
        out = []
        for Q, grid in ((TQ, grid_t), (JQ, grid_j)):
            reg = Q.QueryRegistry("range", radius=0.5)
            for i in range(n):
                reg.admit({"id": f"q{i}", "x": 116.0 + 0.1 * i,
                           "y": 40.0 + 0.05 * i})
            reg.apply()
            entries, pts, valid = reg.padded_fleet(grid)
            out.append(([e.id for e in entries],
                        [(p.x, p.y, p.cell) for p in pts], valid.tolist()))
        assert out[0] == out[1]
        assert len(out[0][1]) == (TQ.bucket_size(n) if n else 0)


def test_slo_verdict_counts_transitions():
    reg = TQ.QueryRegistry("range", radius=0.5)
    reg.admit({"id": "a", "x": 1, "y": 2, "slo": {"min_window_records": 2,
                                                   "p99_emit_ms": 5}})
    reg.apply()
    e = reg.active_entries()[0]
    for n, ok, breaches in ((5, True, 0), (1, False, 1), (0, False, 1),
                            (4, True, 1), (1, False, 2)):
        reg.note_window(e, n)  # no telemetry: p99_emit_ms counts healthy
        assert (e.slo_ok, e.slo_breaches) == (ok, breaches)
    assert reg.status()["queries"][0]["slo"] == {"ok": False, "breaches": 2}


def test_queries_file_names_the_offending_entry(tmp_path):
    p = tmp_path / "q.json"
    p.write_text(json.dumps({"queries": [{"id": "ok", "x": 1, "y": 2},
                                         {"id": "bad", "x": 1}]}))
    with pytest.raises(TQ.QuerySpecError, match=r"query\[1\]: 'x' and 'y'"):
        TQ.load_queries_file(str(p), "range")
    p.write_text(json.dumps([{"id": "ok", "x": 1, "y": 2}]))
    assert [s.id for s in TQ.load_queries_file(str(p), "range")] == ["ok"]
    p.write_text(json.dumps({"x": 1}))
    assert TQ.load_queries_file(str(p), "range") == []


# ------------------------------------------------------------------------ #
# run_dynamic


SEEDS = [(116.5, 40.5), (116.9, 40.1), (116.0, 40.8)]


def _script(n):
    """(line index, action) pairs: an admission within the bucket of 4, an
    update, one that crosses into the bucket of 8 and two retirements."""
    return [(45 * n // 100, ("admit", {"id": "late", "x": 116.8,
                                       "y": 40.6})),
            (60 * n // 100, ("admit", {"id": "late2", "x": 116.2,
                                       "y": 40.3})),
            (60 * n // 100, ("update", "q1", {"x": 116.7, "y": 40.2})),
            (75 * n // 100, ("retire", "q0")),
            (90 * n // 100, ("retire", "late"))]


def _churn(lines, reg, script):
    for i, line in enumerate(lines):
        for at, (op, *args) in script:
            if at == i:
                getattr(reg, op)(*args)
        yield line


def _registry(Q, family, k=7, seeds=SEEDS):
    reg = Q.QueryRegistry(family, radius=0.5, k=k)
    for i, (x, y) in enumerate(seeds):
        reg.admit({"id": f"q{i}", "x": x, "y": y})
    reg.apply()
    return reg


CHUNK = {1: 500, 51: 500, 16: 25, 31: 25}


def _dynamic(package, option, lines, script, k=7, seeds=SEEDS):
    """(windows, registry, operator) of one run_dynamic through the
    package's decode stream and operator classes."""
    D, P, O, Q = ((JD, JParams, JO, JQ) if package == "jax"
                  else (TD, TParams, TO, TQ))
    module = RT if option in (1, 51) else GS
    params = module._params(P, option)
    spec = TD.CASES[option]
    family = spec.family
    grid = params.grids()[0]
    reg = _registry(Q, family, k, seeds)
    if package == "jax":
        stream = JD.decode_stream(_churn(lines, reg, script), params.input1,
                                  grid, spec.stream, chunk=CHUNK[option])
        conf = JD._query_conf(params, JD.CASES[option])
        op = getattr(JO, f"{spec.stream}{spec.query}"
                         f"{'KNN' if family == 'knn' else 'Range'}Query")(
            conf, grid)
    else:
        stream = TD.ChunkedStream(TD.decode_chunks(
            _churn(lines, reg, script), params.input1, grid, CHUNK[option],
            geometry=spec.stream))
        conf = TD._query_conf(params, spec)
        op = getattr(TO, f"{spec.stream}{spec.query}"
                         f"{'KNN' if family == 'knn' else 'Range'}Query")(
            conf, grid, device="cpu")
    args = (stream, reg, 0.5) + ((k,) if family == "knn" else ())
    out = [(w.window_start, w.window_end, dict(w.extras),
            [[r if isinstance(r, tuple) else
              (r.obj_id, r.timestamp, type(r).__name__) for r in q]
             for q in w.records])
           for w in op.run_dynamic(*args)]
    return out, reg, op


def _assert_same_windows(got, want, knn):
    assert [w[:3] for w in got] == [w[:3] for w in want]
    for g, w in zip(got, want):
        for rg, rw in zip(g[3], w[3]):
            if not knn:
                assert rg == rw
                continue
            assert [o for o, _ in rg] == [o for o, _ in rw]
            np.testing.assert_allclose([d for _, d in rg],
                                       [d for _, d in rw], rtol=1e-6, atol=0)


@pytest.mark.parametrize("option", [1, 16, 31, 51])
def test_run_dynamic_matches_jax(option):
    lines = RT.LINES if option in (1, 51) else GS.GEOJSON
    script = _script(len(lines))
    names = ("gn-bypassed", "distance-computations")
    before = [REGISTRY.counter(c).count for c in names]
    want, jreg, _ = _dynamic("jax", option, lines, script)
    jcounts = [REGISTRY.counter(c).count - b for c, b in zip(names, before)]
    got, treg, op = _dynamic("port", option, lines, script)
    _assert_same_windows(got, want, option == 51)
    assert [op.pruning[c] for c in names] == jcounts and jcounts[1] > 0
    assert treg.fleet_version == jreg.fleet_version >= 3
    fleets = [tuple(w[2]["query_ids"]) for w in got]
    # the fleet changed mid-run: bucket 4, then 8, then 4 again
    assert fleets[0] == ("q0", "q1", "q2")
    assert ("q0", "q1", "q2", "late", "late2") in fleets
    assert fleets[-1] == ("q1", "q2", "late2")
    assert sum(len(q) for w in got for q in w[3]) > 0
    if option == 51:
        assert all(w[2]["k"] == 7 and list(w[2]) == ["query_ids", "queries",
                                                     "k"] for w in got)


@pytest.mark.parametrize("option", [1, 16, 31, 51])
def test_each_query_equals_its_dedicated_run(option):
    """Each query's windows, for the windows it was live in, equal a
    single-query run of the same option (its updated point for the
    windows after its update)."""
    lines = RT.LINES if option in (1, 51) else GS.GEOJSON
    script = [s for s in _script(len(lines)) if s[1][0] != "update"]
    got, _, _ = _dynamic("port", option, lines, script)
    live = {}
    for start, _, extras, recs in got:
        for qid, rows in zip(extras["query_ids"], recs):
            live.setdefault(qid, {})[start] = rows
    points = dict(zip(("q0", "q1", "q2"), SEEDS))
    points.update(late=(116.8, 40.6), late2=(116.2, 40.3))
    assert set(live) == set(points)
    for qid, (x, y) in points.items():
        ded, _, _ = _dynamic("port", option, lines, [], seeds=[(x, y)])
        table = {w[0]: w[3][0] for w in ded}
        for start, rows in live[qid].items():
            assert rows == table[start], (qid, start)
    assert 0 < len(live["late"]) < len(got)


@pytest.mark.parametrize("option", [1, 51])
def test_empty_fleet_emits_empty_windows(option):
    got, _, _ = _dynamic("port", option, RT.LINES, [], seeds=[])
    want, _, _ = _dynamic("jax", option, RT.LINES, [], seeds=[])
    assert got == want and len(got) >= 5
    assert all(w[3] == [] and w[2]["queries"] == 0 and
               w[2]["query_ids"] == [] for w in got)


# ------------------------------------------------------------------------ #
# the CLI


def _cli(tmp_path, capsys, args, name):
    """(JAX stdout, port stdout, port stderr) of one run with the query
    specs of ``q.json``, each package's ``file:`` routes pointed at its own
    ``<package>-<name>.jsonl``."""
    specs = json.loads((tmp_path / "q.json").read_text())
    for side in ("jax", "port"):
        for s in specs:
            if s.get("route", "").startswith("file:"):
                s["route"] = f"file:{tmp_path / side}-{name}.jsonl"
        (tmp_path / f"{side}-q.json").write_text(json.dumps(specs))
    assert JD.main(args + ["--queries-file",
                           str(tmp_path / "jax-q.json")]) == 0
    want = capsys.readouterr().out
    assert TD.main(args + ["--queries-file", str(tmp_path / "port-q.json"),
                           "--device", "cpu"]) == 0
    got = capsys.readouterr()
    return want, got.out, got.err


@pytest.mark.parametrize("option", [1, 51])
def test_cli_queries_file_matches_jax(tmp_path, capsys, option):
    inp = tmp_path / "in.csv"
    inp.write_text("\n".join(RT.LINES) + "\n")
    (tmp_path / "q.json").write_text(json.dumps([
        {"id": "north", "x": 116.5, "y": 40.5},
        {"id": "ring", "x": 116.9, "y": 40.1, "route": "file:x",
         "slo": {"max_window_records": 400}},
        {"id": "west", "x": 116.0, "y": 40.8, "latency_class": "batch"}]))
    args = ["--config", CONF, "--option", str(option), "--input1", str(inp),
            "--format", "CSV"]
    want, got, err = _cli(tmp_path, capsys, args, str(option))
    assert got == want and want.count("'query_ids': ['north', 'ring', "
                                      "'west']") >= 5
    assert "# query plane: dynamic" in err
    port = (tmp_path / f"port-{option}.jsonl").read_text().splitlines()
    jax = (tmp_path / f"jax-{option}.jsonl").read_text().splitlines()
    assert len(port) == len(jax) >= 5
    if option == 1:
        assert port == jax
        return
    for a, b in zip(map(json.loads, port), map(json.loads, jax)):
        assert {k: v for k, v in a.items() if k != "records"} == \
            {k: v for k, v in b.items() if k != "records"}
        assert [r[0] for r in a["records"]] == [r[0] for r in b["records"]]
        np.testing.assert_allclose([r[1] for r in a["records"]],
                                   [r[1] for r in b["records"]], rtol=1e-6)


def test_cli_seeds_from_the_config(tmp_path, capsys):
    """A queries file with no queries: the config's queryPoints seed the
    fleet as q0, q1, ... (the conf holds one point); --panes is noted and
    bypassed."""
    inp = tmp_path / "in.csv"
    inp.write_text("\n".join(RT.LINES) + "\n")
    (tmp_path / "q.json").write_text("[]")
    args = ["--config", CONF, "--option", "1", "--input1", str(inp),
            "--format", "CSV", "--panes"]
    want, got, err = _cli(tmp_path, capsys, args, "seed")
    assert got == want and "'query_ids': ['q0']" in want
    assert "--panes is bypassed on the dynamic standing-query path" in err


def _count_conf(tmp_path):
    with open(CONF) as f:
        conf = yaml.safe_load(f.read().split("\n", 1)[1])  # the !! tag
    conf["window"]["type"] = "COUNT"
    path = tmp_path / "count.yml"
    path.write_text(yaml.safe_dump(conf))
    return str(path)


@pytest.mark.parametrize("case,message", [
    (["--option", "2"], "runs event-time windowed cases only"),
    (["--option", "1", "COUNT"], "runs event-time windowed cases only"),
    (["--option", "8"], "not queryOption 8 (range, PointxPolygon)"),
    (["--option", "1", "--multi-query"], "--multi-query is subsumed"),
    (["--option", "101", "--input2", "IN"],
     "not queryOption 101 (join, PointxPoint)"),
    (["--option", "66", "--format", "GeoJSON"],
     "not queryOption 66 (knn, PolygonxPoint)"),
    (["--option", "6"], "not queryOption 6 (range, PointxPolygon)"),
    (["--option", "1", "KAFKA"], "route 'kafka:' topics and need --kafka"),
])
def test_cli_refusals(tmp_path, capsys, case, message):
    inp = tmp_path / "in.csv"
    inp.write_text("\n".join(RT.LINES[:50]) + "\n")
    specs = [{"id": "a", "x": 116.5, "y": 40.5}]
    if "KAFKA" in case:
        specs.append({"id": "b", "x": 116.0, "y": 40.1, "route": "kafka:out"})
    (tmp_path / "q.json").write_text(json.dumps(specs))
    conf = _count_conf(tmp_path) if "COUNT" in case else CONF
    argv = [a.replace("IN", str(inp)) for a in case
            if a not in ("COUNT", "KAFKA")]
    rc = TD.main(["--config", conf, "--input1", str(inp), "--format", "CSV",
                  "--device", "cpu", *argv, "--queries-file",
                  str(tmp_path / "q.json")])
    assert rc == 2
    assert message in capsys.readouterr().err
