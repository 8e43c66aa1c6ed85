"""The port's repartition controller, metrics registry, synthetic skewed
streams and ``--adaptive-grid`` driver wiring against the JAX package's:
per-epoch layouts, versions, epoch counts and decisions (the hysteresis
cases of the JAX ``tests/test_repartition.py``), the driver's stdout and
Kafka topics byte for byte, and recovery: a crash and resume that
straddles a repartition, and a JAX-written checkpoint with a ``grid``
component resumed in the port.

Inputs are seeded numpy streams; every test resets both packages'
in-memory brokers."""

import contextlib
import io

import numpy as np
import pytest
import torch
import yaml

from spatialflink_tpu import driver as JD
from spatialflink_tpu.index import AdaptiveGrid as JAdaptive
from spatialflink_tpu.index import UniformGrid as JGrid
from spatialflink_tpu.runtime import repartition as JR
from spatialflink_tpu.runtime.checkpoint import \
    CheckpointCoordinator as JCoordinator
from spatialflink_tpu.streams import kafka as JK
from spatialflink_tpu.streams import synthetic as JS
from spatialflink_tpu.utils import metrics as JM

from spatialflink_tpu_torch import driver as TD
from spatialflink_tpu_torch.index import AdaptiveGrid as TAdaptive
from spatialflink_tpu_torch.index import UniformGrid as TGrid
from spatialflink_tpu_torch.index import uniform_grid as tug
from spatialflink_tpu_torch.runtime import repartition as TR
from spatialflink_tpu_torch.runtime.checkpoint import \
    CheckpointCoordinator as TCoordinator
from spatialflink_tpu_torch.streams import kafka as TK
from spatialflink_tpu_torch.streams import synthetic as TS
from spatialflink_tpu_torch.utils import metrics as TM

import test_torch_kafka as KF
from test_torch_adaptive_grid import _conf, _lines

BBOX = (115.5, 117.6, 39.6, 41.1)
IN1 = "points.geojson"

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_brokers():
    TK.reset_memory_brokers()
    JK.reset_memory_brokers()
    yield
    TK.reset_memory_brokers()
    JK.reset_memory_brokers()


# ------------------------------------------------------------ controller


def _pair(n=100, refine=4, coarsen=2, interval=1000, **policy):
    """(JAX controller, port controller) on equal grids and policies
    (coarsening off unless asked, as the JAX decision tests set it)."""
    policy.setdefault("split_share", 0.2)
    policy.setdefault("merge_share", 0.05)
    policy.setdefault("min_epoch_records", 64)
    policy.setdefault("coarsen_share", 0.0)
    out = []
    for grid_cls, ag_cls, mod in ((JGrid, JAdaptive, JR),
                                  (TGrid, TAdaptive, TR)):
        ag = ag_cls(grid_cls(*BBOX, num_grid_partitions=n), refine, coarsen)
        out.append(mod.RepartitionController(
            ag, interval_records=interval,
            policy=mod.RepartitionPolicy(**policy)))
    return out


def _state(ctl):
    """What must be equal after every epoch."""
    return (ctl.grid.layout(), ctl.epochs, ctl.repartitions,
            [{k: v for k, v in d.items() if k != "ts_ms"}
             for d in ctl.decisions],
            ctl._since, int(ctl._counts.sum()))


def _feed(pair, cells):
    """The same observations into both controllers; their states equal
    afterwards (and their epoch's return values, when one closes)."""
    j, t = pair
    j.note_cells(cells)
    t.note_cells(cells)
    assert _state(t) == _state(j)
    return t


def _hot_epoch(pair, hot_cell, n=1000, hot_share=0.6, seed=0):
    rng = np.random.default_rng(seed)
    tail = rng.integers(0, 10_000, n)
    return _feed(pair, np.where(rng.uniform(size=n) < hot_share, hot_cell,
                                tail))


def test_attributed_cost_steers_splits_alike_in_both_packages():
    """Under a telemetry session the split score blends in the session's
    attributed kernel cost per cell (``_cost_shares``): the same injected
    cost in both packages' sessions splits a cell whose record share
    alone would not, in both, with the same ``repartition`` event and
    ``grid.*`` gauges; without a session the same epoch splits nothing."""
    from spatialflink_tpu.utils import telemetry as JT

    from spatialflink_tpu_torch.utils import telemetry as TT

    plain = _pair()
    t = _hot_epoch(plain, 4242, hot_share=0.15)
    assert t.grid.split_cells() == []
    pair = _pair()
    with JM.scoped_registry(), TM.scoped_registry(), \
            JT.telemetry_session() as jtel, TT.telemetry_session() as ttel:
        for tel in (jtel, ttel):
            # all the attributed kernel time lands on cell 4242
            tel.costs.record_cells(np.full(10, 4242))
            tel.costs.attribute_kernel("range", 0.5, records=10)
        t = _hot_epoch(pair, 4242, hot_share=0.15)
        assert t.grid.split_cells() == [4242]
        assert [e["kind"] for e in jtel.events.list()] == \
            [e["kind"] for e in ttel.events.list()] == ["repartition"]
        strip = [{k: v for k, v in e.items()
                  if k not in ("ts_ms", "mono_ms")}
                 for e in (jtel.events.list()[0], ttel.events.list()[0])]
        assert strip[0] == strip[1]
        assert {k: g.get() for k, g in jtel.gauges.items()} == \
            {k: g.get() for k, g in ttel.gauges.items()} == \
            {"grid.version": 1.0, "grid.leaves": float(t.grid.num_leaves)}


def test_policy_validation_matches_jax():
    for mod in (JR, TR):
        with pytest.raises(ValueError, match="hysteresis"):
            mod.RepartitionPolicy(split_share=0.1, merge_share=0.1).validate()
        with pytest.raises(ValueError, match="coarsen_share"):
            mod.RepartitionPolicy(coarsen_share=0.5,
                                  uncoarsen_share=0.1).validate()
        assert mod.RepartitionPolicy().validate().split_share == 0.05


def test_split_cooldown_merge_and_hysteresis_match_jax():
    """A hot cell splits; a cooled one merges back only after the
    cooldown; a share inside the band (above merge_share) never merges;
    both packages step for step."""
    pair = _pair(cooldown_epochs=2)
    t = _hot_epoch(pair, 4242)
    assert t.grid.split_cells() == [4242] and t.grid.version == 1
    _hot_epoch(pair, 4242, hot_share=0.0, seed=1)
    assert t.grid.split_cells() == [4242]
    _hot_epoch(pair, 4242, hot_share=0.0, seed=2)
    assert t.grid.split_cells() == [] and t.grid.version == 2
    _hot_epoch(pair, 7, hot_share=0.6, seed=3)
    for s in range(4, 10):
        _hot_epoch(pair, 7, hot_share=0.1, seed=s)
        assert t.grid.split_cells() == [7]
    assert t.repartitions == 3 and t.epochs == 10


def test_max_splits_and_small_epochs_match_jax():
    pair = _pair(split_share=0.1, max_splits=2)
    t = _feed(pair, np.concatenate([np.full(300, 11), np.full(250, 22),
                                    np.full(200, 33),
                                    np.arange(250) % 10_000]))
    assert t.grid.split_cells() == [11, 22]
    # under both the policy floor and the interval: no decision; a tiny
    # interval still decides (the floor clamps to it)
    for interval, version in ((10_000, 0), (10, 1)):
        pair = _pair(interval=interval, min_epoch_records=1000)
        t = _feed(pair, np.full(50, 9))
        closed = [c.epoch() for c in pair]
        assert closed[0] == closed[1]
        assert _state(pair[1]) == _state(pair[0])
    assert t.grid.version == 1 and t.grid.split_cells() == [9]


def test_cold_blocks_coarsen_and_uncoarsen_match_jax():
    pair = _pair(coarsen_share=0.0005, uncoarsen_share=0.01,
                 cooldown_epochs=1)
    rng = np.random.default_rng(0)
    t = _feed(pair, 5000 + rng.integers(0, 50, 1000))
    assert (0, 0) in t.grid.coarse_blocks()
    t = _feed(pair, np.concatenate([np.full(100, 0),
                                    5000 + rng.integers(0, 50, 900)]))
    assert (0, 0) not in t.grid.coarse_blocks()
    assert t.grid.num_leaves == pair[0].grid.num_leaves


@pytest.mark.parametrize("interval", [700, 2048])
def test_default_policy_on_a_zipf_stream_matches_jax(interval):
    """The default policy (coarsening on) over a ``zipf_cells`` stream fed
    in uneven chunks, with the hot cell moving mid-stream and an early
    epoch requested: every epoch's layout, version, decisions and
    counters equal."""
    assert np.array_equal(TS.zipf_cells(20_000, seed=3),
                          JS.zipf_cells(20_000, seed=3))
    a = TS.zipf_cells(12_000, seed=3)
    b = TS.zipf_cells(12_000, seed=4, hot=321, hot_share=0.4)
    stream = np.concatenate([a, b])
    out = []
    for grid_cls, ag_cls, mod, met in ((JGrid, JAdaptive, JR, JM),
                                       (TGrid, TAdaptive, TR, TM)):
        ag = ag_cls(grid_cls(*BBOX, num_grid_partitions=100), refine=8)
        ctl = mod.RepartitionController(ag, interval_records=interval)
        states = []
        with met.scoped_registry() as reg:
            rng = np.random.default_rng(11)
            i = 0
            while i < stream.size:
                step = int(rng.integers(1, 900))
                ctl.note_cells(stream[i:i + step])
                i += step
                if i > 15_000 and ctl.epochs == 30:
                    ctl.request_epoch()
                states.append(_state(ctl))
            counters = {c: reg.counter(c).count
                        for c in ("repartitions", "grid-splits",
                                  "grid-merges")}
        status = ctl.status()
        status.pop("decisions")
        out.append((states, counters, status))
    assert out[1] == out[0]
    assert out[1][1]["repartitions"] >= 2 and out[1][1]["grid-merges"] >= 1


@pytest.mark.parametrize("interval,armed", [(700, False), (2048, True),
                                             (397, True)])
def test_observe_each_closes_epochs_where_one_by_one_does(interval, armed):
    """Restored window records reach the observer through
    ``observe_each``: the installed controller takes each array in one
    call per epoch (``note_each``), and every epoch closes at the same
    record as when the JAX controller is handed the cells one by one,
    outside cells and an early epoch request included. An observer
    chained before it still gets each cell alone."""
    stream = np.concatenate([TS.zipf_cells(6_000, seed=5),
                             TS.zipf_cells(6_000, seed=6, hot=321)])
    stream[::97] = -1
    j, t = _pair(refine=8, coarsen_share=0.0001, min_epoch_records=1,
                 interval=interval)
    seen = []
    tug._CELL_OBSERVER = lambda c: seen.append(np.asarray(c).size)
    t.install()
    try:
        rng = np.random.default_rng(2)
        i = 0
        while i < stream.size:
            step = int(rng.integers(1, 3_000))
            part = stream[i:i + step]
            if armed and i > 4_000:
                j.request_epoch()
                t.request_epoch()
            for k in range(part.size):
                j.note_cells(part[k:k + 1])
            tug.observe_each(part)
            assert _state(t) == _state(j)
            i += step
    finally:
        t.uninstall()
        tug._CELL_OBSERVER = None
    assert seen == [1] * stream.size
    assert t.epochs >= 5 and t.repartitions >= 1


# ---------------------------------------------------- registry, synthetic


def test_registry_matches_jax():
    for mod in (JM, TM):
        with mod.scoped_registry() as reg:
            assert mod.REGISTRY is reg
            reg.counter("a").inc()
            reg.counter("a").inc(4)
            m = reg.meter("m", window_s=5.0)
            for s in (0.0, 0.5, 1.2, 7.9):
                m.mark(2, now=100.0 + s)
            snap = reg.snapshot()
            rate = m.rate(now=108.0)
        assert mod.REGISTRY is not reg
        if mod is JM:
            want = (snap, rate)
    assert (snap, rate) == want
    assert snap == {"a": 5, "m.count": 8, "m.rate": rate}
    old = TM.set_registry(TM.MetricsRegistry())
    try:
        TM.REGISTRY.counter("x").inc()
        TM.REGISTRY.reset()
        assert TM.REGISTRY.snapshot() == {}
    finally:
        TM.set_registry(old)


def test_synthetic_streams_match_jax():
    jg, tg = (JGrid(*BBOX, num_grid_partitions=100),
              TGrid(*BBOX, num_grid_partitions=100))
    for hot in (0.0, 0.8):
        jx, jy = JS.clustered_xy(jg, 2000, hot, seed=5)
        tx, ty = TS.clustered_xy(tg, 2000, hot, seed=5)
        assert np.array_equal(tx, jx) and np.array_equal(ty, jy)
        for fmt in ("csv", "geojson"):
            assert TS.clustered_lines(tg, 300, hot, seed=2, fmt=fmt) == \
                JS.clustered_lines(jg, 300, hot, seed=2, fmt=fmt)
    jp = JS.clustered_points(jg, 500, 0.8, seed=1, hot_center=(116.4, 40.3))
    tp = TS.clustered_points(tg, 500, 0.8, seed=1, hot_center=(116.4, 40.3))
    assert [(p.obj_id, p.timestamp, p.x, p.y, p.cell) for p in tp] == \
        [(p.obj_id, p.timestamp, p.x, p.y, p.cell) for p in jp]
    with pytest.raises(ValueError, match="csv/geojson"):
        TS.clustered_lines(tg, 3, 0.5, fmt="wkt")


# ---------------------------------------------------------------- driver


@contextlib.contextmanager
def _controllers():
    """The repartition controllers both drivers make inside."""
    made = {"jax": [], "port": []}
    inits = {}
    for name, mod in (("jax", JR), ("port", TR)):
        init = inits[name] = mod.RepartitionController.__init__

        def new_init(self, *a, _init=init, _made=made[name], **kw):
            _init(self, *a, **kw)
            _made.append(self)
        mod.RepartitionController.__init__ = new_init
    try:
        yield made
    finally:
        for name, mod in (("jax", JR), ("port", TR)):
            mod.RepartitionController.__init__ = inits[name]


@pytest.mark.parametrize("opt,extra,kafka", [
    (1, [], False), (6, [], False), (11, [], False),
    (6, ["--multi-query"], False), (1, [], True), (6, ["--multi-query"], True),
])
def test_cli_matches_jax(tmp_path, capsys, monkeypatch, opt, extra, kafka):
    """``--adaptive-grid`` through both CLIs at the file path's decode
    chunk (4,096, also under ``--kafka``): stdout byte for byte (the
    Kafka output topics equal), the same prefilter and grid counters,
    epochs, decisions and final layout, and the cell observer restored
    after the run."""
    monkeypatch.setenv("SPATIALFLINK_DECODE_CHUNK", "4096")
    lines = _lines(9000, 0.8, seed=3, dt_ms=2)
    argv = ["--config", _conf(tmp_path, f"cli{opt}{kafka}"), "--option",
            str(opt), "--format", "CSV", "--adaptive-grid",
            "--repartition-interval", "2500"] + extra
    if kafka:
        argv.append("--kafka")
        KF.produce(f"memory://cli{opt}{kafka}", IN1, lines)
    else:
        inp = tmp_path / "in.csv"
        inp.write_text("\n".join(lines) + "\n")
        argv += ["--input1", str(inp)]
    with _controllers() as made:
        with JM.scoped_registry() as jreg:
            assert JD.main(argv) == 0
        want = capsys.readouterr().out
        with TM.scoped_registry() as treg:
            assert TD.main(argv + ["--device", "cpu"]) == 0
        got = capsys.readouterr()
    assert got.out == want and want.count("'window'") >= 3
    assert "# adaptive grid: hot cells split 4x4" in got.err
    (j,), (t,) = made["jax"], made["port"]
    assert _state(t) == _state(j) and t.repartitions >= 2
    counters = ("prefilter-records", "prefilter-kept",
                "prefilter-windows-skipped", "prefilter-mask-recomputes",
                "repartitions", "grid-splits", "grid-merges")
    assert {c: treg.counter(c).count for c in counters} == \
        {c: jreg.counter(c).count for c in counters}
    assert 0 < treg.counter("prefilter-kept").count < \
        treg.counter("prefilter-records").count
    assert tug._CELL_OBSERVER is None and TR.active_controller() is None
    if kafka:
        KF.assert_topics_equal(*[KF.topic(b) for b in KF.brokers(
            f"memory://cli{opt}{kafka}")])


def test_cli_flags(tmp_path, capsys):
    """A bad K is a flag error; ``--bulk`` ignores the flag with the JAX
    driver's note; ``--shard-order cell`` is accepted and changes nothing
    on one card; an option that does not prefilter runs with the flag."""
    inp = tmp_path / "in.csv"
    inp.write_text("\n".join(_lines(2000)) + "\n")
    base = ["--config", _conf(tmp_path, "flags"), "--input1", str(inp),
            "--format", "CSV", "--device", "cpu"]
    with pytest.raises(SystemExit) as e:
        TD.main(base + ["--option", "1", "--adaptive-grid", "1"])
    assert e.value.code == 2
    assert "--adaptive-grid: refine=1: must be >= 2" in \
        capsys.readouterr().err
    assert TD.main(base + ["--option", "1", "--bulk", "--adaptive-grid"]) == 0
    err = capsys.readouterr().err
    assert "--adaptive-grid ignored with --bulk" in err
    outs = []
    for extra in ([], ["--adaptive-grid", "--shard-order", "cell"],
                  ["--shard-order", "arrival"]):
        assert TD.main(base + ["--option", "1"] + extra) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] == outs[2] and outs[0]
    with pytest.raises(SystemExit):
        TD.main(base + ["--option", "1", "--shard-order", "rows"])
    capsys.readouterr()
    assert TD.main(base + ["--option", "51", "--adaptive-grid"]) == 0
    assert tug._CELL_OBSERVER is None


# -------------------------------------------------------------- recovery


def _table(broker):
    out = {}
    for r in broker.fetch("output", 0, 10 ** 7):
        if isinstance(r.key, str) and r.key.startswith(
                TK.KafkaWindowSink.MARKER):
            out.setdefault(r.key[len(TK.KafkaWindowSink.MARKER):],
                           []).append(int(r.value))
    return out


def _straddle_setup(tmp_path, name, pkg_brokers):
    lines = JS.clustered_lines(JGrid(*BBOX, num_grid_partitions=100), 900,
                               0.85, seed=9, fmt="geojson", dt_ms=120)
    with open(KF.CONF) as f:
        d = yaml.safe_load(f)
    d["kafkaBootStrapServers"] = f"memory://{name}"
    cfg = tmp_path / f"{name}.yml"
    cfg.write_text(yaml.safe_dump(d))
    for b in pkg_brokers(f"memory://{name}"):
        for ln in lines:
            b.produce(IN1, ln)
    return str(cfg)


def _crash_at(sink_cls, nth):
    orig = sink_cls.emit
    state = {"fresh": 0}

    def boom(self, result):
        if self.window_key(result) not in self.delivered:
            state["fresh"] += 1
            if state["fresh"] == nth:
                raise RuntimeError("injected crash")
        orig(self, result)
    return boom


def test_checkpoint_resume_straddles_a_repartition(tmp_path, monkeypatch,
                                                   capsys):
    """The port twin of the JAX ``test_checkpoint_resume_straddles_a_
    repartition``: a crash after a repartition has been checkpointed;
    the manifest's ``grid`` component holds the adapted layout, the resume
    restores it, and the window table equals the uninterrupted uniform
    run's, each window marked once. The uniform and the adaptive runs of
    the port give the same table (the JAX ``--chaos`` identity test's
    stand-in)."""
    monkeypatch.setenv("SPATIALFLINK_DECODE_CHUNK", "64")
    cfg_o = _straddle_setup(tmp_path, "straddle-oracle",
                            lambda u: [TK.resolve_broker(u)])
    assert TD.main(["--config", cfg_o, "--kafka", "--option", "1",
                    "--device", "cpu"]) == 0
    expected = {k: v[0] for k, v in _table(
        TK.resolve_broker("memory://straddle-oracle")).items()}
    cfg = _straddle_setup(tmp_path, "straddle",
                          lambda u: [TK.resolve_broker(u)])
    cpd = str(tmp_path / "cp-straddle")
    argv = ["--config", cfg, "--kafka", "--option", "1", "--adaptive-grid",
            "--repartition-interval", "150", "--checkpoint-dir", cpd,
            "--checkpoint-every", "2", "--device", "cpu"]
    with monkeypatch.context() as m:
        m.setattr(TK.KafkaWindowSink, "emit",
                  _crash_at(TK.KafkaWindowSink, 12))
        with pytest.raises(RuntimeError, match="injected crash"):
            TD.main(argv)
    assert tug._CELL_OBSERVER is None
    coord = TCoordinator(cpd, job=None)
    assert coord.load()
    saved = coord._pending["grid"][1]
    assert saved["version"] >= 1 and saved["split_cells"]
    with _controllers() as made:
        assert TD.main(argv + ["--resume"]) == 0
    (ctl,) = made["port"]
    assert ctl.grid.version >= saved["version"]
    assert "# resuming from checkpoint seq" in capsys.readouterr().err
    got = _table(TK.resolve_broker("memory://straddle"))
    assert all(len(v) == 1 for v in got.values()), got
    assert {k: v[0] for k, v in got.items()} == expected


def test_jax_checkpoint_with_a_grid_resumes_in_the_port(tmp_path,
                                                        monkeypatch):
    """The JAX driver crashes after a repartition with ``--checkpoint-dir``;
    the port resumes from its manifest against the same topics: the
    ``grid`` component comes back with the JAX layout and version (never
    rewound), and the window table is the JAX driver's uninterrupted one,
    each window marked once."""
    monkeypatch.setenv("SPATIALFLINK_DECODE_CHUNK", "64")
    cfg_o = _straddle_setup(tmp_path, "jx-oracle",
                            lambda u: [JK.resolve_broker(u)])
    assert JD.main(["--config", cfg_o, "--kafka", "--option", "1"]) == 0
    expected = {k: v[0] for k, v in _table(
        JK.resolve_broker("memory://jx-oracle")).items()}
    cfg = _straddle_setup(tmp_path, "jx", lambda u: [JK.resolve_broker(u)])
    cpd = str(tmp_path / "cp-jx")
    argv = ["--config", cfg, "--kafka", "--option", "1", "--adaptive-grid",
            "--repartition-interval", "150", "--checkpoint-dir", cpd,
            "--checkpoint-every", "2"]
    with monkeypatch.context() as m:
        m.setattr(JK.KafkaWindowSink, "emit",
                  _crash_at(JK.KafkaWindowSink, 12))
        with pytest.raises(RuntimeError, match="injected crash"):
            JD.main(argv)
    coord = JCoordinator(cpd, job=None)
    assert coord.load()
    saved = coord._pending["grid"][1]
    assert saved["version"] >= 1 and saved["split_cells"]
    from test_torch_state import _transplant

    jb, tb = KF.brokers("memory://jx")
    _transplant(jb, tb)
    layouts = []
    orig = TR.RepartitionController.register_checkpoint

    def register(self, c):
        orig(self, c)
        layouts.append(self.grid.layout())
    monkeypatch.setattr(TR.RepartitionController, "register_checkpoint",
                        register)
    with contextlib.redirect_stderr(io.StringIO()):
        assert TD.main(argv + ["--resume", "--device", "cpu"]) == 0
    assert layouts == [saved]
    got = _table(tb)
    assert all(len(v) == 1 for v in got.values()), got
    assert {k: v[0] for k, v in got.items()} == expected


def test_grid_component_round_trip(tmp_path):
    """A layout committed through one coordinator comes back in a fresh
    controller registered with a coordinator over the same directory, in
    the port and from a JAX-written manifest; the version is never
    rewound below the saved one."""
    for writer_ag, writer_ctl, writer_coord in (
            (JAdaptive(JGrid(*BBOX, num_grid_partitions=100), refine=4),
             JR.RepartitionController, JCoordinator),
            (TAdaptive(TGrid(*BBOX, num_grid_partitions=100), refine=4),
             TR.RepartitionController, TCoordinator)):
        path = str(tmp_path / f"cp-{writer_ctl.__module__}")
        writer_ag.apply_layout([7, 9], [(10, 10)])
        writer_ag.apply_layout([7, 9, 11], [(10, 10)])
        ctl = writer_ctl(writer_ag)
        coord = writer_coord(path, job="j")
        ctl.register_checkpoint(coord)
        coord.commit()
        ag = TAdaptive(TGrid(*BBOX, num_grid_partitions=100), refine=4)
        ag.apply_layout([5])
        c2 = TCoordinator(path, job="j")
        assert c2.load()
        TR.RepartitionController(ag).register_checkpoint(c2)
        assert ag.split_cells() == [7, 9, 11]
        assert ag.coarse_blocks() == [(10, 10)]
        assert ag.version == 2 and ag.layout() == writer_ag.layout()
