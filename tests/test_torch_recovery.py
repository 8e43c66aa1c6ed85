"""Coordinated checkpoints and exactly-once recovery in the port
(``runtime/checkpoint.py``, ``driver.main --checkpoint-dir/--resume`` and
the legacy ``--checkpoint``), held against the JAX driver's.

A run crashed at its Nth fresh window (the port's ``KafkaWindowSink.emit``
wrapped, as the JAX ``tests/test_recovery.py`` does) and resumed from its
newest valid checkpoint gives the window table ({window key: marker
count}) of the uninterrupted port run and of the JAX driver, every window
marked exactly once, and its replay covers only the records past the
checkpointed position. Then the edge cases: a crash inside a checkpoint
write, a corrupt newest manifest, retention, the refusals of another job,
layout or source, the SIGTERM drain, ``--limit`` across a resume, the
file path's journal, and the legacy single-file checkpoint of 205 and
207."""

import json
import os

import pytest

from spatialflink_tpu import driver as JD
from spatialflink_tpu.streams import kafka as JK

from spatialflink_tpu_torch import driver as TD
from spatialflink_tpu_torch.operators import knn_query
from spatialflink_tpu_torch.runtime.checkpoint import (CheckpointCoordinator,
                                                       CheckpointMismatch)
from spatialflink_tpu_torch.streams import kafka as TK
from spatialflink_tpu_torch.utils import metrics

import test_torch_kafka as KF

IN1, IN2 = KF.IN1, KF.IN2
GROUP = KF.GROUP


@pytest.fixture(autouse=True)
def _fresh_brokers():
    TK.reset_memory_brokers()
    JK.reset_memory_brokers()
    metrics.clear_shutdown()
    yield
    TK.reset_memory_brokers()
    JK.reset_memory_brokers()
    metrics.clear_shutdown()


def _crash_at_fresh_window(m, nth):
    """Make the port's window sink raise at its ``nth`` window not yet
    delivered (suppressed re-deliveries do not count)."""
    orig = TK.KafkaWindowSink.emit
    state = {"fresh": 0}

    def boom(self, result):
        if self.window_key(result) not in self.delivered:
            state["fresh"] += 1
            if state["fresh"] == nth:
                raise RuntimeError("injected crash")
        orig(self, result)

    m.setattr(TK.KafkaWindowSink, "emit", boom)


def _crash_at_emit(m, nth, exc=RuntimeError("injected crash")):
    """Make the port driver's result emission raise at its ``nth``
    result."""
    orig = TD._emit
    state = {"n": 0}

    def boom(result, sink):
        state["n"] += 1
        if state["n"] == nth:
            raise exc
        orig(result, sink)

    m.setattr(TD, "_emit", boom)


def _once(table):
    dups = {k: v for k, v in table.items() if len(v) > 1}
    assert not dups, f"windows marked more than once: {dups}"
    return {k: v[0] for k, v in table.items()}


# ------------------------------------------------------- crash and resume


@pytest.mark.parametrize("opt,two,extra", [
    (1, False, []), (101, True, []), (206, False, []),
    (51, False, ["--panes"]),
    (51, False, ["--panes", "--pane-merge", "device"]),
])
def test_crash_resume_window_table_identical(tmp_path, monkeypatch, opt,
                                             two, extra):
    """Crash at the 4th fresh window, resume: the window table is the
    uninterrupted port run's and the JAX driver's, each window marked
    once, the replay bounded, every input committed. Under the device
    pane merge the resumed run merges no window on the host: the restored
    kNN partials go onto the device beside the fresh ones."""
    # small decode chunks, so the checkpointed position lies inside the
    # small topic (at the default size the whole topic is one chunk)
    monkeypatch.setenv("SPATIALFLINK_DECODE_CHUNK", "32")
    recs = KF.lines()
    recs2 = KF.lines(seed=8) if two else []
    cfg, url = KF.conf(tmp_path, f"oracle{opt}")
    KF.produce(url, IN1, recs)
    KF.produce(url, IN2, recs2)
    base = ["--config", cfg, "--kafka", "--option", str(opt)] + extra
    assert JD.main(base) == 0
    assert TD.main(base + ["--device", "cpu"]) == 0
    jb, tb = KF.brokers(url)
    want = _once(KF.window_table(jb))
    assert want and _once(KF.window_table(tb)) == want

    cfg, url = KF.conf(tmp_path, f"crash{opt}")
    tb = TK.resolve_broker(url)
    for r in recs:
        tb.produce(IN1, r)
    for r in recs2:
        tb.produce(IN2, r)
    cpd = str(tmp_path / "cp")
    argv = ["--config", cfg, "--kafka", "--option", str(opt),
            "--checkpoint-dir", cpd, "--checkpoint-every", "2",
            "--device", "cpu"] + extra
    with monkeypatch.context() as m:
        _crash_at_fresh_window(m, 4)
        with pytest.raises(RuntimeError, match="injected crash"):
            TD.main(argv)
    coord = CheckpointCoordinator(cpd)
    assert coord.load()
    pos = coord.position(f"kafka:{IN1}")
    assert 0 < pos < len(recs), "the replay is not bounded"
    with monkeypatch.context() as m:
        if "device" in extra:
            def no_host_merge(*_a, **_k):
                raise AssertionError("a window took the host pane merge")
            m.setattr(knn_query, "merge_partials", no_host_merge)
        assert TD.main(argv + ["--resume"]) == 0
    assert _once(KF.window_table(tb)) == want
    assert tb.committed(IN1, GROUP) == len(recs)
    if two:
        assert tb.committed(IN2, GROUP) == len(recs2)


def test_crash_resume_realtime_knn_52(tmp_path, monkeypatch):
    """Realtime kNN 52 over the broker, crash after the 2nd result, resume:
    the results after the crash are the uninterrupted run's (the plain
    sink is at-least-once across a resume: a result may repeat, none is
    lost), and the group ends committed."""
    monkeypatch.setenv("SPATIALFLINK_DECODE_CHUNK", "32")
    recs = KF.lines(steps=400)
    cfg, url = KF.conf(tmp_path, "rt52", k=5)
    KF.produce(url, IN1, recs)
    argv = ["--config", cfg, "--kafka", "--option", "52"]
    want, got = KF.run_both(argv, url)
    KF.assert_topics_equal(want, got)
    assert len(want) >= 4

    cfg, url = KF.conf(tmp_path, "rt52c", k=5)
    tb = TK.resolve_broker(url)
    for r in recs:
        tb.produce(IN1, r)
    argv = ["--config", cfg, "--kafka", "--option", "52", "--device", "cpu",
            "--checkpoint-dir", str(tmp_path / "cp"), "--checkpoint-every",
            "1"]
    with monkeypatch.context() as m:
        _crash_at_emit(m, 2)
        with pytest.raises(RuntimeError):
            TD.main(argv)
    before = KF.topic(tb)
    coord = CheckpointCoordinator(str(tmp_path / "cp"))
    assert coord.load() and 0 < coord.position(f"kafka:{IN1}") < len(recs)
    assert TD.main(argv + ["--resume"]) == 0
    after = KF.topic(tb)[len(before):]
    # the resumed tail covers the uninterrupted run's from some batch on
    assert after and any(after == got[i:] for i in range(len(got)))
    assert before == got[:len(before)]
    assert set(map(json.dumps, before + after)) >= set(map(json.dumps, got))
    assert tb.committed(IN1, GROUP) == len(recs)


def test_realtime_tstats_file_resume_matches_uninterrupted(tmp_path,
                                                           monkeypatch):
    """Realtime tStats 205 over a file with ``--checkpoint-dir``: crash
    after the 2nd result, resume, and the final cumulative stats written to
    ``--output`` are the uninterrupted run's (and the JAX driver's within
    the tStats bound): K8a's carried state came back to the device."""
    recs = KF.lines(n_traj=4, steps=200)
    inp = tmp_path / "in.geojson"
    inp.write_text("\n".join(recs) + "\n")
    cfg, _ = KF.conf(tmp_path, "rt205")
    base = ["--config", cfg, "--option", "205", "--input1", str(inp)]
    outs = {}
    for name, main, dev in (("jax", JD.main, []),
                            ("port", TD.main, ["--device", "cpu"])):
        outs[name] = str(tmp_path / f"{name}.out")
        assert main(base + ["--output", outs[name]] + dev) == 0
    want = [json.loads(ln) for ln in open(outs["jax"]).read().splitlines()]
    oracle = [json.loads(ln) for ln in
              open(outs["port"]).read().splitlines()]
    KF.assert_topics_equal([(None, r) for r in want],
                           [(None, r) for r in oracle])
    cpd = str(tmp_path / "cp")
    argv = base + ["--device", "cpu", "--checkpoint-dir", cpd,
                   "--checkpoint-every", "1"]
    with monkeypatch.context() as m:
        _crash_at_emit(m, 2)
        with pytest.raises(RuntimeError):
            TD.main(argv + ["--output", str(tmp_path / "a.out")])
    resumed = str(tmp_path / "b.out")
    assert TD.main(argv + ["--resume", "--output", resumed]) == 0
    tail = [json.loads(ln) for ln in open(resumed).read().splitlines()]
    assert tail and tail == oracle[-len(tail):]


def test_dynamic_plane_resume_restores_the_fleet(tmp_path, monkeypatch):
    """The dynamic plane under ``--checkpoint-dir``: a fleet changed by the
    control topic is the ``queries`` component; a crash and a resume give
    the uninterrupted run's window table, and the resumed registry is the
    checkpointed fleet (the control topic not applied twice)."""
    monkeypatch.setenv("SPATIALFLINK_DECODE_CHUNK", "32")
    recs = KF.lines()
    q = tmp_path / "q.json"
    q.write_text(json.dumps([{"id": "a", "x": 116.5, "y": 40.5}]))
    ctl = [json.dumps({"action": "admit", "query": {
        "id": "c", "x": 116.8, "y": 40.6}})]
    tables = {}
    for name, crash in (("dyn-oracle", None), ("dyn-crash", 3)):
        cfg, url = KF.conf(tmp_path, name)
        tb = TK.resolve_broker(url)
        for r in recs:
            tb.produce(IN1, r)
        for r in ctl:
            tb.produce("ctl", r)
        argv = ["--config", cfg, "--kafka", "--option", "51",
                "--queries-file", str(q), "--control-topic", "ctl",
                "--device", "cpu"]
        if crash:
            argv += ["--checkpoint-dir", str(tmp_path / "cp"),
                     "--checkpoint-every", "2"]
            with monkeypatch.context() as m:
                _crash_at_fresh_window(m, crash)
                with pytest.raises(RuntimeError, match="injected crash"):
                    TD.main(argv)
            argv += ["--resume"]
        assert TD.main(argv) == 0
        tables[name] = {k.split(":", 1)[1]: v for k, v in
                        _once(KF.window_table(tb)).items()}
    assert tables["dyn-crash"] == tables["dyn-oracle"]
    coord = CheckpointCoordinator(str(tmp_path / "cp"))
    assert coord.load()
    meta = coord._pending["queries"][1]
    assert sorted(meta["fleet"]) == ["a", "c"] and meta["control_pos"] == 1


# ------------------------------------------------------------ edge cases


def _kafka_run(tmp_path, name, recs, opt=1, every=2, extra=()):
    cfg, url = KF.conf(tmp_path, name)
    tb = TK.resolve_broker(url)
    for r in recs:
        tb.produce(IN1, r)
    cpd = str(tmp_path / f"cp-{name}")
    argv = ["--config", cfg, "--kafka", "--option", str(opt),
            "--checkpoint-dir", cpd, "--checkpoint-every", str(every),
            "--device", "cpu", *extra]
    return tb, cpd, argv


def _oracle(tmp_path, recs, opt=1):
    cfg, url = KF.conf(tmp_path, f"or{opt}{len(recs)}")
    tb = TK.resolve_broker(url)
    for r in recs:
        tb.produce(IN1, r)
    assert TD.main(["--config", cfg, "--kafka", "--option", str(opt),
                    "--device", "cpu"]) == 0
    return _once(KF.window_table(tb))


def test_mid_checkpoint_write_crash_falls_back_and_recovers(tmp_path,
                                                            monkeypatch):
    """A crash inside the 2nd checkpoint's rename leaves only its .tmp:
    the resume takes checkpoint 1 and converges to the oracle."""
    recs = KF.lines()
    want = _oracle(tmp_path, recs)
    tb, cpd, argv = _kafka_run(tmp_path, "midwrite", recs)
    real = os.replace

    def torn(src, dst, *a, **kw):
        if "ckpt-00000002.npz" in str(dst):
            raise OSError("simulated crash mid-checkpoint-write")
        return real(src, dst, *a, **kw)

    with monkeypatch.context() as m:
        m.setattr(os, "replace", torn)
        with pytest.raises(OSError, match="mid-checkpoint-write"):
            TD.main(argv)
    names = sorted(os.listdir(cpd))
    assert "ckpt-00000001.npz" in names
    assert "ckpt-00000002.npz" not in names
    assert TD.main(argv + ["--resume"]) == 0
    assert _once(KF.window_table(tb)) == want
    assert not [n for n in os.listdir(cpd) if n.endswith(".tmp")]


def test_corrupt_newest_manifest_falls_back(tmp_path, monkeypatch, capsys):
    recs = KF.lines(steps=60)
    want = _oracle(tmp_path, recs)
    tb, cpd, argv = _kafka_run(tmp_path, "corrupt", recs)
    monkeypatch.setenv("SPATIALFLINK_DECODE_CHUNK", "32")
    with monkeypatch.context() as m:
        _crash_at_fresh_window(m, 8)
        with pytest.raises(RuntimeError, match="injected crash"):
            TD.main(argv)
    manifests = sorted(f for f in os.listdir(cpd) if f.endswith(".npz"))
    assert len(manifests) >= 2
    newest = os.path.join(cpd, manifests[-1])
    data = open(newest, "rb").read()
    open(newest, "wb").write(data[: len(data) // 3])
    assert TD.main(argv + ["--resume"]) == 0
    assert "falling back to the previous retained checkpoint" in \
        capsys.readouterr().err
    assert _once(KF.window_table(tb)) == want


def test_retention_prunes_old_manifests(tmp_path):
    _tb, cpd, argv = _kafka_run(tmp_path, "retain", KF.lines(steps=80),
                                every=1, extra=["--checkpoint-retain", "2"])
    assert TD.main(argv) == 0
    assert len([f for f in os.listdir(cpd) if f.endswith(".npz")]) == 2


def test_mismatch_refusals(tmp_path, capsys):
    """A checkpoint written by another job (query config), another
    execution layout (--panes) or another source refuses the resume, as
    the JAX driver's does; so does the coordinator alone."""
    recs = KF.lines()
    inp = tmp_path / "a.geojson"
    inp.write_text("\n".join(recs) + "\n")
    other = tmp_path / "b.geojson"
    other.write_text("\n".join(recs) + "\n")
    cfg, _ = KF.conf(tmp_path, "mm")
    cfg2, _ = KF.conf(tmp_path, "mm2", radius=9.5)
    cpd = str(tmp_path / "cp")
    base = ["--option", "1", "--checkpoint-dir", cpd, "--device", "cpu"]
    assert TD.main(["--config", cfg, "--input1", str(inp), "--panes",
                    "--checkpoint-every", "2"] + base) == 0
    for argv in (["--config", cfg2, "--input1", str(inp), "--panes"],
                 ["--config", cfg, "--input1", str(inp)],
                 ["--config", cfg, "--input1", str(other), "--panes"]):
        with pytest.raises(SystemExit):
            TD.main(argv + base + ["--resume"])
        with pytest.raises(SystemExit):  # the JAX driver refuses too
            JD.main(argv + ["--option", "1", "--checkpoint-dir", cpd,
                            "--resume"])
    with pytest.raises(CheckpointMismatch, match="job fingerprint"):
        CheckpointCoordinator(cpd, job="another-job").load()


def test_sigterm_graceful_drain_writes_final_checkpoint(tmp_path,
                                                        monkeypatch, capsys):
    """A stop request mid-stream (what the SIGTERM handler sets) drains the
    records read, writes a final checkpoint and exits 0; ``--resume``
    completes the stream, and stopped + resumed output is the
    uninterrupted run's."""
    recs = KF.lines(n_traj=8, steps=60)
    inp = tmp_path / "in.geojson"
    inp.write_text("\n".join(recs) + "\n")
    cfg, _ = KF.conf(tmp_path, "sig")
    monkeypatch.setenv("SPATIALFLINK_DECODE_CHUNK", "16")
    base = ["--config", cfg, "--option", "1", "--input1", str(inp),
            "--device", "cpu"]
    assert TD.main(base) == 0
    oracle = capsys.readouterr().out.splitlines()
    argv = base + ["--checkpoint-dir", str(tmp_path / "cp"),
                   "--checkpoint-every", "2"]
    orig = TD._emit
    state = {"n": 0}

    def stop_after_two(result, sink):
        orig(result, sink)
        state["n"] += 1
        if state["n"] == 2:
            metrics.request_shutdown()

    with monkeypatch.context() as m:
        m.setattr(TD, "_emit", stop_after_two)
        assert TD.main(argv) == 0
    cap = capsys.readouterr()
    stopped = cap.out.splitlines()
    assert "graceful shutdown: final checkpoint" in cap.err
    assert 0 < len(stopped) < len(oracle)
    assert TD.main(argv + ["--resume"]) == 0
    resumed = capsys.readouterr().out.splitlines()
    assert sorted(stopped + resumed) == sorted(oracle)


@pytest.mark.parametrize("opt", [1, 51, 206])
def test_file_path_resume_exactly_once_with_limit(tmp_path, monkeypatch,
                                                  capsys, opt):
    """The file path's journal: crash at the 5th window, resume; crashed +
    resumed stdout is the uninterrupted run's, also when ``--limit``
    bounds the original record range across the resume."""
    recs = KF.lines()
    inp = tmp_path / "in.geojson"
    inp.write_text("\n".join(recs) + "\n")
    cfg, _ = KF.conf(tmp_path, "fj")
    monkeypatch.setenv("SPATIALFLINK_DECODE_CHUNK", "32")
    for limit in ([], ["--limit", "150"]):
        base = ["--config", cfg, "--option", str(opt), "--input1", str(inp),
                "--device", "cpu"] + limit
        assert TD.main(base) == 0
        oracle = capsys.readouterr().out.splitlines()
        argv = base + ["--checkpoint-dir", str(tmp_path / f"cp{len(limit)}"),
                       "--checkpoint-every", "2"]
        with monkeypatch.context() as m:
            _crash_at_emit(m, 5)
            with pytest.raises(RuntimeError):
                TD.main(argv)
        crashed = capsys.readouterr().out.splitlines()
        assert TD.main(argv + ["--resume"]) == 0
        resumed = capsys.readouterr().out.splitlines()
        assert sorted(crashed + resumed) == sorted(oracle)


def test_checkpoint_dir_gates(tmp_path, capsys):
    recs = KF.lines(steps=6)
    inp = tmp_path / "in.geojson"
    inp.write_text("\n".join(recs) + "\n")
    cfg, _ = KF.conf(tmp_path, "gates")
    base = ["--config", cfg, "--input1", str(inp), "--device", "cpu"]
    with pytest.raises(SystemExit):
        TD.main(base + ["--option", "1", "--resume"])
    with pytest.raises(SystemExit):
        TD.main(base + ["--option", "1", "--bulk", "--checkpoint-dir",
                        str(tmp_path / "cp1")])
    with pytest.raises(SystemExit):
        TD.main(base + ["--option", "205", "--checkpoint",
                        str(tmp_path / "x.npz"), "--checkpoint-dir",
                        str(tmp_path / "cp2")])
    cpd = str(tmp_path / "cp3")
    assert TD.main(base + ["--option", "201", "--checkpoint-dir", cpd]) == 0
    assert "--checkpoint-dir ignored" in capsys.readouterr().err
    assert not os.path.exists(os.path.join(cpd, "ckpt-00000001.npz"))


# ------------------------------------------------- the legacy --checkpoint


@pytest.mark.parametrize("opt", [205, 207])
def test_legacy_checkpoint_resume_matches_jax(tmp_path, capsys, opt):
    """``--checkpoint`` of realtime tStats / tAggregate: a run over the
    first 700 records, then the same command over the whole file (the
    replay skips the records the saved state reflects; 205's state goes
    back to the device, and K8a carries it on). Both drivers print the
    same windows and save the same state (205's spatial lengths within the
    tStats bound), and 205 ends with the uninterrupted run's final stats
    (within the same bound: batches cut elsewhere sum in other f32
    groups)."""
    from spatialflink_tpu.runtime.state import CheckpointableState as JCS

    from spatialflink_tpu_torch.runtime.state import CheckpointableState

    recs = KF.lines(n_traj=5, steps=240)
    inp = tmp_path / "in.geojson"
    inp.write_text("\n".join(recs) + "\n")
    cfg, _ = KF.conf(tmp_path, "legacy")
    runs = {}
    for name, main, dev in (("jax", JD.main, []),
                            ("port", TD.main, ["--device", "cpu"])):
        ck = str(tmp_path / f"{name}.npz")
        out = str(tmp_path / f"{name}.out")
        base = ["--config", cfg, "--option", str(opt), "--input1", str(inp),
                "--checkpoint-every", "1"] + dev
        assert main(base + ["--checkpoint", ck, "--limit", "700"]) == 0
        assert main(base + ["--checkpoint", ck, "--output", out]) == 0
        runs[name] = (capsys.readouterr().out.splitlines(),
                      [json.loads(ln) for ln in open(out)])
    (jout, jrec), (tout, trec) = runs["jax"], runs["port"]
    assert len(tout) == len(jout) > 0
    j, t = JCS.load(str(tmp_path / "jax.npz")), CheckpointableState.load(
        str(tmp_path / "port.npz"))
    assert j.meta["consumed"] == t.meta["consumed"] == len(recs)
    assert sorted(j.arrays) == sorted(t.arrays)
    if opt == 207:
        assert tout == jout
        assert j.meta["obj_id"] == t.meta["obj_id"]
        for k in j.arrays:
            assert (j.arrays[k] == t.arrays[k]).all()
        return
    KF.assert_topics_equal([(None, r) for r in jrec],
                           [(None, r) for r in trec])
    full = str(tmp_path / "full.out")
    assert TD.main(["--config", cfg, "--option", "205", "--input1",
                    str(inp), "--output", full, "--device", "cpu"]) == 0
    final = {r[0]: r for r in map(json.loads, open(full))}
    resumed = {r[0]: r for r in trec}
    assert sorted(resumed) == sorted(final)
    # batches cut at other records sum each run in other f32 groups
    KF.assert_topics_equal([(None, final[k]) for k in sorted(final)],
                           [(None, resumed[k]) for k in sorted(final)])


def test_legacy_checkpoint_job_mismatch_refused(tmp_path):
    recs = KF.lines()
    inp = tmp_path / "in.geojson"
    inp.write_text("\n".join(recs) + "\n")
    cfg, _ = KF.conf(tmp_path, "la")
    cfg2, _ = KF.conf(tmp_path, "lb", trajIDs=["traj-0", "traj-1"])
    ck = str(tmp_path / "tstats.npz")
    assert TD.main(["--config", cfg, "--option", "205", "--input1", str(inp),
                    "--checkpoint", ck, "--device", "cpu"]) == 0
    with pytest.raises(SystemExit):
        TD.main(["--config", cfg2, "--option", "205", "--input1", str(inp),
                 "--checkpoint", ck, "--device", "cpu"])
