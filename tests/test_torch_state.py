"""Checkpoint state shared with the JAX package: the ``CheckpointableState``
file (saved by either package, loaded by the other), the record and
pane-partial codecs, ``Params.job_fingerprint``, the window assemblers'
snapshot forms, ``TrajStateStore``'s snapshot (host copies) and restore
(fresh tensors), and a resume in the port from a checkpoint directory the
JAX driver wrote (options 1 and 51 with panes over a file, 206 and 51
with panes over the broker), whose output completes the JAX driver's
uninterrupted window table."""

import glob
import json
import os

import numpy as np
import pytest
import torch

from spatialflink_tpu import driver as JD
from spatialflink_tpu.config import Params as JParams
from spatialflink_tpu.runtime import checkpoint as JC
from spatialflink_tpu.runtime import state as JS
from spatialflink_tpu.runtime.windows import (MicroBatcher as JMB,
                                              PaneBuffer as JPB,
                                              WindowAssembler as JWA,
                                              WindowSpec as JSpec)

from spatialflink_tpu_torch import driver as TD
from spatialflink_tpu_torch.config import Params as TParams
from spatialflink_tpu_torch.ops.trajectory import INT32_MIN
from spatialflink_tpu_torch.runtime import checkpoint as TC
from spatialflink_tpu_torch.runtime import state as TS
from spatialflink_tpu_torch.runtime.windows import (MicroBatcher,
                                                    PaneBuffer,
                                                    WindowAssembler,
                                                    WindowSpec, view_objects)

import test_torch_geom_stream as GS
import test_torch_kafka as KF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_checkpoint_files_load_across_packages(tmp_path):
    """A file saved by either package loads in the other, checksum
    verified, arrays and meta equal; both refuse the other's truncated
    file and a newer schema."""
    arrays = {"a/x": np.arange(7, dtype=np.float32),
              "b/y": np.array([[1, 2], [3, 4]], np.int64),
              "c": np.zeros(0, np.int32)}
    meta = {"job": "abcd1234", "positions": {"kafka:t": 5},
            "components": {"windows": {"buffers": {"0": ["r"]}}}}
    for save_cls, load_cls, name in ((TS.CheckpointableState,
                                      JS.CheckpointableState, "t.npz"),
                                     (JS.CheckpointableState,
                                      TS.CheckpointableState, "j.npz")):
        cp = save_cls()
        cp.arrays.update(arrays)
        cp.meta = dict(meta)
        path = str(tmp_path / name)
        cp.save(path)
        back = load_cls.load(path)
        assert back.meta == meta
        assert sorted(back.arrays) == sorted(arrays)
        for k, v in arrays.items():
            assert back.arrays[k].dtype == v.dtype
            assert (back.arrays[k] == v).all()
        data = open(path, "rb").read()
        open(path, "wb").write(data[: len(data) // 2])
        for cls, err in ((TS.CheckpointableState, TS.CheckpointCorrupt),
                         (JS.CheckpointableState, JS.CheckpointCorrupt)):
            with pytest.raises(err):
                cls.load(path)
    cp = TS.CheckpointableState()
    cp.meta = {"x": 1}
    cp.save(str(tmp_path / "n.npz"))
    with np.load(str(tmp_path / "n.npz")) as z:
        env = json.loads(str(z["__meta__"]))
    env["schema"] = TS.STATE_SCHEMA_VERSION + 1
    np.savez(str(tmp_path / "n.npz"), __meta__=json.dumps(env))
    with pytest.raises(TS.CheckpointCorrupt, match="newer"):
        TS.CheckpointableState.load(str(tmp_path / "n.npz"))
    assert TS.checkpoint_consumed(str(tmp_path / "missing.npz")) == 0


def test_codecs_match_jax():
    """The record codec writes the JAX package's GeoJSON (raw epoch ms);
    the value codec's encodings are the JAX codec's, and each decodes the
    other's."""
    grid = TParams.from_yaml(KF.CONF).grids()[0]
    jgrid = JParams.from_yaml(KF.CONF).grids()[0]
    t_enc, t_dec = TC.record_codec(grid)
    j_enc, j_dec = JC.record_codec(jgrid)
    for line in KF.lines(steps=3) + GS.GEOJSON[:40]:
        jobj = JD._parse_fn(JParams.from_yaml(KF.CONF).input1, jgrid,
                            "Point")(line) if '"Point"' in line else None
        tobj = t_dec(j_enc(j_dec(line)))
        assert t_enc(tobj) == j_enc(j_dec(line))
        if jobj is not None:
            assert t_enc(tobj) == j_enc(jobj)
    p = t_dec(t_enc(t_dec(KF.lines(steps=1)[0])))
    values = [None, True, 3, 2.5, "s", np.float32(1.5), np.arange(4.0),
              ("a", 1.25), [("a", 1.0), ("b", 2.0)], {"x", "y"},
              {"spatial": np.ones(3, np.float32), "count": np.arange(3)},
              (np.arange(2), np.arange(2, dtype=np.int64) + 7)]
    t_venc, t_vdec = TC.value_codec(grid)
    j_venc, j_vdec = JC.value_codec(jgrid)
    for v in values:
        te, je = t_venc(v), j_venc(v)
        assert json.dumps(te, sort_keys=True) == json.dumps(je,
                                                            sort_keys=True)
        for dec in (t_vdec, j_vdec):
            back = dec(json.loads(json.dumps(te)))
            assert json.dumps(t_venc(back), sort_keys=True) == \
                json.dumps(te, sort_keys=True)
    assert t_venc(p)["__geo__"] == t_enc(p)
    with pytest.raises(TypeError):
        t_venc(object())


@pytest.mark.parametrize("group", ["", "spatialflink", "g2"])
def test_job_fingerprint_matches_jax(group):
    """On every conf/ file, and with knobs the fingerprint leaves out
    (panes, mesh shape) and fields it keeps (radius, window)."""
    paths = sorted(glob.glob(os.path.join(REPO, "conf", "*.yml")))
    assert paths
    for path in paths:
        j, t = JParams.from_yaml(path), TParams.from_yaml(path)
        assert t.job_fingerprint(group) == j.job_fingerprint(group)
        for p in (j, t):
            p.query.panes = True
            p.query.parallelism = 4
        assert t.job_fingerprint(group) == j.job_fingerprint(group)
        base = t.job_fingerprint(group)
        for p in (j, t):
            p.query.radius = 0.125
            p.window.interval_s = 7.0
        assert t.job_fingerprint(group) == j.job_fingerprint(group) != base


def _streams(n=300, chunk=37):
    """The same records as JAX Points (per record) and as the port's
    decoded chunks."""
    lines = KF.lines(steps=50)[:n]
    jp = JParams.from_yaml(KF.CONF)
    tp = TParams.from_yaml(KF.CONF)
    parse = JD._parse_fn(jp.input1, jp.grids()[0], "Point")
    jrecs = [parse(ln) for ln in lines]
    chunks = list(TD.decode_chunks(lines, tp.input1, tp.grids()[0], chunk))
    return jrecs, chunks, tp.grids()[0], jp.grids()[0]


def _feed_jax(asm, recs):
    out = []
    for r in recs:
        if isinstance(asm, JMB):
            out.extend(asm.add_records([r]))
        else:
            out.extend(asm.add(r.timestamp, r))
    return out


def _norm_windows(ws, enc):
    def recs(x):
        if isinstance(x, list) and x and isinstance(x[0], tuple):
            return [(p, recs(r)) for p, r in x]  # pane lists
        objs = x if isinstance(x, list) else view_objects(x)
        return [enc(o) for o in objs]
    return [(s, e, recs(r)) for s, e, r in ws]


@pytest.mark.parametrize("kind", ["windows", "panes", "batcher"])
def test_assembler_snapshots_match_jax(kind):
    """The JSON snapshot of each assembler after the same records is the
    JAX one's; the JAX snapshot restored into the port's assembler and
    fed the rest gives the windows of an uninterrupted port assembler."""
    jrecs, chunks, grid, jgrid = _streams()
    t_enc, t_dec = TC.record_codec(grid)
    j_enc, _ = JC.record_codec(jgrid)
    spec, jspec = WindowSpec(10_000, 5_000), JSpec(10_000, 5_000)
    make = {"windows": (lambda: WindowAssembler(spec, 1000),
                        lambda: JWA(jspec, 1000)),
            "panes": (lambda: PaneBuffer(spec, 1000),
                      lambda: JPB(jspec, 1000)),
            "batcher": (lambda: MicroBatcher(64), lambda: JMB(64))}[kind]
    cut = 4  # chunks fed before the snapshot
    n_cut = sum(len(c) for c in chunks[:cut])

    def feed(asm, chs):
        out = []
        for c in chs:
            out.extend(asm.add_chunk(c) if kind == "batcher"
                       else asm.add_parsed_chunk(c))
        return out

    port = make[0]()
    first = feed(port, chunks[:cut])
    jax = make[1]()
    jfirst = _feed_jax(jax, jrecs[:n_cut])
    assert _norm_windows(first, t_enc) == _norm_windows(jfirst, j_enc)
    snap = port.snapshot(t_enc)
    assert json.dumps(snap, sort_keys=True) == \
        json.dumps(jax.snapshot(j_enc), sort_keys=True)
    rest = feed(port, chunks[cut:])
    rest += list(port.batches([]) if kind == "batcher" else port.flush())
    resumed = make[0]()
    resumed.restore(json.loads(json.dumps(jax.snapshot(j_enc))), t_dec)
    got = feed(resumed, chunks[cut:])
    got += list(resumed.batches([]) if kind == "batcher"
                else resumed.flush())
    assert rest and _norm_windows(got, t_enc) == _norm_windows(rest, t_enc)


def test_restored_records_share_the_stream_interner():
    """Restored point records become one chunk interned through the next
    chunk's interner, so a mixed window's batch has one id space."""
    jrecs, chunks, grid, _ = _streams(chunk=50)
    enc, dec = TC.record_codec(grid)
    wa = WindowAssembler(WindowSpec(10_000, 5_000), 0)
    list(wa.add_parsed_chunk(chunks[0]))
    snap = json.loads(json.dumps(wa.snapshot(enc)))
    wb = WindowAssembler(WindowSpec(10_000, 5_000), 0)
    wb.restore(snap, dec)
    out = list(wb.add_parsed_chunk(chunks[1])) + list(wb.flush())
    interner = chunks[1].parsed.interner
    for _, _, recs in out:
        assert recs.interner is interner
        batch, _ = recs.point_batch(0, torch.device("cpu"))
        ids = batch.obj_id[batch.valid].numpy()
        names = [p.obj_id for p in view_objects(recs)]
        assert [interner.lookup(int(i)) for i in ids] == names


def test_traj_state_store_snapshot_copies_and_restore_is_fresh():
    """A snapshot is a host copy (K8a updates the state in place, and
    ``.numpy()`` of a CPU tensor aliases it); a restore builds fresh
    contiguous tensors that no loaded buffer aliases; the snapshot loads
    as the JAX package's ``TrajStateStore`` payload."""
    store = TS.TrajStateStore(capacity=8)
    store.state.spatial[:] = torch.arange(8, dtype=torch.float32)
    store.state.last_ts[3] = 77
    cp = store.snapshot()
    store.state.spatial[:] = -1.0  # an in-place update after the snapshot
    assert cp.arrays["spatial"].tolist() == list(map(float, range(8)))
    restored = TS.TrajStateStore.restore(cp, "cpu")
    for name, t in restored.state._asdict().items():
        assert t.is_contiguous()
        assert not np.shares_memory(t.numpy(), cp.arrays[name])
    restored.state.spatial[:] = 5.0
    assert cp.arrays["spatial"][0] == 0.0
    assert restored.capacity == 8
    assert int(restored.state.last_ts[0]) == INT32_MIN
    assert int(restored.state.last_ts[3]) == 77
    jstore = JS.TrajStateStore.restore(cp)
    assert np.asarray(jstore.state.spatial).tolist() == \
        cp.arrays["spatial"].tolist()


@pytest.mark.parametrize("opt,extra", [(1, []), (51, ["--panes"])])
def test_jax_checkpoint_resumes_in_the_port(tmp_path, monkeypatch, capsys,
                                            opt, extra):
    """The JAX driver crashes at its 5th window over a file with
    ``--checkpoint-dir``; the port's driver resumes from that directory
    (its manifest, codecs, layout tag, job fingerprint and journal), and
    crashed + resumed stdout is the JAX driver's uninterrupted run."""
    recs = KF.lines()
    inp = tmp_path / "in.geojson"
    inp.write_text("\n".join(recs) + "\n")
    cfg, _ = KF.conf(tmp_path, f"x{opt}")
    monkeypatch.setenv("SPATIALFLINK_DECODE_CHUNK", "32")
    base = ["--config", cfg, "--option", str(opt), "--input1",
            str(inp)] + extra
    assert JD.main(base) == 0
    oracle = capsys.readouterr().out.splitlines()
    argv = base + ["--checkpoint-dir", str(tmp_path / "cp"),
                   "--checkpoint-every", "2"]
    orig = JD._emit
    state = {"n": 0}

    def boom(result, sink):
        state["n"] += 1
        if state["n"] == 5:
            raise RuntimeError("injected crash")
        orig(result, sink)

    with monkeypatch.context() as m:
        m.setattr(JD, "_emit", boom)
        with pytest.raises(RuntimeError):
            JD.main(argv)
    crashed = capsys.readouterr().out.splitlines()
    assert TD.main(argv + ["--resume", "--device", "cpu"]) == 0
    cap = capsys.readouterr()
    assert "# resuming from checkpoint seq" in cap.err
    assert sorted(crashed + cap.out.splitlines()) == sorted(oracle)


def _transplant(jb, tb):
    """The JAX broker's topics and commits into the port's (one cluster
    the two drivers share)."""
    from spatialflink_tpu_torch.streams.kafka import BrokerRecord

    tb._topics = {t: [BrokerRecord(r.offset, r.key, r.value,
                                   r.timestamp_ms) for r in log]
                  for t, log in jb._topics.items()}
    tb._commits = dict(jb._commits)


@pytest.mark.parametrize("opt,extra", [(206, []), (51, ["--panes"])])
def test_jax_kafka_checkpoint_resumes_in_the_port(tmp_path, monkeypatch,
                                                  opt, extra):
    """Over the broker: the JAX driver crashes at its 4th fresh window
    with ``--checkpoint-dir``; the port resumes against the same topics
    (the output topic's markers and the group's commits) and completes the
    JAX driver's uninterrupted window table, each window marked once.
    (206 resumes over the broker: the JAX file path of the trajectory
    families notes positions past the records its per-record window loop
    has not taken yet.)"""
    monkeypatch.setenv("SPATIALFLINK_DECODE_CHUNK", "32")
    recs = KF.lines()
    cfg, url = KF.conf(tmp_path, f"xo{opt}")
    jb = KF.brokers(url)[0]
    for r in recs:
        jb.produce(KF.IN1, r)
    assert JD.main(["--config", cfg, "--kafka", "--option", str(opt)]
                   + extra) == 0
    want = {k: v[0] for k, v in KF.window_table(jb).items()}
    cfg, url = KF.conf(tmp_path, f"xc{opt}")
    jb, tb = KF.brokers(url)
    for r in recs:
        jb.produce(KF.IN1, r)
    argv = ["--config", cfg, "--kafka", "--option", str(opt),
            "--checkpoint-dir", str(tmp_path / "cp"), "--checkpoint-every",
            "2"] + extra
    orig = KF.JK.KafkaWindowSink.emit
    state = {"fresh": 0}

    def boom(self, result):
        if self.window_key(result) not in self.delivered:
            state["fresh"] += 1
            if state["fresh"] == 4:
                raise RuntimeError("injected crash")
        orig(self, result)

    with monkeypatch.context() as m:
        m.setattr(KF.JK.KafkaWindowSink, "emit", boom)
        with pytest.raises(RuntimeError):
            JD.main(argv)
    _transplant(jb, tb)
    assert TD.main(argv + ["--resume", "--device", "cpu"]) == 0
    table = KF.window_table(tb)
    assert all(len(v) == 1 for v in table.values()), table
    assert {k: v[0] for k, v in table.items()} == want
    assert tb.committed(KF.IN1, KF.GROUP) == len(recs)
