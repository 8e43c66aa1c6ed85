"""The port's telemetry session through ``driver.main`` against the JAX
driver's: options 1, 51, 51 with ``--panes`` and 6 over ``--kafka`` with
``--checkpoint-dir``, each with ``--telemetry-dir`` and ``--trace-dir``.
stdout equals the same run without a session byte for byte, and the two
packages' snapshots have the same keys, counters (meter rates aside: they
are wall-clock rates), span counts per stage and family, cell occupancy,
cost records per cell, latency-plane window counts, trace counts and event
kinds. The reporter's interval is long, so the only snapshots are the
first and the last (the time-driven buckets never close)."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from spatialflink_tpu import driver as JD
from spatialflink_tpu.utils import metrics as JM
from spatialflink_tpu.utils import telemetry as JT

from spatialflink_tpu_torch import driver as TD
from spatialflink_tpu_torch.utils import metrics as TM
from spatialflink_tpu_torch.utils import telemetry as TT

import test_torch_kafka as KF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "conf", "spatialflink-conf.yml")

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_brokers():
    KF.TK.reset_memory_brokers()
    KF.JK.reset_memory_brokers()
    yield
    KF.TK.reset_memory_brokers()
    KF.JK.reset_memory_brokers()


#: the sentinel's run state in both packages' process-wide compile registries
_SENTINEL = ("warm", "warm_reason", "warm_at_ms", "strict", "run_compiles",
             "run_recompiles")


@pytest.fixture(autouse=True)
def _sentinel_restored():
    """Each package's compile registry lives as long as the process: the
    sentinel state a driver run leaves (a growing run's post-warmup
    compiles) is put back after each test, so a later test in this worker
    that reads a status block sees what it would see without this file."""
    from spatialflink_tpu.utils import deviceplane as jdp
    from spatialflink_tpu_torch.utils import deviceplane as tdp

    regs = (jdp.registry(), tdp.registry())
    saved = [{k: getattr(r, k) for k in _SENTINEL} for r in regs]
    yield
    for r, state in zip(regs, saved):
        for k, v in state.items():
            setattr(r, k, v)


@pytest.fixture(autouse=True)
def _cold():
    """Compiles count once per process and signature in both packages:
    both start cold, so ``device-compiles`` compares whatever ran before
    in this worker."""
    import jax

    from spatialflink_tpu_torch.utils import deviceplane

    jax.clear_caches()
    for entry in deviceplane.registry().entries.values():
        if entry.kind == "kernel":
            entry.seen.clear()


def _sessions(monkeypatch, mod):
    """Every Telemetry a package's session activates, in order."""
    seen = []
    orig = mod.set_active

    def spy(tel):
        if tel is not None:
            seen.append(tel)
        return orig(tel)

    monkeypatch.setattr(mod, "set_active", spy)
    return seen


def _run(main, argv, reg_mod):
    """``main(argv)`` under a fresh registry: (rc, stdout, stderr)."""
    out, err = io.StringIO(), io.StringIO()
    with reg_mod.scoped_registry(), contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _snapshots(d):
    with open(os.path.join(d, "telemetry.jsonl")) as f:
        return [json.loads(line) for line in f]


def _keys(d, pre=""):
    """Nested key paths of a snapshot (maps keyed by names are opaque)."""
    out = set()
    for k, v in d.items():
        out.add(pre + k)
        if isinstance(v, dict) and k not in (
                "spans", "counters", "gauges", "histograms", "families",
                "stages", "tenants", "backend", "degradation"):
            out |= _keys(v, pre + k + ".")
    return out


#: the device block's provenance names its framework's version
BACKEND_KEYS = {"jax_version", "torch_version", "cuda_version"}


def _case(tmp_path, opt, extra):
    """(argv without the telemetry flags, kafka url or None)."""
    if "--kafka" in extra:
        cfg, url = KF.conf(tmp_path, f"tel{opt}")
        KF.produce(url, KF.IN1, KF.lines(n_traj=6, steps=60))
        return ["--config", cfg, "--option", str(opt), *extra,
                "--checkpoint-dir", str(tmp_path / "ck")], url
    inp = tmp_path / "in.geojson"
    inp.write_text("\n".join(KF.lines(n_traj=6, steps=60)) + "\n")
    return ["--config", CONF, "--option", str(opt), "--input1", str(inp),
            "--format", "GeoJSON", *extra], None


@pytest.mark.parametrize("opt,extra", [
    (1, []), (51, []), (51, ["--panes"]), (6, ["--kafka"]),
])
def test_session_matches_jax_and_leaves_stdout_alone(tmp_path, monkeypatch,
                                                     opt, extra):
    argv, url = _case(tmp_path, opt, extra)
    tel_args = ["--telemetry-interval", "1000", "--metrics"]
    jt, tt = _sessions(monkeypatch, JT), _sessions(monkeypatch, TT)
    rc, j_out, _ = _run(JD.main, argv + tel_args + [
        "--telemetry-dir", str(tmp_path / "jt"),
        "--trace-dir", str(tmp_path / "jtr")], JM)
    assert rc == 0
    if url is not None:
        KF.TK.reset_memory_brokers()
        KF.produce(url, KF.IN1, KF.lines(n_traj=6, steps=60))
        argv[-1] = str(tmp_path / "ck2")
    rc, t_out, t_err = _run(TD.main, argv + tel_args + [
        "--device", "cpu", "--telemetry-dir", str(tmp_path / "tt"),
        "--trace-dir", str(tmp_path / "ttr")], TM)
    assert rc == 0
    assert "# telemetry: JSONL snapshots" in t_err
    if url is not None:
        KF.TK.reset_memory_brokers()
        KF.produce(url, KF.IN1, KF.lines(n_traj=6, steps=60))
        argv[-1] = str(tmp_path / "ck3")
    rc, plain_out, _ = _run(TD.main, argv + ["--device", "cpu"], TM)
    assert rc == 0
    # the session changes nothing on stdout; the JAX driver prints alike
    assert t_out == plain_out and t_out
    assert t_out == j_out
    js, ts = _snapshots(tmp_path / "jt"), _snapshots(tmp_path / "tt")
    assert len(ts) >= 2 and len(js) == len(ts)
    j, t = js[-1], ts[-1]
    assert _keys(j) == _keys(t)
    assert set(j["device"]["backend"]) - BACKEND_KEYS == \
        set(t["device"]["backend"]) - BACKEND_KEYS
    assert t["device"]["backend"]["platform"] == "cpu"

    def counters(s):
        return {k: v for k, v in s["counters"].items()
                if not k.endswith(".rate")}

    assert counters(j) == counters(t)
    assert {k: v["count"] for k, v in j["spans"].items()} == \
        {k: v["count"] for k, v in t["spans"].items()}
    assert {k: v["count"] for k, v in j["histograms"].items()} == \
        {k: v["count"] for k, v in t["histograms"].items()}
    assert j["grid"] == t["grid"]
    assert sorted(j["gauges"]) == sorted(t["gauges"])
    assert j["latency"]["windows"] == t["latency"]["windows"]
    assert j["traces"] == t["traces"]
    assert {k: v["windows"] for k, v in j["costs"]["families"].items()} == \
        {k: v["windows"] for k, v in t["costs"]["families"].items()}
    assert j["tenants"]["dispatches"] == t["tenants"]["dispatches"]
    # the cost records per cell, read off each package's session
    assert len(jt) == len(tt) == 1
    np.testing.assert_array_equal(
        np.trim_zeros(jt[0].costs._records, "b"),
        np.trim_zeros(tt[0].costs._records, "b"))
    assert [e["kind"] for e in jt[0].events.list()] == \
        [e["kind"] for e in tt[0].events.list()]
    # one trace per emitted window, the same stages in both
    jtr = json.load(open(tmp_path / "jtr" / "trace.json"))
    ttr = json.load(open(tmp_path / "ttr" / "trace.json"))
    assert sorted((e["name"], e["args"].get("trace_id")) for e in
                  jtr["traceEvents"] if e["ph"] != "M") == \
        sorted((e["name"], e["args"].get("trace_id")) for e in
               ttr["traceEvents"] if e["ph"] != "M")
    # Prometheus text: the same metric families and label sets
    prom = [open(tmp_path / d / "metrics.prom").read() for d in ("jt", "tt")]
    assert [line.rsplit(" ", 1)[0] for line in prom[0].splitlines()
            if "rate" not in line] == \
        [line.rsplit(" ", 1)[0] for line in prom[1].splitlines()
         if "rate" not in line]
    # --metrics: one sorted-JSON object at the end of stderr
    last = json.loads(t_err.strip().splitlines()[-1])
    assert set(last) == {"metrics", "degradation"}


def test_live_stats_and_profile_run_on_the_cpu(tmp_path):
    """``--live-stats`` prints the digest line (device cpu, the JAX
    schema's fields) and ``--profile`` writes a Chrome trace with the
    operator's dispatch and readback ranges; stdout is the plain run's."""
    argv, _ = _case(tmp_path, 1, [])
    rc, out, err = _run(TD.main, argv + [
        "--device", "cpu", "--live-stats", "--telemetry-interval", "1000"],
        TM)
    assert rc == 0
    lines = [x for x in err.splitlines() if x.startswith("# live: ")]
    assert len(lines) >= 2 and "dev cpu!=gpu" in lines[-1]
    assert "win 13" in lines[-1]
    rc, out2, _ = _run(TD.main, argv + [
        "--device", "cpu", "--profile", str(tmp_path / "prof")], TM)
    assert rc == 0 and out2 == out
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "PointPointRangeQuery.dispatch" in names
    assert "PointPointRangeQuery.readback" in names
