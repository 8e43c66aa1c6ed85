"""The port's recompile sentinel, flight recorder and doctor against the
JAX package's, and the gating of the session.

- The sentinel: on a steady run (every window in one padding bucket) both
  packages count 0 compiles after warmup; on a run whose windows outgrow
  their bucket after warmup both count the same number, and both exit 3
  under ``--strict-recompile`` with a ``strict-recompile`` post-mortem
  bundle.
- The doctor: ``summarize`` and ``diff`` of a JAX-written and a
  port-written bundle print the same text in both packages.
- Gating: a run without a session constructs no ``Telemetry`` and calls
  no memory probe; the sentinel's registry still counts.
"""

import contextlib
import io
import os

import numpy as np
import pytest
import torch

from spatialflink_tpu import doctor as JDoc
from spatialflink_tpu import driver as JD
from spatialflink_tpu.utils import deviceplane as JDP
from spatialflink_tpu.utils import metrics as JM

from spatialflink_tpu_torch import doctor as TDoc
from spatialflink_tpu_torch import driver as TD
from spatialflink_tpu_torch.utils import deviceplane as TDP
from spatialflink_tpu_torch.utils import metrics as TM
from spatialflink_tpu_torch.utils import telemetry as TT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "conf", "spatialflink-conf.yml")
T0 = 1_700_000_000_000

torch.set_num_threads(1)


def _csv(path, grow: bool, seed: int = 7):
    """A seeded CSV point stream over 60 s: 24 records every 5 s, or, with
    ``grow``, 24 over the first 20 s and then 400 every 5 s (windows of
    10 s past the 256-slot bucket after the first ones)."""
    rng = np.random.default_rng(seed)
    rows = []
    for s in range(0, 60, 5):
        n = 400 if (grow and s >= 20) else (6 if grow else 24)
        ts = T0 + s * 1000 + np.sort(rng.integers(0, 5000, n))
        x = rng.uniform(116.3, 116.7, n)
        y = rng.uniform(40.3, 40.7, n)
        for i in range(n):
            rows.append(f"o{rng.integers(0, 50)},{ts[i]},{x[i]:.6f},"
                        f"{y[i]:.6f}")
    path.write_text("\n".join(rows) + "\n")
    return str(path)


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


@pytest.fixture()
def cold():
    """Both packages start cold: a compile is once per process and
    signature (the JAX jit caches, the port registry's seen signatures),
    so an earlier test in this worker must not have warmed a bucket."""
    import jax

    jax.clear_caches()
    for entry in TDP.registry().entries.values():
        if entry.kind == "kernel":
            entry.seen.clear()


def _run(main, argv, reg_mod):
    out, err = io.StringIO(), io.StringIO()
    with reg_mod.scoped_registry() as reg, \
            contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue(), reg.snapshot()


def _argv(path, opt, *extra):
    return ["--config", CONF, "--option", str(opt), "--input1", path,
            "--format", "CSV", *extra]


@pytest.mark.parametrize("opt", [1, 51])
@pytest.mark.parametrize("grow", [False, True])
def test_recompile_counts_match_jax(tmp_path, cold, opt, grow):
    path = _csv(tmp_path / "in.csv", grow)
    argv = _argv(path, opt, "--sentinel-warmup", "1")
    rc, j_out, _, j_reg = _run(JD.main, argv, JM)
    assert rc == 0
    j_post = JDP.registry().run_recompiles
    rc, t_out, _, t_reg = _run(TD.main, argv + ["--device", "cpu"], TM)
    assert rc == 0 and t_out == j_out
    t_post = TDP.registry().run_recompiles
    assert t_post == j_post
    assert t_reg.get("device-recompiles", 0) == \
        j_reg.get("device-recompiles", 0) == t_post
    assert (t_post > 0) == grow


def test_strict_recompile_exits_3_in_both_with_a_bundle(tmp_path):
    path = _csv(tmp_path / "in.csv", grow=True)
    dirs = {}
    for name, main, reg_mod, extra in (
            ("jax", JD.main, JM, []), ("port", TD.main, TM, ["--device",
                                                            "cpu"])):
        cold.__wrapped__()
        pm = tmp_path / f"pm-{name}"
        rc, _, err, _ = _run(main, _argv(path, 1, "--strict-recompile",
                                         "--postmortem-dir", str(pm),
                                         *extra), reg_mod)
        assert rc == 3, err
        assert "# STRICT-RECOMPILE ABORT" in err
        bundles = sorted(os.listdir(pm))
        assert len(bundles) == 1 and bundles[0].endswith("strict-recompile")
        dirs[name] = str(pm / bundles[0])
    # each doctor reads each bundle, and both print the same lines
    for b in dirs.values():
        for cmd in ("summarize", "tenants"):
            outs = []
            for doc in (JDoc, TDoc):
                buf = io.StringIO()
                assert getattr(doc, cmd)(b, out=buf) == 0
                outs.append(buf.getvalue())
            assert outs[0] == outs[1] and outs[0]
    outs = []
    for doc in (JDoc, TDoc):
        buf = io.StringIO()
        assert doc.diff(dirs["jax"], dirs["port"], out=buf) == 0
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert "reason     strict-recompile" in outs[0] or \
        "strict-recompile" in outs[0]
    digest = TDoc._bundle_digest(TDoc.load_bundle(dirs["port"]))
    assert digest["backend"] == "cpu" and digest["post_warmup_compiles"] >= 1
    # the CLI of the port's doctor, with its JSON form
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert TDoc.main(["--json", "summarize", dirs["port"]]) == 0
        assert TDoc.main(["diff", dirs["jax"], dirs["port"]]) == 0
        assert TDoc.main(["fleet", str(tmp_path)]) == 2
    assert '"reason": "strict-recompile"' in buf.getvalue()


def test_no_session_builds_no_telemetry_and_probes_nothing(tmp_path,
                                                           monkeypatch):
    """Without a telemetry flag the run takes the plain loop: no Telemetry
    is constructed and no memory probe runs; stdout is the session run's."""
    path = _csv(tmp_path / "in.csv", grow=False)

    def boom(*_a, **_k):
        raise AssertionError("probed without a session")

    rc, with_session, _, _ = _run(TD.main, _argv(
        path, 51, "--device", "cpu", "--telemetry-dir",
        str(tmp_path / "t")), TM)
    assert rc == 0
    for name in ("device_memory", "memory_gauges", "status_block",
                 "backend_provenance"):
        monkeypatch.setattr(TDP, name, boom)
    monkeypatch.setattr(TT.Telemetry, "__init__", boom)
    for opt in (1, 51):
        rc, out, _, reg = _run(TD.main, _argv(path, opt, "--device", "cpu"),
                               TM)
        assert rc == 0 and out
        assert reg["batches-evaluated"] == 13
    assert out == with_session
    assert TT.active() is None


def test_sigusr1_dumps_a_bundle_the_doctor_reads(tmp_path):
    """The recorder's SIGUSR1 handler dumps a bundle mid-run without
    stopping it (sent here from the drive loop's first window)."""
    import signal

    path = _csv(tmp_path / "in.csv", grow=False)
    pm = tmp_path / "pm"
    fired = []
    orig = TD._emit

    def emit(result, sink):
        if not fired:
            fired.append(1)
            os.kill(os.getpid(), signal.SIGUSR1)
        orig(result, sink)

    import unittest.mock as mock

    before = signal.getsignal(signal.SIGUSR1)
    with mock.patch.object(TD, "_emit", emit):
        rc, out, _, _ = _run(TD.main, _argv(
            path, 1, "--device", "cpu", "--postmortem-dir", str(pm)), TM)
    assert rc == 0 and out.count("\n") == 13
    (bundle,) = os.listdir(pm)
    assert bundle.endswith("signal")
    buf = io.StringIO()
    assert TDoc.summarize(str(pm / bundle), out=buf) == 0
    assert "reason     signal" in buf.getvalue()
    # the recorder restored the handler it replaced
    assert signal.getsignal(signal.SIGUSR1) == before


def test_sigusr1_while_the_recorder_lock_is_held_does_not_hang(tmp_path):
    """SIGUSR1 that lands while the main thread holds the recorder's lock
    (the driver's ``note`` on every window) still writes its bundle: the
    handler hands the dump to a thread, so it never waits on a lock its
    own thread holds. Run in a fresh interpreter with a time limit, so a
    handler that dumps in place fails here rather than hanging."""
    import subprocess
    import sys
    import textwrap

    code = textwrap.dedent("""
        import os, signal, sys, time
        from spatialflink_tpu_torch.utils import deviceplane as DP
        rec = DP.FlightRecorder(sys.argv[1])
        rec.install_signal()
        with rec._lock:
            os.kill(os.getpid(), signal.SIGUSR1)
            for _ in range(10000):
                pass
            time.sleep(0.05)
        rec.note("after")
        rec.close()
        (b,) = os.listdir(sys.argv[1])
        assert os.path.exists(os.path.join(sys.argv[1], b, "manifest.json"))
        print("BUNDLE", b)
    """)
    pm = tmp_path / "pm"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, str(pm)], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.strip().endswith("signal")


@pytest.mark.parametrize("registers", [True, False])
def test_preflight_compile_probe_reads_the_registry(monkeypatch, registers):
    """``preflight``'s ``compile_probe`` passes only when loading K1's
    library put its entry in the compile registry."""
    import json

    from spatialflink_tpu_torch.ops import native

    reg = TDP.registry()
    # a cold registry of this test's own, restored afterwards
    for name, value in (("entries", {}), ("warm", False), ("strict", False),
                        ("total_compiles", 0), ("run_compiles", 0)):
        monkeypatch.setattr(reg, name, value)

    def load(name):
        if registers:
            reg.note_library(name)

    monkeypatch.setattr(native, "load", load)
    buf = io.StringIO()
    with TM.scoped_registry():
        TDoc.preflight(require_backend="cpu", as_json=True, out=buf)
    (probe,) = [c for c in json.loads(buf.getvalue())["checks"]
                if c["check"] == "compile_probe"]
    assert probe["ok"] is registers
    assert probe["detail"].endswith("registered by this load" if registers
                                    else "the registry did not see it")
