"""The PyTorch port stands alone: it loads neither JAX nor the JAX package,
imports neither anywhere in its source, chip_smoke.py or kernel_ab.py, and
never runs on the CPU unless the caller asks for it."""

import ast
import glob
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from spatialflink_tpu_torch import driver as TD
from spatialflink_tpu_torch.apps import CheckIn, StayTime
from spatialflink_tpu_torch.config import Params
from spatialflink_tpu_torch.device import resolve_device
from spatialflink_tpu_torch.index import UniformGrid
from spatialflink_tpu_torch.models import from_jax_arrays
from spatialflink_tpu_torch.operators import (GeomGeomJoinQuery,
                                              PointGeomJoinQuery,
                                              PointGeomKNNQuery,
                                              PointGeomRangeQuery,
                                              PointPointJoinQuery,
                                              PointPointKNNQuery,
                                              PointPointRangeQuery,
                                              PointPointTJoinQuery,
                                              PointPointTKNNQuery,
                                              PointPolygonTRangeQuery,
                                              PointTAggregateQuery,
                                              PointTFilterQuery,
                                              PointTStatsQuery,
                                              QueryConfiguration)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "conf", "spatialflink-conf.yml")

# pytest workers import every test module: one intra-op thread keeps this
# file's small CPU tensors from competing with the timed tests that
# other workers run at the same time
torch.set_num_threads(1)


def _forbidden(mod: str) -> bool:
    return any(mod == p or mod.startswith(p + ".")
               for p in ("jax", "spatialflink_tpu"))


def test_port_loads_no_jax():
    """In a fresh interpreter (PYTHONPATH unset: the test process already
    holds jax), import the port and run one tiny option-6 window, option
    51 with panes under the device merge, option 1 from a live query
    registry, one option-101 join window, the trajectory options 206
    and 99, the stay-time app 1010, the ser/de option 406, option 1 by
    bulk replay with panes and 101 with panes."""
    code = textwrap.dedent("""
        import dataclasses, sys
        from spatialflink_tpu_torch.config import Params
        from spatialflink_tpu_torch.driver import run_option
        p = Params.from_yaml(sys.argv[1])
        p.query.option = 6
        p = dataclasses.replace(
            p, input1=dataclasses.replace(p.input1, format="CSV"))
        lines = [f"o{i},{1700000000000 + 7 * i},{116.2 + i * 1e-3},40.5"
                 for i in range(500)]
        wins = list(run_option(p, lines, device="cpu"))
        assert wins and any(len(w.records) for w in wins), wins
        p.query.option = 51
        p.query.panes, p.query.pane_device_merge = True, True
        wins = list(run_option(p, lines, device="cpu"))
        assert wins and any(len(w.records) for w in wins), wins
        p.query.panes = False
        from spatialflink_tpu_torch.runtime.queryplane import QueryRegistry
        p.query.option = 1
        reg = QueryRegistry("range", radius=p.query.radius)
        reg.admit({"id": "a", "x": 116.4, "y": 40.5})
        reg.apply()
        p.query_registry = reg
        wins = list(run_option(p, lines, device="cpu"))
        assert wins and wins[0].extras["query_ids"] == ["a"], wins
        assert any(len(w.records[0]) for w in wins), wins
        del p.query_registry
        p.query.option = 101
        p = dataclasses.replace(
            p, input2=dataclasses.replace(p.input2, format="CSV"))
        wins = list(run_option(p, lines, lines[::7], device="cpu"))
        assert wins and any(len(w.records) for w in wins), wins
        tlines = [f"t{i % 50},{1700000000000 + 7 * i},{116.2 + i * 1e-3},"
                  "40.5" for i in range(500)]
        for option in (206, 99, 1010):
            p.query.option = option
            wins = list(run_option(p, tlines, device="cpu"))
            assert wins and any(len(w.records) for w in wins), wins
        p.query.option = 406
        assert len(list(run_option(p, lines[:5], device="cpu"))) == 5
        import os, tempfile
        from spatialflink_tpu_torch.driver import run_option_bulk
        with tempfile.TemporaryDirectory() as d:
            path = os.path.join(d, "in.csv")
            open(path, "w").write("\\n".join(lines) + "\\n")
            p.query.option, p.query.panes = 1, True
            wins = list(run_option_bulk(p, path, device="cpu"))
            assert wins and any(len(w.records) for w in wins), wins
            p.query.option, p.query.panes = 101, True
            wins = list(run_option(p, lines, lines[::7], device="cpu"))
            assert wins and any(len(w.records) for w in wins), wins
        bad = sorted(m for m in sys.modules
                     if m in ("jax", "spatialflink_tpu")
                     or m.startswith(("jax.", "spatialflink_tpu.")))
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, CONF], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout


def test_telemetry_and_doctor_load_no_jax(tmp_path):
    """In a fresh interpreter: option 51 through the port's CLI with every
    telemetry flag of its slice (a session, traces, a SIGUSR1 bundle
    through the flight recorder, --live-stats, --metrics), then
    ``python -m spatialflink_tpu_torch.doctor`` summarizing and diffing
    the bundle; neither loads jax or the JAX package."""
    inp = tmp_path / "in.csv"
    inp.write_text("\n".join(
        f"o{i % 40},{1700000000000 + 37 * i},{116.2 + i * 1e-3},40.5"
        for i in range(800)) + "\n")
    code = textwrap.dedent("""
        import os, signal, sys
        from spatialflink_tpu_torch import driver as TD
        d = sys.argv[2]
        orig = TD._emit
        def emit(result, sink, fired=[]):
            if not fired:
                fired.append(1)
                os.kill(os.getpid(), signal.SIGUSR1)
            orig(result, sink)
        TD._emit = emit
        rc = TD.main(["--config", sys.argv[1], "--option", "51",
                      "--input1", sys.argv[3], "--format", "CSV",
                      "--device", "cpu", "--telemetry-dir", d + "/t",
                      "--trace-dir", d + "/tr", "--postmortem-dir", d + "/pm",
                      "--live-stats", "--metrics", "--strict-recompile",
                      "--sentinel-warmup", "3"])
        assert rc == 0, rc
        bad = sorted(m for m in sys.modules
                     if m in ("jax", "spatialflink_tpu")
                     or m.startswith(("jax.", "spatialflink_tpu.")))
        print("LOADED", bad)
        sys.exit(1 if bad else 0)
    """)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, CONF,
                           str(tmp_path), str(inp)], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "LOADED []" in proc.stdout
    assert "# live: " in proc.stderr
    (bundle,) = os.listdir(tmp_path / "pm")
    bundle = str(tmp_path / "pm" / bundle)
    doc = textwrap.dedent("""
        import sys
        from spatialflink_tpu_torch import doctor
        b = sys.argv[1]
        for args in (["summarize", b], ["diff", b, b], ["tenants", b]):
            assert doctor.main(args) == 0
        bad = sorted(m for m in sys.modules
                     if m in ("jax", "spatialflink_tpu")
                     or m.startswith(("jax.", "spatialflink_tpu.")))
        print("LOADED", bad)
    """)
    proc = subprocess.run([sys.executable, "-c", doc, bundle], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert "reason     signal" in proc.stdout and "LOADED []" in proc.stdout
    proc = subprocess.run([sys.executable, "-m",
                           "spatialflink_tpu_torch.doctor", "summarize",
                           bundle], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0 and "reason     signal" in proc.stdout


def _imported_modules(path: str):
    """Every module an import statement (or a constant-string
    importlib.import_module / __import__ call) in ``path`` names, with
    relative imports resolved against the file's package."""
    rel = os.path.relpath(path, REPO)
    pkg = rel[:-3].replace(os.sep, ".").split(".")[:-1]
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = pkg[:len(pkg) - node.level + 1]
                mod = ".".join(base + ([node.module] if node.module else []))
            else:
                mod = node.module or ""
            yield mod
            for a in node.names:
                yield f"{mod}.{a.name}"
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and ((isinstance(node.func, ast.Name)
                    and node.func.id == "__import__")
                   or (isinstance(node.func, ast.Attribute)
                       and node.func.attr == "import_module"))):
            yield node.args[0].value


def test_no_source_imports_jax_or_the_jax_package():
    files = sorted(glob.glob(os.path.join(REPO, "spatialflink_tpu_torch",
                                          "**", "*.py"), recursive=True))
    files += [os.path.join(REPO, name)
              for name in ("kernel_ab.py", "chip_smoke.py")]
    assert len(files) > 20
    rel = {os.path.relpath(f, REPO) for f in files}
    for module in ("apps/__init__.py", "apps/stay_time.py",
                   "apps/check_in.py", "streams/shapefile.py",
                   "streams/bulk.py", "native/__init__.py",
                   "streams/kafka.py", "runtime/checkpoint.py",
                   "runtime/state.py", "utils/metrics.py",
                   "utils/telemetry.py", "utils/deviceplane.py",
                   "utils/latencyplane.py", "utils/accounting.py",
                   "runtime/opserver.py", "doctor.py"):
        assert os.path.join("spatialflink_tpu_torch", module) in rel
    bad = [(os.path.relpath(f, REPO), m) for f in files
           for m in _imported_modules(f) if _forbidden(m)]
    assert bad == []
    # the scan does see imports (a broken walker would pass vacuously)
    assert "torch" in set(_imported_modules(files[-1]))


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_raises_without_cuda(no_cuda, tmp_path, capsys):
    grid = UniformGrid(0.0, 1.0, 0.0, 1.0, num_grid_partitions=4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    for cls in (PointPointRangeQuery, PointGeomRangeQuery,
                PointPointKNNQuery, PointGeomKNNQuery, PointPointJoinQuery,
                PointGeomJoinQuery, GeomGeomJoinQuery, PointTFilterQuery,
                PointPolygonTRangeQuery, PointTStatsQuery,
                PointTAggregateQuery, PointPointTJoinQuery,
                PointPointTKNNQuery, StayTime, CheckIn):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(QueryConfiguration(), grid)
    p = Params.from_yaml(CONF)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.run_option(p, [])
    p.query.option = 101
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.run_option(p, [], [])
    fields = {k: np.zeros(4, np.float32) for k in
              ("x", "y", "obj_id", "ts", "cell", "valid")}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        from_jax_arrays(fields, "cuda")
    inp = tmp_path / "in.csv"
    inp.write_text("o1,1700000000000,116.5,40.5\n")
    assert TD.main(["--config", CONF, "--input1", str(inp), "--format",
                    "CSV"]) != 0
    assert "no CUDA device" in capsys.readouterr().err
    # asked for explicitly, the CPU runs
    assert resolve_device("cpu").type == "cpu"
    PointPointRangeQuery(QueryConfiguration(), grid, device="cpu")


def test_chip_smoke_refuses_without_cuda():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
