"""The PyTorch port stands alone: it loads neither JAX nor the JAX package,
imports neither anywhere in its source or in chip_smoke.py, and never runs
on the CPU unless the caller asks for it."""

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
from spatialflink_tpu_torch.config import Params
from spatialflink_tpu_torch.device import resolve_device
from spatialflink_tpu_torch.index import UniformGrid
from spatialflink_tpu_torch.models import from_jax_arrays
from spatialflink_tpu_torch.operators import (PointGeomRangeQuery,
                                              PointPointRangeQuery,
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
    holds jax), import the port and run one tiny option-6 window."""
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
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 20
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
    for cls in (PointPointRangeQuery, PointGeomRangeQuery):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(QueryConfiguration(), grid)
    p = Params.from_yaml(CONF)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TD.run_option(p, [])
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
