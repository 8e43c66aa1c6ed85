"""The operations plane through ``driver.main`` on the CPU, against the JAX
driver.

- Options 1 and 51 with ``--queries-file``, ``--status-port 0`` and
  ``--tenant-quota``: the input iterator is gated, so each POST / DELETE
  reaches the server, and its reply comes back, before the reader takes
  the next record; both packages decode the same chunks lazily and apply
  the fleet once per window, so every admission lands in the same window.
  stdout is byte for byte the JAX driver's, and so is every reply (clocks
  aside): 200 admissions and drains, 400 for a bad spec, 404 for an
  unknown id, 429 ``quota-exceeded``.
- Option 6 with ``--slo``, ``--controller``, ``--status-port`` and
  ``--strict-recompile`` under a telemetry session: stdout equal to the
  run without the flags, the snapshots' keys, health verdicts and
  controller stanza equal to the JAX driver's, no recompile after the
  warmup.
- The flags' malformed specs and the quota refusal of a seeded fleet give
  the JAX driver's errors; the warnings for ``--slo`` and ``--controller``
  without a consumer are the JAX driver's.
"""

import contextlib
import io
import json
import os

import pytest
import torch

from spatialflink_tpu import driver as JD
from spatialflink_tpu.runtime import opserver as JO
from spatialflink_tpu.streams import sources as JS
from spatialflink_tpu.utils import metrics as JM
from spatialflink_tpu.utils.accounting import QuotaExceeded as JQuota

from spatialflink_tpu_torch import driver as TD
from spatialflink_tpu_torch.runtime import opserver as TO
from spatialflink_tpu_torch.utils import metrics as TM
from spatialflink_tpu_torch.utils.accounting import QuotaExceeded

import test_torch_realtime as RT
from test_torch_opserver import _isolated, request, strip  # noqa: F401
from test_torch_telemetry_driver import _cold, _keys, _snapshots  # noqa

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "conf", "spatialflink-conf.yml")

torch.set_num_threads(1)

SEEDS = [{"id": "north", "x": 116.5, "y": 40.5},
         {"id": "ring", "x": 116.9, "y": 40.1, "tenant": "acme"}]
#: record index -> the requests made before the reader takes that record
SCRIPT = {
    900: [("POST", "/queries", {"id": "west", "x": 116.0, "y": 40.8}),
          ("POST", "/queries", {"id": "bad", "x": "wat", "y": 1})],
    1700: [("POST", "/queries", {"id": "east", "x": 117.2, "y": 40.4,
                                 "tenant": "acme",
                                 "latency_class": "interactive"}),
           ("POST", "/queries", {"id": "east2", "x": 117.0, "y": 40.4,
                                 "tenant": "acme"}),
           ("GET", "/queries/east", None)],
    2600: [("DELETE", "/queries/north", None),
           ("DELETE", "/queries/ghost", None),
           ("POST", "/queries", {"id": "west", "x": 116.1, "y": 40.7})],
    3500: [("GET", "/queries", None), ("GET", "/healthz", None)],
}


def _gated(lines, server, replies):
    """``lines`` with SCRIPT's requests made, and answered, before the
    reader takes the scripted records."""
    for i, line in enumerate(lines):
        for method, path, body in SCRIPT.get(i, ()):
            code, payload, _ = request(server().url + path, method, body)
            replies.append((i, method, path, code, strip(payload)))
        yield line


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


@pytest.fixture
def gated(monkeypatch):
    """Both drivers' file readers gated by SCRIPT; the replies per
    package."""
    replies = {"jax": [], "port": []}
    orig_iter = JS.FileReplaySource.__iter__

    def jax_iter(self):
        return _gated(orig_iter(self), JO.active_server, replies["jax"])

    monkeypatch.setattr(JS.FileReplaySource, "__iter__", jax_iter)
    orig_lines = TD.file_lines
    monkeypatch.setattr(TD, "file_lines", lambda path: _gated(
        orig_lines(path), TO.active_server, replies["port"]))
    # chunks of 512 records: the 4,096-record stream spans 8 decode
    # chunks, so the scripted changes land in different windows
    monkeypatch.setenv("SPATIALFLINK_DECODE_CHUNK", "512")
    return replies


@pytest.mark.parametrize("option", [1, 51])
def test_http_admissions_match_jax(tmp_path, gated, option):
    inp = tmp_path / "in.csv"
    inp.write_text("\n".join(RT.LINES) + "\n")
    qf = tmp_path / "q.json"
    qf.write_text(json.dumps(SEEDS))
    argv = ["--config", CONF, "--option", str(option), "--input1", str(inp),
            "--format", "CSV", "--queries-file", str(qf), "--status-port",
            "0", "--tenant-quota", "acme:2", "--latency-class", "batch",
            "--tenant-default", "house"]
    with JM.scoped_registry():
        jrc, want, jerr = _run(JD.main, argv)
    with TM.scoped_registry():
        rc, got, err = _run(TD.main, argv + ["--device", "cpu"])
    assert (rc, jrc) == (0, 0)
    assert got == want
    assert gated["port"] == gated["jax"]
    codes = [r[3] for r in gated["jax"]]
    assert codes == [200, 400, 200, 429, 200, 200, 404, 200, 200, 200]
    ids = [eval(ln)["query_ids"] for ln in want.splitlines()]
    assert ids[0][:2] == ["north", "ring"] and "east" in ids[-1]
    assert "north" not in ids[-1] and len({tuple(x) for x in ids}) >= 3
    assert "# status server: http://127.0.0.1:" in err
    assert TO.active_server() is None and JO.active_server() is None


def _ops_flags(tmp_path, side):
    # the JAX driver's XLA compiles a new batch bucket after its warmup,
    # so --strict-recompile (and a recompiles check) holds the port only
    strict = ["--strict-recompile"] if side == "port" else []
    return ["--slo", "window_backlog=64,p99_window_ms=60000",
            "--controller", "target_p99_ms=500,min_chunk=512",
            "--status-port", "0", *strict,
            "--telemetry-dir", str(tmp_path / side / "tel"),
            "--telemetry-interval", "1000"]


def test_slo_and_controller_session_matches_jax(tmp_path):
    """Option 6 under a session with ``--slo`` and ``--controller``:
    stdout equals the run without them, the snapshots match the JAX
    driver's key for key with the same health verdicts and the governor's
    stanza (seeded, no tick inside the run's 5 s bucket), and nothing
    recompiles after the warmup."""
    inp = tmp_path / "in.csv"
    inp.write_text("\n".join(RT.LINES) + "\n")
    base = ["--config", CONF, "--option", "6", "--input1", str(inp),
            "--format", "CSV"]
    with TM.scoped_registry():
        rc0, plain, _ = _run(TD.main, base + ["--device", "cpu"])
    with JM.scoped_registry():
        jrc, want, jerr = _run(JD.main, base + _ops_flags(tmp_path, "jax"))
    with TM.scoped_registry():
        rc, got, err = _run(TD.main, base + _ops_flags(tmp_path, "port")
                            + ["--device", "cpu"])
    assert (rc0, rc, jrc) == (0, 0, 0)
    assert got == plain == want and plain.count("\n") >= 5
    snaps = _snapshots(tmp_path / "port" / "tel")
    jsnaps = _snapshots(tmp_path / "jax" / "tel")
    assert len(snaps) == len(jsnaps) == 2
    for s, j in zip(snaps, jsnaps):
        assert _keys(s) == _keys(j)
        assert strip(s["status"]["controller"]) == \
            strip(j["status"]["controller"])
        assert {k: (c["ok"], c["threshold"])
                for k, c in s["health"]["checks"].items()} == \
            {k: (c["ok"], c["threshold"])
             for k, c in j["health"]["checks"].items()}
    last = snaps[-1]
    assert last["health"]["healthy"]
    assert last["status"]["controller"]["chunk"] == 2048
    assert last["status"]["device"]["recompiles"] == 0
    assert "# controller: decode-chunk governor on (seed 2048" in err
    assert [ln for ln in err.splitlines() if ln.startswith("# contr")] \
        == [ln for ln in jerr.splitlines() if ln.startswith("# contr")]


def _error(main, argv):
    err = io.StringIO()
    with contextlib.redirect_stderr(err), contextlib.redirect_stdout(
            io.StringIO()), pytest.raises(SystemExit) as e:
        main(argv)
    return e.value.code, err.getvalue().strip().splitlines()[-1].split(
        "error: ", 1)[-1]


@pytest.mark.parametrize("flags", [
    ["--slo", "wobble=1"], ["--slo", "p99_window_ms"],
    ["--slo", "p99_window_ms=fast"], ["--slo", ""],
    ["--controller", "min_chunk=1000"], ["--controller", "nonsense=1"],
    ["--controller", "confirm_ticks=x"],
    ["--tenant-quota", "acme"], ["--tenant-quota", "acme:x"],
    ["--tenant-quota", "acme:1;acme:2"],
    ["--tenant-quota", "acme:1,burst=3"],
    ["--latency-class", "urgent"], ["--status-port", "eighty"],
])
def test_malformed_specs_match_jax(tmp_path, flags):
    inp = tmp_path / "in.csv"
    inp.write_text("\n".join(RT.LINES[:50]) + "\n")
    qf = tmp_path / "q.json"
    qf.write_text(json.dumps(SEEDS))
    argv = ["--config", CONF, "--option", "1", "--input1", str(inp),
            "--format", "CSV", "--queries-file", str(qf), *flags]
    got = _error(TD.main, argv + ["--device", "cpu"])
    want = _error(JD.main, argv)
    assert got == want and got[0] == 2


def test_seeded_fleet_over_quota_raises_as_jax(tmp_path):
    inp = tmp_path / "in.csv"
    inp.write_text("\n".join(RT.LINES[:50]) + "\n")
    qf = tmp_path / "q.json"
    qf.write_text(json.dumps(SEEDS + [{"id": "c", "x": 1, "y": 2,
                                       "tenant": "acme"}]))
    argv = ["--config", CONF, "--option", "1", "--input1", str(inp),
            "--format", "CSV", "--queries-file", str(qf),
            "--tenant-quota", "acme:1"]
    with pytest.raises(QuotaExceeded) as got, \
            contextlib.redirect_stderr(io.StringIO()):
        TD.main(argv + ["--device", "cpu"])
    with pytest.raises(JQuota) as want, \
            contextlib.redirect_stderr(io.StringIO()):
        JD.main(argv)
    assert str(got.value) == str(want.value)
    assert "max_active 1 reached" in str(got.value)


def test_warnings_without_a_consumer_match_jax(tmp_path):
    inp = tmp_path / "in.csv"
    inp.write_text("\n".join(RT.LINES[:200]) + "\n")
    argv = ["--config", CONF, "--option", "1", "--input1", str(inp),
            "--format", "CSV", "--slo", "window_backlog=3",
            "--controller"]
    with TM.scoped_registry():
        rc, got, err = _run(TD.main, argv + ["--device", "cpu"])
    with JM.scoped_registry():
        jrc, want, jerr = _run(JD.main, argv)
    assert (rc, jrc) == (0, 0) and got == want

    def warnings(text):
        return [ln for ln in text.splitlines() if ln.startswith("warning")]
    assert warnings(err) == warnings(jerr) and len(warnings(err)) == 2
