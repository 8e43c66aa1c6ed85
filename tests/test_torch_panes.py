"""Pane-incremental sliding windows (``query.panes``) on the CPU: the
PyTorch port's run_option (device="cpu") against
spatialflink_tpu.driver.run_option with panes, window for window and in
order, and against the port's own full-window run.

``PaneBuffer`` is held to the JAX package's (its per-record ``add``, the
path of the JAX geometry streams) under jitter and lateness: the same
windows, panes, records and late drops, each record buffered once. Range
1/6/11 and kNN 51/56/61 over the point stream of
tests/test_torch_realtime.py (conf windows: 10 s / 5 s, two panes a
window; one case at 10 s / 2 s, five), kNN under the host merge and the
device merge (on the CPU the device merge runs K3's plain version, once
per window), multiQuery 1/51, ties at the k-th place across panes and one
object in two panes at different distances, the latency variants 8/58,
the CLI's stdout byte for byte, the pruning counters, and the bypass of
tumbling and non-decomposable windows. Range windows equal the
full-window run as sets (pane order differs from arrival order once
records arrive late); kNN lists are identical. The polygon and
linestring options are in tests/test_torch_panes_geom.py.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from spatialflink_tpu import driver as JD
from spatialflink_tpu.config import Params as JParams
from spatialflink_tpu.runtime.windows import PaneBuffer as JPaneBuffer
from spatialflink_tpu.runtime.windows import WindowSpec as JWindowSpec
from spatialflink_tpu.utils.metrics import REGISTRY

from spatialflink_tpu_torch import driver as TD
from spatialflink_tpu_torch import operators as TO
from spatialflink_tpu_torch.config import Params as TParams
from spatialflink_tpu_torch.index import UniformGrid
from spatialflink_tpu_torch.ops import knn as K
from spatialflink_tpu_torch.runtime import (PaneBuffer, WindowAssembler,
                                            WindowSpec)
from spatialflink_tpu_torch.streams.bulk import PointChunk, ParsedPoints
from spatialflink_tpu_torch.utils import IdInterner

import test_torch_geom_stream as GS
import test_torch_realtime as RT

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "conf", "spatialflink-conf.yml")
T0 = 1_700_000_000_000

torch.set_num_threads(1)

POINT_RANGE, POINT_KNN = [1, 6, 11], [51, 56, 61]


# ------------------------------------------------------------------------ #
# PaneBuffer


def _chunks(ts, size):
    grid = UniformGrid(0.0, 1.0, 0.0, 1.0, num_grid_partitions=4)
    interner = IdInterner()
    out = []
    for lo in range(0, len(ts), size):
        t = ts[lo:lo + size]
        n = len(t)
        oid = np.arange(lo, lo + n, dtype=np.int32)  # the record's index
        out.append(PointChunk.build(ParsedPoints(
            x=np.full(n, 0.5), y=np.full(n, 0.5), ts=t.astype(np.int64),
            obj_id=oid, interner=interner), grid))
    return out


def _pane_table(windows):
    """[(start, end, [(pane, sorted record indices)])] of port windows."""
    return [(s, e, [(p, sorted(recs.columns()[3].tolist()))
                    for p, recs in panes]) for s, e, panes in windows]


@pytest.mark.parametrize("chunk", [7, 37, 500])
@pytest.mark.parametrize("lateness", [0, 700])
@pytest.mark.parametrize("slide", [1000, 2500])
def test_pane_buffer_matches_jax(chunk, lateness, slide):
    rng = np.random.default_rng(chunk + lateness)
    n = 3000
    ts = T0 + np.sort(rng.integers(0, 30_000, n))
    back = rng.random(n) < 0.05  # jitter; some beyond the lateness
    ts[back] -= rng.integers(100, 4_000, int(back.sum()))
    spec = WindowSpec(10_000, slide)
    pb = PaneBuffer(spec, lateness)
    got = _pane_table(pb.assemble(_chunks(ts, chunk)))
    jpb = JPaneBuffer(JWindowSpec(10_000, slide), lateness)
    want = []
    for i, t in enumerate(ts.tolist()):
        want += [(s, e, [(p, sorted(r)) for p, r in panes])
                 for s, e, panes in jpb.add(t, i)]
    want += [(s, e, [(p, sorted(r)) for p, r in panes])
             for s, e, panes in jpb.flush()]
    assert got == want and len(got) >= 5
    assert pb.late_dropped == jpb.late_dropped > 0
    # each record buffered once: a pane holds the same records in every
    # window, and the panes partition the kept records
    panes = {}
    for _, _, ps in got:
        for p, recs in ps:
            assert panes.setdefault(p, recs) == recs
    kept = sorted(i for recs in panes.values() for i in recs)
    assert len(kept) == len(set(kept)) == n - pb.late_dropped
    # the window set and contents of the full-window assembler
    wa = WindowAssembler(spec, lateness)
    full = [(s, e, sorted(r.columns()[3].tolist()))
            for s, e, r in wa.assemble(_chunks(ts, chunk))]
    assert [(s, e, sorted(i for _, r in ps for i in r))
            for s, e, ps in got] == full


def test_pane_buffer_refuses_what_does_not_decompose():
    for size, slide in ((10_000, 10_000), (10_000, 3_000)):
        with pytest.raises(ValueError, match="slide \\| size"):
            PaneBuffer(WindowSpec(size, slide))
    assert WindowSpec(10_000, 2_000).pane_starts(4_000) == [
        4_000, 6_000, 8_000, 10_000, 12_000]
    assert WindowSpec(10_000, 2_000).pane_of(7_999) == 6_000


# ------------------------------------------------------------------------ #
# options through run_option


def _with(p, *, panes=True, merge=None, slide_s=None, interval_s=None,
          k=None):
    p.query.panes = panes
    p.query.pane_device_merge = merge
    if k is not None:
        p.query.k = k
    if slide_s is not None or interval_s is not None:
        p = dataclasses.replace(p, window=dataclasses.replace(
            p.window, step_s=slide_s or p.window.step_s,
            interval_s=interval_s or p.window.interval_s))
    return p


class _Ops:
    """Records the operators run_option builds (their counters and pane
    caches)."""

    def __init__(self, monkeypatch):
        self.ops = []
        for name in dir(TO):
            if name.endswith(("RangeQuery", "KNNQuery")):
                monkeypatch.setattr(TO, name, self._wrap(getattr(TO, name)))

    def _wrap(self, base):
        rec = self

        class Op(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                rec.ops.append(self)
        return Op


def _windows(module, results):
    """(start, end, extras, per-query record lists) of one run."""
    return [(s, e, x, r if module is GS or "queries" in x else [r])
            for s, e, x, r in module._windows(results)]


def _run(module, option, lines, *, multi=False, **kw):
    """(JAX windows, JAX counter deltas) of one option."""
    names = ("gn-bypassed", "distance-computations")
    before = [REGISTRY.counter(c).count for c in names]
    want = _windows(module, JD.run_option(
        _with(module._params(JParams, option, multi=multi), **kw),
        iter(lines)))
    after = [REGISTRY.counter(c).count for c in names]
    return want, [a - b for a, b in zip(after, before)]


def _port(monkeypatch, module, option, lines, *, multi=False, **kw):
    """(port windows, port counters, the port's operator) of one option."""
    rec = _Ops(monkeypatch)
    got = _windows(module, TD.run_option(
        _with(module._params(TParams, option, multi=multi), **kw),
        iter(lines), device="cpu"))
    (op,) = rec.ops
    return got, [op.pruning[c] for c in ("gn-bypassed",
                                         "distance-computations")], op


def _assert_knn_equal(got, want):
    assert [w[:3] for w in got] == [w[:3] for w in want]
    assert sum(len(r) for w in want for r in w[3]) > 0
    for g, w in zip(got, want):
        assert len(g[3]) == len(w[3])
        for rg, rw in zip(g[3], w[3]):
            assert [o for o, _ in rg] == [o for o, _ in rw]
            np.testing.assert_allclose([d for _, d in rg],
                                       [d for _, d in rw], rtol=1e-6, atol=0)


def _as_sets(windows):
    return [(w[0], w[1], [sorted(map(repr, q)) for q in w[3]])
            for w in windows]


def _check(monkeypatch, module, option, lines, *, multi=False, **kw):
    """The port with panes equals the JAX package with panes (windows in
    order, counters) under the host merge and, for kNN, the device merge,
    and the port's full-window run (range as sets, kNN identical); the
    device merge runs K3's plain version once per window, the host merge
    never."""
    calls = []
    plain = K.merge_topk_stacked_plain
    monkeypatch.setattr(K, "merge_topk_stacked_plain",
                        lambda *a: calls.append(1) or plain(*a))
    want, jcounts = _run(module, option, lines, multi=multi, **kw)
    assert len(want) >= 4
    full, _, _ = _port(monkeypatch, module, option, lines, multi=multi,
                       panes=False, **kw)
    for merge in ((False, True) if option > 50 else (None,)):
        del calls[:]
        got, counts, op = _port(monkeypatch, module, option, lines,
                                multi=multi, merge=merge, **kw)
        if option > 50:
            _assert_knn_equal(got, want)
            _assert_knn_equal(got, full)
            assert len(calls) == (len(got) if merge else 0)
        else:
            assert got == want
            assert sum(len(q) for w in got for q in w[3]) > 0
            assert _as_sets(got) == _as_sets(full)
        assert counts == jcounts and counts[1] > 0
        cache = op.pane_cache
        assert cache is not None and cache.hits > 0 and cache.misses > 0


@pytest.mark.parametrize("option", POINT_RANGE + POINT_KNN)
def test_point_options_with_panes_match_jax(monkeypatch, option):
    _check(monkeypatch, RT, option, RT.LINES)


@pytest.mark.parametrize("option", [1, 51])
def test_multi_query_with_panes_matches_jax(monkeypatch, option):
    _check(monkeypatch, RT, option, RT.LINES, multi=True)


@pytest.mark.parametrize("option", [1, 51])
def test_five_panes_a_window_match_jax(monkeypatch, option):
    """10 s windows every 2 s: five panes a window, each shared by five
    windows."""
    _check(monkeypatch, RT, option, RT.LINES, slide_s=2, k=20)


def _tie_lines():
    """A stream whose objects tie across panes: per 5 s pane, the same
    distances to the query point (116.5, 40.5) recur under other ids, and
    object o7 sits in two panes at two distances."""
    rows = []
    ring = [(116.5 + 0.01 * c, 40.5) for c in range(1, 6)]
    for pane in range(6):
        t = T0 + pane * 5_000
        for j in range(12):
            x, y = ring[j % 5]
            rows.append(f"o{(pane * 12 + j) % 23},{t + 100 * j},{x!r},{y!r}")
        d = 0.003 if pane == 2 else 0.04
        rows.append(f"o7,{t + 1_300},{116.5 + d!r},40.5")
    return rows


@pytest.mark.parametrize("merge", [False, True])
def test_ties_across_panes(monkeypatch, merge):
    lines = _tie_lines()
    want, jcounts = _run(RT, 51, lines, merge=merge, k=4)
    got, counts, _ = _port(monkeypatch, RT, 51, lines, merge=merge, k=4)
    full, _, _ = _port(monkeypatch, RT, 51, lines, panes=False, k=4)
    _assert_knn_equal(got, want)
    _assert_knn_equal(got, full)
    assert counts == jcounts
    # the k-th place is a tie between ids, and o7 keeps its minimum
    lists = [w[3][0] for w in got if w[3][0]]
    assert any(len({d for _, d in lst}) < len(lst) for lst in lists)
    assert any(o == "o7" and abs(d - 0.003) < 1e-5
               for lst in lists for o, d in lst)


@pytest.mark.parametrize("option", [8, 58])
def test_latency_variants_with_panes(option):
    """A range window merged from panes is one record view: its latency
    list has the JAX package's length (one entry per selected record)."""
    want = list(JD.run_option(_with(RT._params(JParams, option)),
                              iter(RT.LINES)))
    got = list(TD.run_option(_with(RT._params(TParams, option)),
                             iter(RT.LINES), device="cpu"))
    assert [(w.window_start, len(w.records)) for w in got] == \
        [(w.window_start, len(w.records)) for w in want]
    assert [len(w.extras["latency_ms"]) for w in got] == \
        [len(w.extras["latency_ms"]) for w in want]
    assert all(v >= 0 for w in got for v in w.extras["latency_ms"])
    if option == 8:
        assert sum(len(w.extras["latency_ms"]) for w in got) > 0


@pytest.mark.parametrize("interval_s,slide_s", [(5, 5), (10, 3)])
@pytest.mark.parametrize("option", [1, 51])
def test_tumbling_and_undecomposable_bypass_panes(monkeypatch, option,
                                                  interval_s, slide_s):
    got, counts, op = _port(monkeypatch, RT, option, RT.LINES,
                            interval_s=interval_s, slide_s=slide_s)
    full, fcounts, _ = _port(monkeypatch, RT, option, RT.LINES, panes=False,
                             interval_s=interval_s, slide_s=slide_s)
    assert op.pane_cache is None
    assert got == full and counts == fcounts and len(got) >= 4


def test_realtime_and_count_windows_bypass_panes(monkeypatch):
    for option, count in ((2, False), (51, True)):
        rec = _Ops(monkeypatch)
        p = _with(RT._params(TParams, option, count=count))
        out = list(TD.run_option(p, iter(RT.LINES), device="cpu"))
        assert out and rec.ops[-1].pane_cache is None


def test_cli_panes_stdout_matches_jax(tmp_path, capsys):
    inp = tmp_path / "in.csv"
    inp.write_text("\n".join(RT.LINES) + "\n")
    args = ["--config", CONF, "--option", "51", "--input1", str(inp),
            "--format", "CSV", "--panes", "--pane-merge", "device"]
    assert JD.main(args) == 0
    want = capsys.readouterr().out
    assert TD.main(args + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == want and want.count("'k': 10") >= 5
