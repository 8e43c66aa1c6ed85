"""The pane join (``query.panes`` on options 101-142) on the CPU: the
PyTorch port's run_option (device="cpu") against spatialflink_tpu.driver,
window for window and pair for pair, with the block-coalescing threshold
pinned in both packages (0: every window by pane-pair blocks; 2**24:
every window coalesced into one lattice), and against the port's own
panes-off run as pair sets. The fixtures are test_torch_join's: late
records beyond the 1 s lateness and one-sided last windows (the query
stream ends at 13 s). Also the threshold itself, join_pairs_host with a
prebuilt join index, realtime joins ignoring panes, and the CLI's
``--panes`` on a join.
"""

import numpy as np
import pytest
import torch

from spatialflink_tpu import driver as JD
from spatialflink_tpu.config import Params as JParams
from spatialflink_tpu.ops import join as JJ

from spatialflink_tpu_torch import driver as TD
from spatialflink_tpu_torch.config import Params as TParams
from spatialflink_tpu_torch.models import PointBatch
from spatialflink_tpu_torch.ops import join as TJ

from test_torch_join import (CONF, KIND, QUERIES, RADIUS, STREAMS, _params,
                             _windows)

torch.set_num_threads(1)

ALL_BLOCKS, ALL_COALESCED = 0, 1 << 24


def _pinned(monkeypatch, cells):
    """Both packages' threshold pinned (the JAX one is cached per process
    on first use, so its cache is set; the port reads the variable at each
    call)."""
    monkeypatch.setattr(JJ, "_BLOCK_MIN_CELLS", cells)
    monkeypatch.setenv("SPATIALFLINK_JOIN_BLOCK_MIN_CELLS", str(cells))


def _run(option, panes, port=True):
    spec = TD.CASES[option]
    s1, s2 = STREAMS[spec.stream], QUERIES[spec.query]
    if not port:
        p = _params(JParams, option)
        p.query.panes = panes
        return _windows(JD.run_option(p, iter(s1), iter(s2)))
    p = _params(TParams, option)
    p.query.panes = panes
    return _windows(TD.run_option(p, iter(s1), iter(s2), device="cpu"))


def check_pane_join(monkeypatch, option, cells):
    """The JAX pane run's pair lists in order, and the panes-off run's pair
    sets."""
    _pinned(monkeypatch, cells)
    got = _run(option, True)
    want = _run(option, True, port=False)
    assert got == want
    off = _run(option, False)
    assert [w[:2] for w in got] == [w[:2] for w in off]
    assert [sorted(w[3]) for w in got] == [sorted(w[3]) for w in off]
    assert sum(len(w[3]) for w in got) > 0
    assert got[-1][3] == []  # the one-sided last window


@pytest.mark.parametrize("cells", [ALL_BLOCKS, ALL_COALESCED])
@pytest.mark.parametrize("option", [101])
def test_pane_join_matches_jax(monkeypatch, option, cells):
    """101 point x point (join index, K7 and K6 per block); 106 and 121
    in test_torch_join_panes_geom.py."""
    check_pane_join(monkeypatch, option, cells)


def test_blocks_differ_in_order_from_the_coalesced_window(monkeypatch):
    """Pair order follows the blocks (pane a, then pane b) when windows are
    not coalesced, and the panes' concatenation when they are; both the
    JAX package's orders, and the same sets."""
    orders = {}
    for cells in (ALL_BLOCKS, ALL_COALESCED):
        _pinned(monkeypatch, cells)
        orders[cells] = _run(101, True)
    a, b = orders[ALL_BLOCKS], orders[ALL_COALESCED]
    assert [sorted(w[3]) for w in a] == [sorted(w[3]) for w in b]
    assert any(wa[3] != wb[3] for wa, wb in zip(a, b))


def test_blocks_are_evaluated_once_and_shared(monkeypatch):
    """Each pane-pair block runs its kernels once: a window of two panes a
    side takes its older blocks from the cache, and coalescing counts
    every block of a coalesced window (a window with one pane a side is
    one block and never coalesced)."""
    spec = TD.CASES[101]
    counts = {}
    for cells in (ALL_BLOCKS, ALL_COALESCED):
        _pinned(monkeypatch, cells)
        p = _params(TParams, 101)
        p.query.panes = True
        u_grid, q_grid = p.grids()
        conf = TD._query_conf(p, spec)
        op = TD.ops.PointPointJoinQuery(conf, u_grid, q_grid, device="cpu")
        s1 = TD.ChunkedStream(TD.decode_chunks(iter(STREAMS["Point"]),
                                               p.input1, u_grid))
        s2 = TD.ChunkedStream(TD.decode_chunks(iter(QUERIES["Point"]),
                                               p.input2, q_grid))
        n = len(list(op.run(s1, s2, RADIUS)))
        counts[cells] = {"evaluated": op.pane_cache.misses,
                         "cached": op.pane_cache.hits,
                         "coalesced": op.blocks_coalesced, "windows": n}
    blocks, coalesced = counts[ALL_BLOCKS], counts[ALL_COALESCED]
    assert blocks["coalesced"] == 0 and blocks["cached"] > 0
    assert coalesced["evaluated"] < blocks["evaluated"]
    assert coalesced["coalesced"] > 0


def test_late_record_is_dropped_from_its_pane(monkeypatch):
    """A point later than the lateness, placed right on a query point, is
    dropped: it pairs in no window, with and without panes, and the pane
    run equals the JAX package's."""
    _pinned(monkeypatch, ALL_BLOCKS)
    q = QUERIES["Point"][0].split(",")
    late = f"late,{int(q[1]) - 5_000},{q[2]},{q[3]}"
    s1 = STREAMS["Point"][:400] + [late] + STREAMS["Point"][400:]
    got = {}
    for panes in (True, False):
        p = _params(TParams, 101)
        p.query.panes = panes
        got[panes] = _windows(TD.run_option(
            p, iter(s1), iter(QUERIES["Point"]), device="cpu"))
        assert all(a[1] != "late" for w in got[panes] for a, _ in w[3])
    p = _params(JParams, 101)
    p.query.panes = True
    assert got[True] == _windows(JD.run_option(p, iter(s1),
                                               iter(QUERIES["Point"])))


def test_realtime_join_ignores_panes():
    """A realtime join runs its cuts whatever query.panes says, as the JAX
    package's does."""
    p = _params(TParams, 102)
    want = _windows(TD.run_option(p, iter(STREAMS["Point"]),
                                  iter(QUERIES["Point"]), device="cpu"))
    p.query.panes = True
    got = _windows(TD.run_option(p, iter(STREAMS["Point"]),
                                 iter(QUERIES["Point"]), device="cpu"))
    assert got == want and got


def test_threshold_on_the_cpu_and_its_override(monkeypatch):
    """Calibrated on the plain K6 path: an int in [0, 2**24], cached per
    device; the variable wins at every call."""
    monkeypatch.delenv("SPATIALFLINK_JOIN_BLOCK_MIN_CELLS", raising=False)
    monkeypatch.setattr(TJ, "_BLOCK_MIN_CELLS", {})
    v = TJ.adaptive_block_min_cells("cpu")
    assert isinstance(v, int) and 0 <= v <= TJ.BLOCK_MIN_CELLS_MAX == 1 << 24
    assert TJ._BLOCK_MIN_CELLS == {"cpu": v}
    assert TJ.adaptive_block_min_cells(torch.device("cpu")) == v
    monkeypatch.setenv("SPATIALFLINK_JOIN_BLOCK_MIN_CELLS", "1234")
    assert TJ.adaptive_block_min_cells("cpu") == 1234
    monkeypatch.setenv("SPATIALFLINK_JOIN_BLOCK_MIN_CELLS", "-5")
    assert TJ.adaptive_block_min_cells("cpu") == 0


@pytest.mark.parametrize("budget", [None, 1])
def test_join_pairs_host_with_a_prebuilt_index(budget):
    """A prebuilt join index gives the pairs of the call that builds its
    own, on both branches (K6 alone; K7 then K6)."""
    rng = np.random.default_rng(11)
    grid = TParams.from_yaml(CONF).grids()[0]
    cpu = torch.device("cpu")

    def batch(n):
        return PointBatch.from_arrays(rng.uniform(116.2, 116.6, n),
                                      rng.uniform(40.1, 40.4, n),
                                      device=cpu, grid=grid)

    a, b = batch(700), batch(300)
    index = TJ.join_index(b, grid.n)
    got = TJ.join_pairs_host(a, b, 0.01, grid, lattice_budget=budget,
                             index=index)
    want = TJ.join_pairs_host(a, b, 0.01, grid, lattice_budget=budget)
    assert got[0].size > 0
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_cli_panes_on_a_join_matches_jax(tmp_path, capsys, monkeypatch):
    _pinned(monkeypatch, ALL_BLOCKS)
    conf = tmp_path / "conf.yml"
    conf.write_text(open(CONF).read().replace("radius: 0.5",
                                              f"radius: {RADIUS}"))
    in1, in2 = tmp_path / "in1.txt", tmp_path / "in2.txt"
    in1.write_text("\n".join(STREAMS["Point"]) + "\n")
    in2.write_text("\n".join(QUERIES["Point"]) + "\n")
    args = ["--config", str(conf), "--option", "101", "--input1", str(in1),
            "--format", KIND["Point"], "--input2", str(in2), "--format2",
            KIND["Point"], "--panes"]
    assert JD.main(args) == 0
    want = capsys.readouterr().out
    assert TD.main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and want.count("'window'") >= 5
