"""K8a's, K8b's and K8c's key layout on the CPU: the host helpers that
pick the key's width, its passes and the path (one block or tiled) at the
edges the card tests cover, and the ts range the trajectory operators pass
to ``tstats_update`` and ``tstats_window_summary``, which must hold the ts
of every slot of its batch (padded ones too) for the kernel's key to sort
as the plain version does. The kernels themselves run in
tests/test_torch_cuda.py on the card."""

import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from spatialflink_tpu_torch import driver as TD
from spatialflink_tpu_torch.config import Params
from spatialflink_tpu_torch.models import PointBatch
from spatialflink_tpu_torch.ops import trajectory as T

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "conf", "spatialflink-conf.yml")
T0 = 1_700_000_000_000
CPU = torch.device("cpu")


def test_one_block_max_matches_the_source():
    src = open(os.path.join(REPO, "spatialflink_tpu_torch", "csrc",
                            "traj.cu")).read()
    assert re.search(r"constexpr int kOneBlockMax = (\d+);",
                     src).group(1) == str(T.ONE_BLOCK_MAX)


@pytest.mark.parametrize("bits,passes", [
    (1, 1), (8, 1), (9, 2), (24, 3), (25, 4), (32, 4), (33, 5), (40, 5),
    (63, 8), (64, 8)])
def test_sort_layout_passes(bits, passes):
    lay = T.sort_layout(100_000, bits)
    assert (lay.bits, lay.passes) == (bits, passes)
    assert not lay.one_block and lay.launches == passes + 2


@pytest.mark.parametrize("offset,one_block", [(-1, True), (0, True),
                                              (1, False)])
def test_sort_layout_one_block_limit(offset, one_block):
    n = T.ONE_BLOCK_MAX + offset
    lay = T.sort_layout(n, 29)
    assert lay.one_block == one_block
    assert lay.launches == (1 if one_block else 6)


def test_sort_layout_edges(monkeypatch):
    assert T.sort_layout(0, 29).launches == 0
    assert T.sort_layout(1, 29) == T.SortLayout(29, 4, True, 1)
    for bad in (0, 65):
        with pytest.raises(ValueError):
            T.sort_layout(10, bad)
    # the limit is read at call time: the card tests force the tiled path
    # down to one point
    monkeypatch.setattr(T, "ONE_BLOCK_MAX", 0)
    assert T.sort_layout(1, 29) == T.SortLayout(29, 4, False, 6)


@pytest.mark.parametrize("lo,hi,ts_bits", [
    (0, 0, 0), (5, 5, 0), (0, 1, 1), (0, 8_191, 13), (0, 8_192, 14),
    (-2 ** 29, 2 ** 29 - 1, 30), (-3_000, 500, 12), (0, 9_999, 14),
    (-2 ** 31, 2 ** 31 - 1, 32)])
def test_tstats_layout_ts_bits(lo, hi, ts_bits):
    got, lay = T.tstats_layout(100_000, 1024, lo, hi)
    assert got == ts_bits
    assert lay.bits == 11 + ts_bits


@pytest.mark.parametrize("m,m_bits", [(1, 1), (2, 2), (1023, 10),
                                      (1024, 11), (1025, 11),
                                      (16_384, 15)])
def test_tstats_layout_pad_marker(m, m_bits):
    """The object field holds m itself, the padded slots' marker: a power
    of two gains a bit over the ids below it."""
    _, lay = T.tstats_layout(10, m, 0, 9_999)
    assert lay.bits == m_bits + 14


def test_main_path_layouts():
    """The 10 s window of 10,357 taxis in a 16,384-slot state (262,144
    slots, 10 s of offsets): a 29-bit key, 4 passes, 6
    launches; a 512-point realtime cut: one launch. K8c over 10,000
    cells: 28 bits, 6 launches; a 31-bit id field makes it 40 bits."""
    ts_bits, lay = T.tstats_layout(262_144, 16_384, 0, 9_999)
    assert (ts_bits, lay) == (14, T.SortLayout(29, 4, False, 6))
    assert T.tstats_layout(512, 16_384, -2_000, 400)[1].launches == 1
    assert T._oid_bits(10_357) == 14
    assert T.extents_layout(262_144, 10_000, 14) == T.SortLayout(
        28, 4, False, 6)
    assert T.extents_layout(512, 10_000, 14).launches == 1
    assert T.extents_layout(262_144, 400, T._oid_bits(2 ** 31 - 1)) == \
        T.SortLayout(40, 5, False, 7)
    with pytest.raises(ValueError):
        T._oid_bits(2 ** 31 + 1)


@pytest.mark.parametrize("n,m,lo,hi", [
    (1, 256, 0, 10_000), (4_095, 1024, 0, 10_000), (4_096, 1024, 0, 10_000),
    (4_097, 1024, 0, 10_000), (134_581, 16_384, 0, 4_999),
    (262_144, 16_384, 0, 9_999), (9_001, 256, -2 ** 29, 2 ** 29 - 1),
    (3_000, 1, 0, 10_000), (3_000, 1025, -3_000, 500),
    (9_001, 2 ** 20, -2 ** 31, 2 ** 31 - 1)])
def test_summary_layout_is_k8as(n, m, lo, hi, monkeypatch):
    """K8b sorts on K8a's key, with K8a's passes, path and launches (6 at
    the 5 s pane of 134,581 points; one at a cut), forced paths included."""
    assert T.summary_layout(n, m, lo, hi) == T.tstats_layout(n, m, lo, hi)
    monkeypatch.setattr(T, "ONE_BLOCK_MAX", 0)
    assert T.summary_layout(n, m, lo, hi) == T.tstats_layout(n, m, lo, hi)


def test_summary_layout_of_an_empty_batch(monkeypatch):
    """An empty batch still takes one launch (it writes every row absent),
    on the one-block path whatever the limit; K8a's takes none."""
    assert T.tstats_layout(0, 16_384, 0, 0)[1].launches == 0
    for limit in (T.ONE_BLOCK_MAX, 0):
        monkeypatch.setattr(T, "ONE_BLOCK_MAX", limit)
        ts_bits, lay = T.summary_layout(0, 16_384, 0, 0)
        assert (ts_bits, lay) == (0, T.SortLayout(15, 2, True, 1))
    assert T.summary_layout(134_581, 16_384, 0, 4_999)[1] == T.SortLayout(
        28, 4, False, 6)


@pytest.mark.parametrize("lo,hi,m", [(1, 0, 10), (-2 ** 31 - 1, 0, 10),
                                     (0, 2 ** 31, 10), (0, 5, 0)])
def test_tstats_layout_refuses(lo, hi, m):
    with pytest.raises(ValueError):
        T.tstats_layout(10, m, lo, hi)


@pytest.mark.parametrize("n,base,spread", [
    (1, T0, 0), (200, T0, 10_000), (256, T0, 10_000),
    (300, T0 + 5_000, 10_000), (4_096, T0 - 2_000, 3_000),
    (5, T0, 2 ** 33)])
def test_point_batch_ts_range_holds_every_slot(n, base, spread):
    """PointBatch.ts_range of the host rows holds the ts of every slot of
    the batch PointBatch.from_arrays builds from them (padded slots' 0
    and offsets that wrap included), and is tight."""
    rng = np.random.default_rng(n)
    ts = T0 + rng.integers(0, spread + 1, n)
    b = PointBatch.from_arrays(np.zeros(n), np.zeros(n), device=CPU,
                               ts=ts, ts_base=base)
    assert PointBatch.ts_range(ts, base) == (int(b.ts.min()),
                                             int(b.ts.max()))


def _lines(trajs=12, steps=40, seed=0):
    """CSV rows 'traj-i,ts,x,y' of random walks 400 ms apart, 5 % of them
    up to 1.5 s late, over the conf's bbox."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(115.7, 117.3, trajs)
    y = rng.uniform(39.9, 41.0, trajs)
    out = []
    for step in range(steps):
        x = x + rng.normal(0.0, 0.01, trajs)
        y = y + rng.normal(0.0, 0.01, trajs)
        for i in range(trajs):
            t = T0 + 400 * step
            if rng.random() < 0.05:
                t -= int(rng.integers(0, 1500))
            out.append(f"traj-{i},{t},{float(x[i])!r},{float(y[i])!r}")
    return out


@pytest.mark.parametrize("option,query,k8a", [
    (205, {}, True), (206, {}, True), (206, {"panes": True}, False),
    (208, {"aggregate_function": "SUM"}, False)])
def test_operators_pass_ranges_that_hold_their_batches(monkeypatch, option,
                                                       query, k8a):
    """Every K8a call of options 205 and 206, and every K8b call of 206
    with panes (one per pane), states the ts range of its batch, and it
    holds every slot's ts (tightly); 208 (K8c, whose payload is ts itself)
    sorts without one."""
    calls = {"tstats_update": [], "taggregate_group_extents": 0,
             "tstats_window_summary": []}
    update, extents = T.tstats_update, T.taggregate_group_extents
    summary = T.tstats_window_summary

    def rec_update(state, batch, ts_range=None):
        calls["tstats_update"].append((ts_range, int(batch.ts.min()),
                                       int(batch.ts.max())))
        return update(state, batch, ts_range=ts_range)

    def rec_extents(*a, **kw):
        calls["taggregate_group_extents"] += 1
        return extents(*a, **kw)

    def rec_summary(batch, *, m, ts_range=None):
        calls["tstats_window_summary"].append((ts_range, int(batch.ts.min()),
                                               int(batch.ts.max())))
        return summary(batch, m=m, ts_range=ts_range)

    monkeypatch.setattr(T, "tstats_update", rec_update)
    monkeypatch.setattr(T, "taggregate_group_extents", rec_extents)
    monkeypatch.setattr(T, "tstats_window_summary", rec_summary)
    p = Params.from_yaml(CONF)
    p.query.option = option
    for key, value in query.items():
        setattr(p.query, key, value)
    p = dataclasses.replace(p, input1=dataclasses.replace(p.input1,
                                                          format="CSV"))
    wins = list(TD.run_option(p, iter(_lines()), iter([]), device="cpu"))
    assert wins
    for rng_ts, lo, hi in (calls["tstats_update"]
                           + calls["tstats_window_summary"]):
        assert rng_ts == (lo, hi)
    if k8a:
        assert calls["tstats_update"]
    else:
        assert not calls["tstats_update"]
        assert (len(calls["tstats_window_summary"])
                + calls["taggregate_group_extents"]) > 0
    if query.get("panes"):
        assert len(calls["tstats_window_summary"]) > 1


def test_a_stated_range_that_misses_the_batch_is_refused():
    """On the CPU the wrapper checks a stated range against the batch (on
    the card that would cost a sync; the operators take it from the rows
    the batch is built from): K8a's."""
    b = PointBatch.from_arrays(np.zeros(3), np.zeros(3), device=CPU,
                               obj_id=np.arange(3), ts=[T0, T0 + 5, T0 + 9],
                               ts_base=T0)
    state = T.TrajStatsState.zeros(4, "cpu")
    T.tstats_update(state, b, ts_range=(0, 9))
    with pytest.raises(ValueError, match="does not hold"):
        T.tstats_update(T.TrajStatsState.zeros(4, "cpu"), b,
                        ts_range=(1, 9))
    assert torch.equal(state.last_ts[:3], torch.tensor([0, 5, 9],
                                                       dtype=torch.int32))


@pytest.mark.parametrize("bad", [(1, 9), (0, 8), (10, 20)])
def test_a_summary_range_that_misses_the_batch_is_refused(bad):
    """K8b's wrapper checks its stated range on the CPU as K8a's does; a
    range that holds the batch gives the plain version's summary."""
    b = PointBatch.from_arrays([1.0, 2.0, 4.0], [0.0, 0.0, 0.0], device=CPU,
                               obj_id=[0, 0, 2], ts=[T0, T0 + 5, T0 + 9],
                               ts_base=T0)
    want = T.tstats_window_summary_plain(b, m=4)
    for ok in ((0, 9), (-5, 100), None):
        got = T.tstats_window_summary(b, m=4, ts_range=ok)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert want.count.tolist() == [2, 0, 1, 0]
    with pytest.raises(ValueError, match="tstats_window_summary: .*does not "
                                         "hold"):
        T.tstats_window_summary(b, m=4, ts_range=bad)
