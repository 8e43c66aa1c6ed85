"""K3, the pane top-k merge, on the CPU: its plain version
``ops.knn.merge_topk_stacked_plain`` against the JAX package's
``_merge_topk_stacked`` / ``_merge_topk_stacked_multi`` on seeded numpy
partials, every field equal (ids, distances and validity, padding slots
included), at P in {1, 2, 7, 60} panes, k in {1, 10, 50, 100} and Q in
{1, 4} query rows, with duplicate ids, ties at the k-th place, all-invalid
rows, rows wider than one of the kernel's blocks and k = 1,025. The pane
merge's covering argument (each tile's top-k survivors, merged again,
give the row's top-k, which the host merge relies on) is emulated with the
plain version; a hypothesis property holds the plain version to a
dict-and-sort reference and to that emulation. The kernel's own merge is
emulated in tests/test_torch_k3_rank.py, and the kernel runs in
tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from spatialflink_tpu.ops import knn as JK

from spatialflink_tpu_torch.ops import knn as K

torch.set_num_threads(1)

SENT = K._OID_SENTINEL
BIG = np.float32(K._BIG)


def _partials(P, Q, k, seed, *, ids=None, dists=None, p_valid=0.85):
    """Seeded (P, Q, k) partials: ids from a pool of ``ids`` (duplicates
    across panes), distances drawn from ``dists`` when given (ties), and
    invalid slots holding (sentinel, BIG) as K2 leaves them."""
    rng = np.random.default_rng(seed)
    pool = ids or max(2, 2 * k)
    oid = rng.integers(0, pool, (P, Q, k)).astype(np.int32)
    if dists is None:
        d = rng.uniform(0.0, 1.0, (P, Q, k)).astype(np.float32)
    else:
        d = rng.choice(np.asarray(dists, np.float32), (P, Q, k))
    valid = rng.random((P, Q, k)) < p_valid
    return (np.where(valid, oid, SENT).astype(np.int32),
            np.where(valid, d, BIG).astype(np.float32), valid)


def _jax(oid, d, v, k, single=False):
    fn = JK._merge_topk_stacked if single else JK._merge_topk_stacked_multi
    return tuple(np.asarray(a) for a in fn(jnp.asarray(oid), jnp.asarray(d),
                                            jnp.asarray(v), k=k))


def _plain(oid, d, v, k):
    return tuple(t.numpy() for t in K.merge_topk_stacked_plain(
        torch.from_numpy(oid), torch.from_numpy(d), torch.from_numpy(v), k))


def _assert_same(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("Q", [1, 4])
@pytest.mark.parametrize("k", [1, 10, 50, 100])
@pytest.mark.parametrize("P", [1, 2, 7, 60])
def test_plain_matches_jax(P, k, Q):
    oid, d, v = _partials(P, Q, k, seed=P * 1000 + k * 10 + Q)
    _assert_same(_plain(oid, d, v, k), _jax(oid, d, v, k))
    # the (P, k) form of one query row
    _assert_same(_plain(oid[:, 0], d[:, 0], v[:, 0], k),
                 _jax(oid[:, 0], d[:, 0], v[:, 0], k, single=True))


@pytest.mark.parametrize("case", ["duplicates", "ties", "all_invalid",
                                  "one_object", "wide"])
def test_edge_cases_match_jax(case):
    P, Q, k = 7, 4, 50
    kw = {}
    if case == "duplicates":
        kw = dict(ids=30)           # every id in many panes
    elif case == "ties":
        kw = dict(dists=[0.25, 0.5, 0.75])  # equal distances at the k-th
    elif case == "all_invalid":
        kw = dict(p_valid=0.0)
    elif case == "one_object":
        kw = dict(ids=1)
    elif case == "wide":
        P, Q, k = 100, 2, 100       # 10,000 candidates per row
        kw = dict(ids=6000, dists=[0.1, 0.2, 0.3, 0.4])
    oid, d, v = _partials(P, Q, k, seed=7, **kw)
    got = _plain(oid, d, v, k)
    _assert_same(got, _jax(oid, d, v, k))
    n_valid = got[2].sum(axis=1)
    if case == "all_invalid":
        assert n_valid.sum() == 0
        assert (got[0] == SENT).all() and (got[1] == BIG).all()
    elif case == "duplicates":
        assert (n_valid == 30).all()  # fewer objects than k
    elif case == "one_object":
        assert (n_valid == 1).all()
    else:
        assert (n_valid == k).all()
    if case == "ties":
        for row_o, row_d, row_v in zip(*got):
            last = row_d[row_v][-1]
            tied = row_o[row_v][row_d[row_v] == last]
            assert len(tied) > 1 and np.all(np.diff(tied) > 0)
    if case == "wide":
        assert P * k > 1024  # kMaxKeys in csrc/knn_merge.cu


def test_one_object_in_two_panes_keeps_its_minimum():
    oid = np.full((2, 1, 3), SENT, np.int32)
    d = np.full((2, 1, 3), BIG, np.float32)
    v = np.zeros((2, 1, 3), bool)
    oid[0, 0, :2], d[0, 0, :2], v[0, 0, :2] = [4, 9], [0.5, 0.7], True
    oid[1, 0, :2], d[1, 0, :2], v[1, 0, :2] = [9, 2], [0.1, 0.7], True
    got = _plain(oid, d, v, 3)
    _assert_same(got, _jax(oid, d, v, 3))
    assert got[0][0].tolist() == [9, 4, 2]
    assert got[1][0].tolist() == [np.float32(0.1), np.float32(0.5),
                                  np.float32(0.7)]


def _tiled(oid, d, v, k, tile):
    """The kernel's tiled path in plain form: each row cut into tiles of
    ``tile`` candidates (pane-major order), each tile's top-k kept as
    survivors, the survivors merged again until a row fits one tile."""
    P, Q, _ = oid.shape
    o = torch.from_numpy(oid).permute(1, 0, 2).reshape(Q, -1)
    dd = torch.from_numpy(d).permute(1, 0, 2).reshape(Q, -1)
    vv = torch.from_numpy(v).permute(1, 0, 2).reshape(Q, -1)
    while o.shape[1] > tile:
        outs = []
        for lo in range(0, o.shape[1], tile):
            part = [t[:, lo:lo + tile][None] for t in (o, dd, vv)]
            outs.append(K.merge_topk_stacked_plain(*part, k))
        o, dd, vv = (torch.cat([getattr(r, f) for r in outs], dim=1)
                     for f in K.KnnResult._fields)
    return tuple(t.numpy() for t in K.merge_topk_stacked_plain(
        o[None], dd[None], vv[None], k))


@pytest.mark.parametrize("P,k,tile", [(100, 100, 8192), (16, 1024, 8192),
                                      (60, 10, 64), (9, 7, 16)])
def test_tiled_path_equals_one_sort(P, k, tile):
    """Survivors of tiles merge to the same list as one sort of the whole
    row (the covering argument of the pane merge itself), also when a
    second level of tiles is needed (60 x 10 over tiles of 64)."""
    oid, d, v = _partials(P, 2, k, seed=P + k, ids=3 * k,
                          dists=np.linspace(0.0, 1.0, 9))
    _assert_same(_tiled(oid, d, v, k, tile), _plain(oid, d, v, k))


def _reference(oid, d, v, k):
    """A dict-and-sort reference per row: minimum per id, then (dist,
    id)."""
    P, Q, w = oid.shape
    out = []
    for q in range(Q):
        best = {}
        for p in range(P):
            for i in range(w):
                if v[p, q, i]:
                    o = int(oid[p, q, i])
                    best[o] = min(best.get(o, np.inf), float(d[p, q, i]))
        out.append(sorted(best.items(), key=lambda kv: (kv[1], kv[0]))[:k])
    return out


@settings(max_examples=60, deadline=None)
@given(P=st.integers(1, 6), Q=st.integers(1, 3), k=st.integers(1, 8),
       seed=st.integers(0, 2 ** 16), ids=st.integers(1, 12),
       p_valid=st.sampled_from([0.0, 0.5, 1.0]))
def test_plain_property(P, Q, k, seed, ids, p_valid):
    oid, d, v = _partials(P, Q, k, seed, ids=ids,
                          dists=[0.0, 0.5, 1.0, 2.0], p_valid=p_valid)
    got = _plain(oid, d, v, k)
    ref = _reference(oid, d, v, k)
    for q in range(Q):
        n = len(ref[q])
        assert got[2][q].tolist() == [True] * n + [False] * (k - n)
        assert [(int(o), float(x)) for o, x in
                zip(got[0][q][:n], got[1][q][:n])] == ref[q]
        assert (got[0][q][n:] == SENT).all() and (got[1][q][n:] == BIG).all()
    _assert_same(_tiled(oid, d, v, k, tile=max(2, 2 * k)), got)


def test_k_limits_and_devices():
    """Any k >= 1 (k = 1,025 against the JAX package), the stacked entry
    only on a card, the device pane merge on the CPU as the plain
    version."""
    big = _partials(3, 2, 1025, 1, ids=2500)
    _assert_same(_plain(*big, 1025), _jax(*big, 1025))
    oid, d, v = (torch.from_numpy(a) for a in _partials(2, 1, 4, 0))
    with pytest.raises(ValueError, match="k must be >= 1"):
        K.knn_merge_parts([K.KnnResult(oid[0], d[0], v[0])], 0)
    with pytest.raises(ValueError, match="needs cuda"):
        K.knn_merge(oid, d, v, 4)
    res = K.knn_merge_parts(
        [K.KnnResult(oid[p], d[p], v[p]) for p in range(2)], 4)
    _assert_same(tuple(t.numpy() for t in res), _plain(*(t.numpy() for t in
                                                          (oid, d, v)), 4))
    one = K.knn_merge_parts(
        [K.KnnResult(oid[p, 0], d[p, 0], v[p, 0]) for p in range(2)], 4)
    assert one.obj_id.shape == (4,)
    np.testing.assert_array_equal(one.obj_id.numpy(), res.obj_id[0].numpy())


def test_host_merge_breaks_ties_by_interned_id():
    """``merge_topk_host`` orders equal distances by the tie key the
    operators pass (the interner's ``intern``), not by string order."""
    order = {"zz": 0, "aa": 1, "mm": 2}
    parts = [[("aa", 0.5), ("zz", 0.7)], [("mm", 0.5), ("zz", 0.5)]]
    got = K.merge_topk_host(parts, 2, tie_key=order.__getitem__)
    assert got == [("zz", 0.5), ("aa", 0.5)]
    jax = JK.merge_topk_host(parts, 2, tie_key=order.__getitem__)
    assert got == jax
    assert K.merge_topk_host(parts, 2) == [("aa", 0.5), ("mm", 0.5)]
