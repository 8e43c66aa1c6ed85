"""K3's merge of sorted pane lists, and kNN at any k, on the CPU.

The kernel (``csrc/knn_merge.cu`` over ``csrc/topk_merge.cuh``) is
emulated in numpy step for step: the 64-bit (distance, id) keys, the
order check of each pane's piece and the block sort of a chunk that fails
it, the merge rounds (a binary search per key into the partner run), the
open-addressing table of each id's first index (filled in a random order,
as atomics land), the kept flags and the first k; a row wider than one
block reduces to its chunks' top-k survivors (2k up to the block's keys)
or sorts in chunks that merge across blocks. Under hypothesis the
emulation equals ``ops.knn.merge_topk_stacked_plain`` bit for bit on K2-
style partials (sorted, unique ids), sorted lists with repeated ids,
unsorted lists, ties at the k-th place, -0.0 beside +0.0 and all-invalid
rows, with one block and with chunks of 4 to 16 keys (both wide paths).

Beside it: the parts-list entry ``knn_merge_parts`` on CPU tensors with
(k,) and (Q, k) partials against the stacked plain version; the merge at
k = 1,025, 2,048 and k above the ids against the JAX package's
``_merge_topk_stacked(_multi)``; and option 51 with panes at k = 1,100
through both drivers' CLIs, host and device merge, stdout byte for byte.
K2 at k above 1,024 is in tests/test_torch_knn.py; the kernels themselves
run in tests/test_torch_cuda.py.
"""

import os
import re

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

from spatialflink_tpu import driver as JD
from spatialflink_tpu.ops import knn as JK

from spatialflink_tpu_torch import driver as TD
from spatialflink_tpu_torch.ops import knn as K

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONF = os.path.join(REPO, "conf", "spatialflink-conf.yml")
SENT = K._OID_SENTINEL
BIG = np.float32(K._BIG)
NOKEY = np.uint64(2 ** 64 - 1)
LOW = np.uint64(0xFFFFFFFF)
with open(os.path.join(REPO, "spatialflink_tpu_torch", "csrc",
                       "knn_merge.cu")) as _f:
    _SRC = _f.read()
#: the keys of one block, and the most levels of the survivor reduce (the
#: kernel's kMaxKeys and kReduceLevels)
TILE, LEVELS = (int(re.search(rf"constexpr int {name} = (\d+);",
                              _SRC).group(1))
                for name in ("kMaxKeys", "kReduceLevels"))


# ------------------------------------------------------------------------ #
# the kernel's algorithm in numpy


def _keys(oid, d, v):
    """The kernel's keys of one row's slots (pane-major)."""
    b = d.view(np.uint32)
    od = np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint64)
    oi = (oid.view(np.uint32) ^ np.uint32(0x80000000)).astype(np.uint64)
    cand = v & (oid != SENT) & (d < BIG)
    return np.where(cand, (od << np.uint64(32)) | oi, NOKEY)


class Runs:
    """``topk_merge::Runs``: n keys, run 0 = [0, f), then runs of w."""

    def __init__(self, n, f, w):
        self.n, self.f, self.w = n, f, w

    def start(self, i):
        return 0 if i <= 0 else min(self.n, self.f + (i - 1) * self.w)

    def of(self, j):
        return 0 if j < self.f else 1 + (j - self.f) // self.w

    def count(self):
        return 1 if self.n <= self.f else 1 + -(-(self.n - self.f) // self.w)


def _merged_index(a, runs, t, j):
    key = a[j]
    r = runs.of(j) >> t
    pair = r >> 1
    l0 = runs.start((2 * pair) << t)
    r0 = runs.start((2 * pair + 1) << t)
    r1 = runs.start((2 * pair + 2) << t)
    if r % 2 == 0:
        return j if r0 == r1 else j + int(np.searchsorted(a[r0:r1], key,
                                                          "left"))
    return l0 + (j - r0) + int(np.searchsorted(a[l0:r0], key, "right"))


def _merge_runs(a, runs):
    """The merge rounds; each round must place every key once."""
    t = 0
    while (1 << t) < runs.count():
        b = np.zeros_like(a)
        hit = np.zeros(runs.n, bool)
        for j in range(runs.n):
            at = _merged_index(a, runs, t, j)
            assert not hit[at]
            hit[at] = True
            b[at] = a[j]
        a, t = b, t + 1
    return a


def _pow2_at_least(v):
    p = 2
    while p < v:
        p <<= 1
    return p


def _block(row, g0, length, k, size):
    """One block of ``merge_block_kernel``: its chunk sorted."""
    a = np.full(size, NOKEY, np.uint64)
    a[:length] = row[g0:g0 + length]
    bad = any(a[j] > a[j + 1] for j in range(length - 1)
              if (g0 + j + 1) % k != 0)
    runs = Runs(length, min(length, k - g0 % k), k)
    if bad:
        a = np.sort(a)
        runs = Runs(length, length, length)
    return _merge_runs(a[:length], runs)


def _slot_of(i, mask):
    return (int(i) * 0x9E3779B1) & 0xFFFFFFFF & mask


def _first_of(tab, mask, keys, i):
    h = _slot_of(i, mask)
    while True:
        e = tab[h]
        if e < 0:
            return -1
        if keys[e] & LOW == i:
            return e
        h = (h + 1) & mask


def _kept(r, k, slots, rng):
    """The id table (inserts in a random order), the kept flags and the
    first k kept keys."""
    mask = slots - 1
    tab = np.full(slots, -1, np.int64)
    for j in rng.permutation(len(r)):
        if r[j] == NOKEY:
            continue
        i, h = r[j] & LOW, _slot_of(r[j] & LOW, mask)
        while True:
            e = tab[h]
            if e < 0:
                tab[h] = j
                break
            if r[e] & LOW == i:
                tab[h] = min(e, j)
                break
            h = (h + 1) & mask
    kept = [j for j in range(len(r)) if r[j] != NOKEY
            and _first_of(tab, mask, r, r[j] & LOW) == j][:k]
    return r[kept]


def _fields(keys, k):
    """k output slots from the kept keys: (oid, dist, valid)."""
    hi = (keys >> np.uint64(32)).astype(np.uint32)
    dist = np.where(hi & 0x80000000, hi & 0x7FFFFFFF, ~hi).astype(np.uint32)
    oid = ((keys & LOW).astype(np.uint32) ^ np.uint32(0x80000000))
    pad = k - len(keys)
    return (np.r_[oid.view(np.int32), np.full(pad, SENT, np.int32)],
            np.r_[dist.view(np.float32), np.full(pad, BIG, np.float32)],
            np.r_[np.ones(len(keys), bool), np.zeros(pad, bool)])


def _one_block(row, k, rng):
    size = _pow2_at_least(len(row))
    return _kept(_block(row, 0, len(row), k, size), k, 2 * size, rng)


def _reduces(n, k, tile):
    """The kernel's ``reduces``: survivors shrink the row within LEVELS
    levels."""
    if 2 * k > tile:
        return False
    levels = 0
    while n > tile:
        n, levels = -(-n // tile) * k, levels + 1
    return levels <= LEVELS


def emulate(oid, d, v, k, tile=TILE, seed=0):
    """The kernel over (P, Q, k) partials: (Q, k) fields. A row of up to
    ``tile`` keys is one block; a wider one reduces to its chunks' top-k
    survivors when 2k <= tile and that takes at most LEVELS levels, else
    sorts across chunks (merge rounds) and dedups the sorted row."""
    rng = np.random.default_rng(seed)
    P, Q, _ = oid.shape
    n = P * k
    out = []
    for q in range(Q):
        row = _keys(oid[:, q].reshape(-1), d[:, q].reshape(-1),
                    v[:, q].reshape(-1))
        if n > tile and _reduces(n, k, tile):
            while len(row) > tile:
                surv = []
                for g0 in range(0, len(row), tile):
                    m = min(tile, len(row) - g0)
                    kept = _kept(_block(row, g0, m, k, tile), k, 2 * tile,
                                 rng)
                    surv.append(np.r_[kept, np.full(k - len(kept), NOKEY)])
                row = np.concatenate(surv).astype(np.uint64)
            keys = _one_block(row, k, rng)
        elif n > tile:
            chunks = [_block(row, g0, min(tile, n - g0), k, tile)
                      for g0 in range(0, n, tile)]
            r = _merge_runs(np.concatenate(chunks), Runs(n, tile, tile))
            keys = _kept(r, k, _pow2_at_least(2 * n), rng)
        else:
            keys = _one_block(row, k, rng)
        out.append(_fields(keys, k))
    return tuple(np.stack([o[f] for o in out]) for f in range(3))


# ------------------------------------------------------------------------ #
# partials


def partials(P, Q, k, seed, *, ids, dists, p_valid=0.8, layout="k2"):
    """Seeded (P, Q, k) partials. ``k2``: each pane row as K2 writes it
    (unique ids, valid slots first by (distance, id), then (sentinel, BIG,
    False)); ``sorted``: slots sorted by (distance, id) with ids repeated;
    ``random``: no order."""
    rng = np.random.default_rng(seed)
    oid = np.full((P, Q, k), SENT, np.int32)
    d = np.full((P, Q, k), BIG, np.float32)
    v = np.zeros((P, Q, k), bool)
    pool = np.asarray(dists, np.float32)
    for p in range(P):
        for q in range(Q):
            if layout == "k2":
                m = int(rng.binomial(min(k, ids), p_valid))
                o = rng.choice(ids, m, replace=False).astype(np.int32)
                x = rng.choice(pool, m)
                order = np.lexsort((o, x.view(np.uint32)))  # x >= 0 here
                oid[p, q, :m], d[p, q, :m] = o[order], x[order]
                v[p, q, :m] = True
                continue
            o = rng.integers(0, ids, k).astype(np.int32)
            x = rng.choice(pool, k)
            ok = rng.random(k) < p_valid
            if layout == "sorted":
                order = np.lexsort((o, _keys(o, x, np.ones(k, bool))))
                o, x = o[order], x[order]
                ok = np.sort(ok)[::-1]
            oid[p, q] = np.where(ok, o, SENT)
            d[p, q] = np.where(ok, x, BIG)
            v[p, q] = ok
    return oid, d, v


def _plain(oid, d, v, k):
    return tuple(t.numpy() for t in K.merge_topk_stacked_plain(
        torch.from_numpy(oid), torch.from_numpy(d), torch.from_numpy(v), k))


def _assert_bits(got, want):
    for g, w in zip(got, want):
        assert g.shape == w.shape
        if g.dtype == np.float32:
            g, w = g.view(np.uint32), w.view(np.uint32)
        np.testing.assert_array_equal(g, w)


@settings(max_examples=80, deadline=None)
@given(P=st.integers(1, 7), Q=st.integers(1, 2), k=st.integers(1, 9),
       ids=st.integers(1, 20), seed=st.integers(0, 2 ** 16),
       layout=st.sampled_from(["k2", "sorted", "random"]),
       p_valid=st.sampled_from([0.0, 0.6, 1.0]),
       tile=st.sampled_from([TILE, 4, 8, 16]))
def test_emulated_kernel_equals_plain(P, Q, k, ids, seed, layout, p_valid,
                                      tile):
    dists = [0.0, 0.25, 0.5, 1.0] + ([] if layout == "k2" else [-0.0])
    oid, d, v = partials(P, Q, k, seed, ids=ids, dists=dists,
                         p_valid=p_valid, layout=layout)
    _assert_bits(emulate(oid, d, v, k, tile=max(tile, 2), seed=seed),
                 _plain(oid, d, v, k))


@pytest.mark.parametrize("layout", ["k2", "sorted", "random"])
@pytest.mark.parametrize("P,k,tile", [(10, 50, TILE), (60, 10, 64),
                                      (3, 40, 32), (5, 7, 16), (40, 8, 16)])
def test_emulated_kernel_on_wide_rows(P, k, tile, layout):
    """Rows past one block (chunks of ``tile`` keys, a pane cut by a chunk
    edge; survivors for (60, 10) and (5, 7), a sort across chunks for (3,
    40) and for (40, 8), whose reduce would take 5 levels), ties at the
    k-th place, ids in many panes."""
    assert (P * k > tile and _reduces(P * k, k, tile)) == (
        (P, k) in ((60, 10), (5, 7)))
    oid, d, v = partials(P, 2, k, P + k, ids=3 * k,
                         dists=np.linspace(0.0, 1.0, 7), layout=layout)
    got = emulate(oid, d, v, k, tile=tile)
    _assert_bits(got, _plain(oid, d, v, k))
    assert got[2].sum() > 0


def test_key_order_is_the_plain_order():
    """The keys sort as (distance in the f32 total order, id in the int32
    order): -0.0 below +0.0, negative ids below positive ones."""
    d = np.float32([1.0, -0.0, 0.0, -1.0, 0.5, 0.5])
    oid = np.int32([3, 4, 4, 9, -2, 7])
    keys = _keys(oid, d, np.ones(6, bool))
    assert np.argsort(keys, kind="stable").tolist() == [3, 1, 2, 4, 5, 0]
    assert _keys(np.int32([SENT, 1, 2]), np.float32([0.1, BIG, 0.1]),
                 np.array([True, True, False])).tolist() == [NOKEY] * 3


# ------------------------------------------------------------------------ #
# the parts-list entry and k above 1,024


@pytest.mark.parametrize("Q", [None, 1, 3])
def test_parts_entry_equals_stacked_plain(Q):
    """``knn_merge_parts``, the device pane merge, over per-pane (k,) or
    (Q, k) partials on the CPU is the plain version over their stack."""
    oid, d, v = partials(4, Q or 1, 20, 5, ids=30, dists=[0.0, 0.5, 1.0],
                         layout="sorted")
    if Q is None:
        oid, d, v = oid[:, 0], d[:, 0], v[:, 0]
    parts = [K.KnnResult(*(torch.from_numpy(a[p]) for a in (oid, d, v)))
             for p in range(4)]
    want = _plain(oid, d, v, 20)
    got = K.knn_merge_parts(parts, 20)
    assert got.obj_id.shape == ((20,) if Q is None else (Q, 20))
    _assert_bits(tuple(t.numpy() for t in got), want)


def test_parts_entry_refusals():
    part = K.KnnResult(torch.zeros(4, dtype=torch.int32), torch.zeros(4),
                       torch.zeros(4, dtype=torch.bool))
    with pytest.raises(ValueError, match="k must be >= 1"):
        K.knn_merge_parts([part], 0)
    with pytest.raises(ValueError, match="at least one partial"):
        K.knn_merge_parts([], 4)


def _jax(oid, d, v, k, single):
    fn = JK._merge_topk_stacked if single else JK._merge_topk_stacked_multi
    return tuple(np.asarray(a) for a in fn(jnp.asarray(oid), jnp.asarray(d),
                                            jnp.asarray(v), k=k))


@pytest.mark.parametrize("k,ids", [(1025, 3000), (2048, 5000), (1500, 700)])
def test_merge_above_1024_matches_jax(k, ids):
    """k = 1,025 and 2,048 over more ids than k, and k above the ids (every
    object kept, the rest padded), in the (P, Q, k) and (P, k) forms."""
    oid, d, v = partials(3, 2, k, k, ids=ids, dists=np.linspace(0, 1, 50),
                         layout="k2")
    want = _jax(oid, d, v, k, single=False)
    _assert_bits(_plain(oid, d, v, k), want)
    parts = [K.KnnResult(*(torch.from_numpy(a[p, 0]) for a in (oid, d, v)))
             for p in range(3)]
    got = tuple(t.numpy() for t in K.knn_merge_parts(parts, k))
    _assert_bits(got, _jax(oid[:, 0], d[:, 0], v[:, 0], k, single=True))
    n_valid = int(got[2].sum())
    assert (n_valid == k) if ids > 2 * k else (0 < n_valid < k)


def _k1100_conf(tmp_path):
    text = open(CONF).read()
    assert "\n  k: 10\n" in text
    conf = tmp_path / "conf.yml"
    conf.write_text(text.replace("\n  k: 10\n", "\n  k: 1100\n"))
    return str(conf)


def _lines(n=6000, ids=2500, seed=23):
    rng = np.random.default_rng(seed)
    x = rng.uniform(115.55, 117.55, n)
    y = rng.uniform(39.65, 41.05, n)
    ts = 1_700_000_000_000 + np.sort(rng.integers(0, 22_000, n))
    return [f"o{o},{t},{float(a)!r},{float(b)!r}" for o, t, a, b in
            zip(rng.integers(0, ids, n).tolist(), ts.tolist(), x, y)]


@pytest.mark.parametrize("merge", ["host", "device"])
def test_cli_k1100_with_panes_matches_jax(tmp_path, capsys, merge):
    """Option 51, query.k = 1,100, panes on: a 10 s window holds more
    objects than k, a 5 s pane fewer (its partial padded)."""
    inp = tmp_path / "in.csv"
    inp.write_text("\n".join(_lines()) + "\n")
    args = ["--config", _k1100_conf(tmp_path), "--option", "51",
            "--input1", str(inp), "--format", "CSV", "--panes",
            "--pane-merge", merge]
    assert JD.main(args) == 0
    want = capsys.readouterr().out
    assert TD.main(args + ["--device", "cpu"]) == 0
    got = capsys.readouterr().out
    assert got == want and want.count("'k': 1100") >= 3
