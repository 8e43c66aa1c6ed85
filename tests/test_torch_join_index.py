"""The join index of K6 and K7 (``spatialflink_tpu_torch/ops/join.py``
``join_index_plain``, ``index_keys``, ``index_layout``; the walk of
``csrc/join_walk.cuh``) on the CPU:

- the composite key (bucket 0 for a cell < 0, cell + 1 inside the grid,
  n*n + 1 beyond it, n*n + 2 for an invalid point; tile-major) and the
  layout's int32 limit (a stride of 0, one sort per tile, past it);
- the plain index: each tile's points in its own section, keys ascending,
  b ascending within a bucket, coordinates gathered, per-tile sorts equal
  to one global sort;
- a plain model of the runs a row visits, for K7's cell rule (``cell //
  n``, ``cell % n``, no sentinel) and K6's (``cheb_layers``), against a
  brute cell test over every cell of small grids, -1 and cells beyond the
  grid among them;
- the whole walk emulated over the index (the runs by binary search, the
  tested buckets, K7's tie rule, K6's per-segment sort) against
  ``join_reduce_plain`` and ``join_lattice_plain``, ties across runs
  included;
- ``join_pairs_host`` building one index per window and handing it to
  both kernels, its pairs still the JAX package's.
"""

import numpy as np
import pytest
import torch

from spatialflink_tpu.index import UniformGrid as JGrid
from spatialflink_tpu.models.batches import PointBatch as JPointBatch
from spatialflink_tpu.ops import join as JJ

from spatialflink_tpu_torch.index import UniformGrid
from spatialflink_tpu_torch.index.uniform_grid import NO_LAYER, cheb_layers
from spatialflink_tpu_torch.models import PointBatch
from spatialflink_tpu_torch.ops import join as J

CPU = torch.device("cpu")
MAX_LAYERS = 1 << 29  # K7's clamp (csrc/join_reduce.cu kMaxLayers)

torch.set_num_threads(1)


def _points(x, y, cell, valid):
    """A PointBatch of exactly these points (no padding)."""
    k = len(x)
    return PointBatch(torch.tensor(x, dtype=torch.float32),
                      torch.tensor(y, dtype=torch.float32),
                      torch.zeros(k, dtype=torch.int32),
                      torch.zeros(k, dtype=torch.int32),
                      torch.tensor(cell, dtype=torch.int32),
                      torch.tensor(valid, dtype=torch.bool))


def _random_points(rng, k, n, *, scale=1.0, outside=0.1, drop=0.1):
    """k points on an n x n grid of cell side ``scale`` (cells assigned
    from the coordinates), a share outside it (cell -1), a share invalid,
    a quarter on a coarse lattice (ties)."""
    x = rng.uniform(-0.5, n + 0.5, k) * scale
    y = rng.uniform(-0.5, n + 0.5, k) * scale
    q = k // 4
    x[:q] = np.round(x[:q] * 4) / 4
    y[:q] = np.round(y[:q] * 4) / 4
    cx, cy = np.floor(x / scale).astype(int), np.floor(y / scale).astype(int)
    inside = (cx >= 0) & (cx < n) & (cy >= 0) & (cy < n)
    cell = np.where(inside, cx * n + cy, -1)
    cell[rng.random(k) < outside * 0.2] = -1
    valid = rng.random(k) > drop
    return _points(x, y, cell, valid)


# ------------------------------------------------------------------------ #
# the key and the layout


def test_index_keys_buckets_and_tiles():
    n = 4
    cells = n * n
    cell = [-1, -7, 0, 5, cells - 1, cells, cells + 9, 3, 3, -1]
    valid = [True] * 7 + [False, True, True]
    keys = J.index_keys(torch.tensor(cell, dtype=torch.int32),
                        torch.tensor(valid), n, 4, cells + 3)
    assert keys.dtype == torch.int32
    bucket = [0, 0, 1, 6, cells, cells + 1, cells + 1, cells + 2, 4, 0]
    tile = [i // 4 for i in range(len(cell))]
    assert keys.tolist() == [t * (cells + 3) + b
                             for t, b in zip(tile, bucket)]


def test_index_layout_stride_and_its_limits():
    assert J.index_layout(8192, 100, 4096) == (4096, 2, 10003, 20006)
    assert J.index_layout(256, 100, 4096) == (256, 1, 10003, 10003)
    assert J.index_layout(0, 100, 4096) == (1, 0, 10003, 0)
    big = 32767 * 32767 + 3
    # two tiles of a 32,767-cell grid still fit an int32 key, three do not;
    # neither has a start table (over MAX_STARTS entries)
    assert J.index_layout(2 * 4096, 32767, 4096) == (4096, 2, big, 0)
    assert 2 * big <= 2 ** 31 - 1 < 3 * big
    assert J.index_layout(3 * 4096 + 5, 32767, 4096) == (4096, 4, 0, 0)
    # the start table's cap: 2,048 x 2,048 cells over one tile pass it
    assert J.index_layout(4096, 1024, 4096)[3] == 1024 * 1024 + 3
    assert J.MAX_STARTS < 2048 * 2048 + 3
    assert J.index_layout(4096, 2048, 4096)[3] == 0


@pytest.mark.parametrize("n,nb,tile", [(10, 700, 128), (10, 300, 4096),
                                       (5, 1000, 64), (32767, 3 * 97 + 5, 97)])
def test_plain_index_sections_and_order(n, nb, tile):
    rng = np.random.default_rng(nb + n)
    b = _random_points(rng, nb, n, scale=1.0)
    idx = J.join_index_plain(b, n, tile)
    _, tiles, stride, num_starts = J.index_layout(nb, n, tile)
    assert (stride == 0) == (n == 32767)
    if num_starts:
        # starts[k]: the first sorted position whose key is >= k
        want = [int((idx.key < k).sum()) for k in range(num_starts)]
        assert idx.starts.tolist() == want
    else:
        assert idx.starts is None
    perm = idx.perm.long().numpy()
    assert sorted(perm.tolist()) == list(range(nb))
    assert torch.equal(idx.x, b.x[idx.perm.long()])
    assert torch.equal(idx.y, b.y[idx.perm.long()])
    keys = J.index_keys(b.cell, b.valid, n, idx.tile, stride)
    assert torch.equal(idx.key, keys[idx.perm.long()])
    for t in range(tiles):
        lo, hi = t * idx.tile, min(nb, (t + 1) * idx.tile)
        sec = perm[lo:hi]
        # tile t's own points, keys ascending, b ascending within a key
        assert sorted(sec.tolist()) == list(range(lo, hi))
        k = idx.key[lo:hi].long().numpy()
        order = np.lexsort((sec, k))
        assert (order == np.arange(hi - lo)).all()
    # one stable sort of the int64 key (tile, bucket) gives the same order
    cells = n * n
    t64 = torch.arange(nb) // idx.tile
    k64 = J.index_keys(b.cell, b.valid, n, 1 << 30, 0).long() \
        + t64 * (cells + 3)
    assert torch.equal(idx.perm.long(), torch.argsort(k64, stable=True))


# ------------------------------------------------------------------------ #
# the runs a row visits (csrc/join_walk.cuh), as a plain model


def _grid_runs(acx, acy, layers, n):
    """Inclusive bucket ranges of grid_runs: the columns cx' within the
    layers, each cy in [y0, y1] (bucket = cell + 1); one range for whole
    columns."""
    x0, x1 = max(0, acx - layers), min(n - 1, acx + layers)
    if x0 > x1:
        return []
    y0, y1 = max(0, acy - layers), min(n - 1, acy + layers)
    if y0 == 0 and y1 == n - 1:
        return [(x0 * n + 1, x1 * n + n)]
    return [(c * n + y0 + 1, c * n + y1 + 1) for c in range(x0, x1 + 1)]


def walk_model(cell, layers, n, rule):
    """``(runs, tested)`` of one row in one tile's section: bucket ranges
    walked with no cell test, and buckets walked with it. ``rule``:
    "reduce" (K7) or "lattice" (K6)."""
    cells = n * n
    if rule == "reduce":
        layers = min(layers, MAX_LAYERS)
        acx, acy = cell // n, cell % n
        tested = ([0] if acx - layers <= -1 else []) \
            + ([cells + 1] if acx + layers >= n else [])
        return _grid_runs(acx, acy, layers, n), tested
    if layers >= NO_LAYER:  # kAll: every valid b point
        return [(0, cells + 1)], []
    if cell < 0:
        return [], []
    acx, acy = cell // n, cell % n
    tested = [cells + 1] if acx + layers >= n else []
    return _grid_runs(acx, acy, layers, n), tested


def _bucket(c, n):
    return 0 if c < 0 else (c + 1 if c < n * n else n * n + 1)


def _cell_ok(ca, cb, layers, n, rule):
    """The brute cell test of one pair under each kernel's rule."""
    if rule == "reduce":
        return max(abs(ca // n - cb // n), abs(ca % n - cb % n)) <= layers
    got = cheb_layers(torch.tensor([ca], dtype=torch.int32),
                      torch.tensor([cb], dtype=torch.int32), n)
    return int(got[0]) <= layers


@pytest.mark.parametrize("rule", ["reduce", "lattice"])
@pytest.mark.parametrize("n", [1, 3, 7])
def test_walk_model_is_the_cell_rule(rule, n):
    cells = n * n
    a_cells = list(range(-3, cells + 4)) + [2 * cells + n + 1]
    b_cells = list(range(-3, cells + 5))
    layer_set = [0, 1, 2, n - 1, n, n + 3, MAX_LAYERS, 2 ** 30 - 1]
    if rule == "lattice":
        layer_set.append(NO_LAYER)
    else:
        layer_set += [2 ** 30, 2 ** 31 - 1]
    for layers in layer_set:
        for ca in a_cells:
            runs, tested = walk_model(ca, layers, n, rule)
            for lo, hi in runs:
                # untested runs never hold a bucket outside the grid,
                # unless every cell is admitted
                assert (1 <= lo <= hi <= cells) or layers >= NO_LAYER
            for cb in b_cells:
                k = _bucket(cb, n)
                free = any(lo <= k <= hi for lo, hi in runs)
                checked = k in tested and _cell_ok(ca, cb, layers, n, rule)
                assert (free or checked) == _cell_ok(ca, cb, layers, n,
                                                     rule), \
                    (rule, n, layers, ca, cb, runs, tested)


def test_walk_model_visits_2l_plus_1_runs():
    n = 100
    runs, tested = walk_model(50 * n + 50, 1, n, "reduce")
    assert len(runs) == 3 and tested == []
    runs, _ = walk_model(50 * n + 50, n, n, "lattice")
    assert runs == [(1, n * n)]  # whole columns: one run
    # K7's -1 is (-1, n - 1): the corner cells next to (0, n - 1)
    runs, tested = walk_model(-1, 1, n, "reduce")
    assert runs == [(n - 1, n)] and tested == [0]
    assert walk_model(-1, 1, n, "lattice") == ([], [])


# ------------------------------------------------------------------------ #
# the whole walk over the index, emulated


def _positions(key, lo, hi, base, first, last):
    """Sorted positions [s, e) of buckets first..last of a section."""
    sec = key[lo:hi]
    s = lo + int(np.searchsorted(sec, base + first, side="left"))
    e = lo + int(np.searchsorted(sec, base + last + 1, side="left"))
    return range(s, e)


def _emulate(a, b, radius, layers, n, tile, rule, center=(0.0, 0.0),
             rows=None):
    """K7's outputs (rule "reduce") or K6's pair list (rule "lattice") by
    walking the plain index as the kernels do."""
    idx = J.join_index_plain(b, n, tile)
    key = idx.key.numpy().astype(np.int64)
    perm = idx.perm.numpy()
    sx, sy = idx.x.numpy(), idx.y.numpy()
    bcell = b.cell.numpy()
    ax, ay = a.x.numpy(), a.y.numpy()
    acell, avalid = a.cell.numpy(), a.valid.numpy()
    nb = b.x.shape[0]
    r2 = np.float32(J._r2(radius))
    f = np.float32
    cx, cy = f(J._f32(center[0])), f(J._f32(center[1]))
    tiles = range(0, nb, idx.tile)

    def visit_all(row, t0, base):
        runs, tested = walk_model(int(acell[row]), layers, n, rule)
        hi = min(nb, t0 + idx.tile)
        for first, last in runs:
            yield from _positions(key, t0, hi, base, first, last)
        for bk in tested:
            for k in _positions(key, t0, hi, base, bk, bk):
                if _cell_ok(int(acell[row]), int(bcell[perm[k]]), layers, n,
                            rule):
                    yield k

    if rule == "reduce":
        na = ax.shape[0]
        cnt = np.zeros(na, np.int32)
        best = np.full(na, np.float32(3.4e38), np.float32)
        arg = np.full(na, -1, np.int32)
        for i in range(na):
            if not avalid[i]:
                continue
            for t, t0 in enumerate(tiles):
                for k in visit_all(i, t0, t * idx.stride):
                    dx, dy = f(ax[i] - sx[k]), f(ay[i] - sy[k])
                    d2 = f(f(dx * dx) + f(dy * dy))
                    if d2 <= r2:
                        cnt[i] += 1
                        j = perm[k]
                        if d2 < best[i] or (d2 == best[i] and j < arg[i]):
                            best[i], arg[i] = d2, j
        return cnt, best, arg
    ids = range(ax.shape[0]) if rows is None else rows.tolist()
    out_a, out_b = [], []
    for t, t0 in enumerate(tiles):
        for row in ids:
            if not avalid[row]:
                continue
            a0, a1 = f(ax[row] - cx), f(ay[row] - cy)
            a2 = f(f(a0 * a0) + f(a1 * a1))
            seg = []
            for k in visit_all(row, t0, t * idx.stride):
                b0, b1 = f(sx[k] - cx), f(sy[k] - cy)
                b2 = f(f(b0 * b0) + f(b1 * b1))
                cross = f(f(a0 * b0) + f(a1 * b1))
                if f(f(a2 + b2) - f(f(2.0) * cross)) <= r2:
                    seg.append(int(perm[k]))
            out_a += [row] * len(seg)
            out_b += sorted(seg)
    return np.array(out_a, np.int32), np.array(out_b, np.int32)


def _ties(n):
    """a points on cell corners, b points at the four half-cell offsets of
    each corner (equal d^2 in four different cells), in shuffled b order,
    with points beyond the grid and invalid ones."""
    rng = np.random.default_rng(5)
    corners = [(float(i), float(j)) for i in range(1, n) for j in range(1, n)]
    bx, by = [], []
    for x, y in corners:
        for dx, dy in ((-0.5, 0.0), (0.5, 0.0), (0.0, -0.5), (0.0, 0.5)):
            bx.append(x + dx)
            by.append(y + dy)
    bx, by = np.array(bx + [-0.5, n + 0.25]), np.array(by + [n - 0.5, 1.0])
    order = rng.permutation(bx.shape[0])
    bx, by = bx[order], by[order]

    def cells(x, y):
        cx, cy = np.floor(x).astype(int), np.floor(y).astype(int)
        ok = (cx >= 0) & (cx < n) & (cy >= 0) & (cy < n)
        return np.where(ok, cx * n + cy, -1)

    ax = np.array([c[0] for c in corners] + [-0.25])
    ay = np.array([c[1] for c in corners] + [n - 0.25])
    b = _points(bx, by, cells(bx, by), rng.random(bx.shape[0]) > 0.05)
    a = _points(ax, ay, cells(ax, ay), np.ones(ax.shape[0], bool))
    return a, b


def _cases():
    rng = np.random.default_rng(11)
    n = 6
    a = _random_points(rng, 90, n)
    b = _random_points(rng, 530, n)
    ta, tb = _ties(n)
    # cells beyond the grid (>= n * n) on both sides: no stream assigns
    # them, but both cell rules compare them as cells
    beyond = [c.clone() for c in (a.cell, b.cell)]
    beyond[0][::13] = n * n + torch.arange(0, 90, 13, dtype=torch.int32) % 8
    beyond[1][::11] = n * n + torch.arange(0, 530, 11, dtype=torch.int32) % 8
    return {"random": (a, b, 0.9), "ties": (ta, tb, 0.5),
            "beyond": (a._replace(cell=beyond[0]), b._replace(cell=beyond[1]),
                       0.9)}


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("layers", [0, 1, 6, 9])
@pytest.mark.parametrize("tile", [64, 4096])
def test_emulated_reduce_walk_equals_plain(case, layers, tile):
    a, b, r = CASES[case]
    got = _emulate(a, b, r, layers, 6, tile, "reduce")
    want = J.join_reduce_plain(a, b, r, layers, n=6, tile=tile)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    assert want[0].sum() > 0
    if case == "ties":
        # equal minima in different cells: the smallest b index wins
        assert (got[0] >= 4).sum() > 0


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("layers", [0, 1, 6, NO_LAYER])
@pytest.mark.parametrize("tile,with_rows", [(64, False), (4096, False),
                                            (100, True)])
def test_emulated_lattice_walk_equals_plain(case, layers, tile, with_rows):
    a, b, r = CASES[case]
    rows = None
    if with_rows:
        rows = torch.arange(0, a.x.shape[0], 3, dtype=torch.int32)
    got = _emulate(a, b, r, layers, 6, tile, "lattice", (3.0, 3.0), rows)
    want = J.join_lattice_plain(a, b, r, layers, 3.0, 3.0, n=6, tile=tile,
                                rows=rows)
    np.testing.assert_array_equal(got[0], want[0].numpy())
    np.testing.assert_array_equal(got[1], want[1].numpy())
    assert want[0].numel() > 0


# ------------------------------------------------------------------------ #
# one index per window, both kernels, the JAX package's pairs


@pytest.mark.parametrize("budget", [None, 1])
def test_join_pairs_host_shares_one_index(monkeypatch, budget):
    bbox = (115.5, 117.6, 39.6, 41.1)
    grid, jgrid = UniformGrid(*bbox, num_grid_partitions=30), \
        JGrid(*bbox, num_grid_partitions=30)
    rng = np.random.default_rng(7)
    ax, ay = (np.round(rng.uniform(lo, hi, 300) * 64) / 64
              for lo, hi in ((115.4, 117.7), (39.5, 41.2)))
    bx, by = (np.round(rng.uniform(lo, hi, 4500) * 64) / 64
              for lo, hi in ((115.4, 117.7), (39.5, 41.2)))
    ta = PointBatch.from_arrays(ax, ay, device=CPU, grid=grid)
    tb = PointBatch.from_arrays(bx, by, device=CPU, grid=grid)
    ja = JPointBatch.from_arrays(ax, ay, grid=jgrid)
    jb = JPointBatch.from_arrays(bx, by, grid=jgrid)
    if budget is not None:
        monkeypatch.setattr(JJ, "_LATTICE_BUDGET", budget)
        monkeypatch.setattr(J, "_LATTICE_BUDGET", budget)
    built, seen = [], []
    real_index, real_reduce, real_lattice = (J.join_index, J.join_reduce,
                                             J.join_lattice)

    def index(b, n, tile=J.JOIN_TILE):
        built.append(real_index(b, n, tile))
        return built[-1]

    def reduce(*args, index=None, **kw):
        seen.append(("reduce", index))
        return real_reduce(*args, index=index, **kw)

    def lattice(*args, index=None, **kw):
        seen.append(("lattice", index))
        return real_lattice(*args, index=index, **kw)

    monkeypatch.setattr(J, "join_index", index)
    monkeypatch.setattr(J, "join_reduce", reduce)
    monkeypatch.setattr(J, "join_lattice", lattice)
    r = 0.05
    got = J.join_pairs_host(ta, tb, r, grid)
    parts = list(JJ.join_pairs_host(ja, jb, r, jgrid))
    want = [np.concatenate([p[i] for p in parts]) for i in range(2)]
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[0].size > 0
    assert len(built) == 1
    assert [k for k, _ in seen] == (["lattice"] if budget is None
                                    else ["reduce", "lattice"])
    assert all(ix is built[0] for _, ix in seen)
