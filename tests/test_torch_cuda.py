"""K4 and K1 against their plain PyTorch versions on the card, bit for bit.

The CUDA kernels have no CPU mode, so these tests skip without a card.
This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed: on the card, ``python -m pytest --noconftest
tests/test_torch_cuda.py`` (``--noconftest`` skips tests/conftest.py, which
sets up JAX).
"""

import numpy as np
import pytest
import torch

from spatialflink_tpu_torch.index import UniformGrid
from spatialflink_tpu_torch.models import (LineString, PointBatch, Polygon,
                                            single_query_edges)
from spatialflink_tpu_torch.ops import hopper_kernels as HK
from spatialflink_tpu_torch.ops import range as R


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _ring(n_vert, r=3.0):
    th = np.linspace(0, 2 * np.pi, n_vert, endpoint=False)
    ring = [(5 + r * float(np.cos(t)), 5 + r * float(np.sin(t))) for t in th]
    return ring + [ring[0]]


GEOMS = {
    "polygon": lambda: Polygon.create([[(2, 2), (6, 2), (6, 6), (2, 6)]]),
    "hole": lambda: Polygon.create([[(1, 1), (8, 1), (8, 8), (1, 8)],
                                    [(3, 3), (5, 3), (5, 5)]]),
    "linestring": lambda: LineString.create([(0.5, 0.5), (4, 7), (9, 3)]),
    "chunk512": lambda: Polygon.create([_ring(512)]),
    "chunk513": lambda: Polygon.create([_ring(513)]),
    "large": lambda: Polygon.create([_ring(1301, 3.5)]),
}


def _batch(dev, n=5000, seed=21):
    grid = UniformGrid(0.0, 10.0, 0.0, 10.0, num_grid_partitions=10)
    rng = np.random.default_rng(seed)
    return grid, PointBatch.from_arrays(rng.uniform(-1, 11, n),
                                        rng.uniform(-1, 11, n), device=dev,
                                        grid=grid)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GEOMS) + ["empty"])
def test_pip_dist_kernel_equals_plain(card, case):
    _, b = _batch(card)
    if case == "empty":
        e = torch.zeros((0, 4), device=card)
        m = torch.zeros(0, dtype=torch.bool, device=card)
        areal = True
    else:
        geom = GEOMS[case]()
        e, m = (torch.from_numpy(a).to(card) for a in single_query_edges(geom))
        areal = isinstance(geom, Polygon)
    launches = HK.pip_dist.launches
    got = HK.pip_dist(b.x, b.y, e, m, areal)
    assert HK.pip_dist.launches == launches + 1
    assert torch.equal(got, HK.pip_dist_plain(b.x, b.y, e, m, areal))


@pytest.mark.cuda
@pytest.mark.parametrize("approximate", [False, True])
def test_range_mask_kernel_equals_plain(card, approximate):
    grid, b = _batch(card)
    args = (b, 5.2, 4.7, int(grid.assign_cell(5.2, 4.7)[0]), 2.0,
            grid.guaranteed_layers(2.0), grid.candidate_layers(2.0))
    launches = R.range_mask_stats.launches
    got = R.range_filter_point_stats(*args, n=grid.n, approximate=approximate)
    want = R.range_filter_point_stats_plain(*args, n=grid.n,
                                            approximate=approximate)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    cells = [44, 45, 54]
    gn = torch.from_numpy(grid.guaranteed_cells_mask(1.7, cells)).to(card)
    cn = torch.from_numpy(grid.candidate_cells_mask(1.7, cells)).to(card)
    got = R.range_filter_masks_stats(b, gn, cn, got[1], 1.7,
                                     approximate=approximate)
    want = R.range_filter_masks_stats_plain(b, gn, cn, want[1], 1.7,
                                            approximate=approximate)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert R.range_mask_stats.launches == launches + 2
