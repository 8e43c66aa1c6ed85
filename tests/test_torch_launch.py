"""Launch-side pieces of K4x and K2 that run on the CPU: the cell order's
plain version (against numpy's stable argsort), the distance-skip margin
of K4x (the plain f32 distance never falls below the margin-reduced box
bound, checked with hypothesis), the wrappers' argument checks for the
launch signatures, and the reader of the kernels' ``-Xptxas -v`` report.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from spatialflink_tpu_torch.ops import distances as D
from spatialflink_tpu_torch.ops import hopper_kernels as HK
from spatialflink_tpu_torch.ops import knn as K
from spatialflink_tpu_torch.ops import native

BBOX = (115.5, 39.6, 117.6, 41.1)  # the conf's gridBBox
#: boxes where an edge's ends straddle a binade (0, 64, 128): there
#: cx = x2 - x1 rounds, and the computed projection can leave the edge's box
STRADDLE = ((-1.0, -1.0, 1.0, 1.0), (60.0, 30.0, 70.0, 34.0),
            (120.0, 60.0, 136.0, 68.0))


@pytest.mark.parametrize("num_cells", [1, 100, 10_000])
def test_cell_order_plain_is_a_stable_argsort(num_cells):
    rng = np.random.default_rng(num_cells)
    n = 5_000
    cell = rng.integers(-2, num_cells + 3, n).astype(np.int32)
    cell[::7] = -1
    cell[100:180] = min(3, num_cells - 1)  # a run of one cell
    px = rng.uniform(0, 1, n).astype(np.float32)
    py = rng.uniform(0, 1, n).astype(np.float32)
    key = np.where((cell >= 0) & (cell < num_cells), cell, num_cells)
    want = np.argsort(key, kind="stable")
    perm, sx, sy = HK.cell_order(torch.from_numpy(cell), num_cells,
                                 torch.from_numpy(px), torch.from_numpy(py))
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), want)
    np.testing.assert_array_equal(sx.numpy(), px[want])
    np.testing.assert_array_equal(sy.numpy(), py[want])
    # -1 and out-of-grid cells last, in input order
    tail = (cell < 0) | (cell >= num_cells)
    np.testing.assert_array_equal(perm.numpy()[n - tail.sum():],
                                  np.flatnonzero(tail))


def test_distance_skip_margin_scale():
    assert HK.distance_skip_margin(1.0) == 2.0 ** -19
    m = HK.distance_skip_margin(117.6)
    ulp = float(np.spacing(np.float32(117.6)))
    assert 16 * ulp < m < 64 * ulp  # a few ulps of the largest coordinate


@st.composite
def _edge_and_points(draw):
    """An edge at the conf's coordinates or straddling a binade (any,
    near-degenerate, or axis parallel) and 4 points: on the segment, a few
    ulps off it, just beyond an end, or near its box at distances of a few
    margins. Hypothesis picks the kinds and a seed; the values are uniform
    draws of that seed (hypothesis' own numbers favour round values, whose
    differences are exact)."""
    box = draw(st.sampled_from((BBOX, BBOX) + STRADDLE))
    kind = draw(st.sampled_from(["any", "ulps", "vertical", "horizontal",
                                 "horizontal"]))
    hows = draw(st.lists(st.sampled_from(["segment", "box", "far", "end",
                                          "end"]), min_size=4, max_size=4))
    rng = np.random.default_rng(draw(st.integers(0, 2 ** 32 - 1)))

    def f32(*v):
        return np.float32(v) if len(v) > 1 else np.float32(v[0])

    x1, y1 = f32(rng.uniform(box[0], box[2])), f32(rng.uniform(box[1],
                                                                box[3]))
    x2, y2 = f32(rng.uniform(box[0], box[2])), f32(rng.uniform(box[1],
                                                                box[3]))
    if kind == "ulps":
        x2 = x1 + f32(rng.integers(-3, 4)) * np.spacing(x1)
        y2 = y1 + f32(rng.integers(-3, 4)) * np.spacing(y1)
    elif kind == "vertical":
        x2 = x1
    elif kind == "horizontal":
        y2 = y1
    e = f32(x1, y1, x2, y2)
    margin = HK.distance_skip_margin(max(map(abs, box)))
    pts = []
    for how in hows:
        t = f32(rng.random())
        sx = e[0] + t * (e[2] - e[0])
        sy = e[1] + t * (e[3] - e[1])
        if how == "segment":
            px = sx + f32(rng.integers(-4, 5)) * np.spacing(sx)
            py = sy + f32(rng.integers(-4, 5)) * np.spacing(sy)
        elif how == "end":  # just beyond an end, where t clamps to 0 or 1
            end = rng.choice([0, 2, 2])
            away = np.sign(e[end] - e[2 - end])
            px = e[end] + f32(rng.integers(0, 65) * away) * np.spacing(e[end])
            py = e[end + 1] + f32(rng.choice([0, 0, 0, -1, 1, 2])) * \
                np.spacing(e[end + 1])
        else:
            scale = margin * (8.0 if how == "box" else 2_000.0)
            dx, dy = rng.uniform(-1.0, 1.0, 2) * scale
            corner_x = max(e[0], e[2]) if dx > 0 else min(e[0], e[2])
            corner_y = max(e[1], e[3]) if dy > 0 else min(e[1], e[3])
            px = (corner_x if rng.random() < 0.5 else sx) + dx
            py = (corner_y if rng.random() < 0.5 else sy) + dy
        pts.append((f32(px), f32(py)))
    return e, np.float32(pts)


@settings(max_examples=1000, deadline=None)
@given(_edge_and_points())
def test_distance_skip_bound_never_exceeds_the_f32_distance(case):
    """K4x skips the edge for a lane holding these points when the bound
    exceeds the lane's largest min d2; the plain f32 formula's d2 of every
    point is at least the bound, so min(mind2, d2) would have kept mind2."""
    e, pts = case
    px, py = torch.from_numpy(pts[:, 0]), torch.from_numpy(pts[:, 1])
    edge = torch.from_numpy(e)
    d2 = D.point_segment_dist2(px, py, edge[0], edge[1], edge[2], edge[3])
    for sel in ([0], [1], [2], [3], [0, 1, 2, 3]):
        bound = HK.distance_skip_bound(px[sel].min(), px[sel].max(),
                                       py[sel].min(), py[sel].max(), edge)
        assert float(bound) <= float(d2[sel].min()), (e, pts, sel)


def _lattice_args(n=8, g=2, e=4):
    return (torch.zeros(n), torch.zeros(n), torch.zeros((g, e, 4)),
            torch.ones((g, e), dtype=torch.bool),
            torch.ones(g, dtype=torch.bool))


def test_lattice_argument_checks():
    args = _lattice_args()
    cell = torch.zeros(8, dtype=torch.int32)
    HK._check_lattice_args(*args, cell, 100)  # accepted
    HK._check_lattice_args(*args)  # no cell: stream order
    with pytest.raises(TypeError, match="int32"):
        HK._check_lattice_args(*args, cell.long(), 100)
    with pytest.raises(ValueError, match="equal 1-D"):
        HK._check_lattice_args(*args, cell[:5], 100)
    with pytest.raises(ValueError, match="num_cells"):
        HK._check_lattice_args(*args, cell, 0)
    with pytest.raises(ValueError, match="contiguous"):
        HK._check_lattice_args(*args, torch.zeros(16, dtype=torch.int32)[::2],
                               100)
    with pytest.raises(ValueError, match="edge_mask"):
        HK._check_lattice_args(*args[:3], args[3][:, :2], args[4], cell, 100)
    with pytest.raises(TypeError, match="float32"):
        HK._check_lattice_args(args[0].double(), *args[1:])


def test_lattice_on_cpu_is_the_plain_version_in_either_order():
    rng = np.random.default_rng(2)
    px = torch.from_numpy(rng.uniform(0, 10, 300).astype(np.float32))
    py = torch.from_numpy(rng.uniform(0, 10, 300).astype(np.float32))
    edges = torch.tensor([[[2., 2., 6., 2.], [6., 2., 6., 6.], [6., 6., 2., 6.],
                           [2., 6., 2., 2.]]])
    mask = torch.ones((1, 4), dtype=torch.bool)
    areal = torch.ones(1, dtype=torch.bool)
    cell = torch.from_numpy(rng.integers(-1, 100, 300).astype(np.int32))
    want = HK.pip_lattice_plain(px, py, edges, mask, areal).T
    assert torch.equal(HK.pip_lattice(px, py, edges, mask, areal), want)
    assert torch.equal(HK.pip_lattice(px, py, edges, mask, areal, cell=cell,
                                      num_cells=100), want)


def _knn_tensors(n=16, q=3):
    return dict(x=torch.zeros(n), y=torch.zeros(n),
                cell=torch.zeros(n, dtype=torch.int32),
                valid=torch.ones(n, dtype=torch.bool), qx=torch.zeros(q),
                qy=torch.zeros(q), q_cell=torch.zeros(q, dtype=torch.int32))


def test_knn_launch_argument_checks():
    oid = torch.zeros(16, dtype=torch.int32)
    t = _knn_tensors()
    n, q, cells, ptrs = K._launch_args(oid, mode=K.MODE_POINT, **t)
    assert (n, q, cells) == (16, 3, 0)
    assert ptrs["dists"] is None and ptrs["x"] == t["x"].data_ptr()
    with pytest.raises(ValueError, match="qx is required"):
        K._launch_args(oid, mode=K.MODE_POINT, **dict(t, qx=None))
    with pytest.raises(TypeError, match="q_cell"):
        K._launch_args(oid, mode=K.MODE_POINT,
                       **dict(t, q_cell=t["q_cell"].long()))
    with pytest.raises(ValueError, match="shape"):
        K._launch_args(oid, mode=K.MODE_POINT, **dict(t, qy=torch.zeros(2)))
    with pytest.raises(ValueError, match="unknown mode"):
        K._launch_args(oid, mode=7, **t)
    d = torch.zeros((3, 16))
    nb = torch.ones((3, 100), dtype=torch.bool)
    n, q, cells, _ = K._launch_args(oid, mode=K.MODE_CELLS, cell=t["cell"],
                                    valid=t["valid"], dists=d, nb_mask=nb)
    assert (n, q, cells) == (16, 3, 100)
    with pytest.raises(ValueError, match="nb_mask is required"):
        K._launch_args(oid, mode=K.MODE_CELLS, cell=t["cell"],
                       valid=t["valid"], dists=d)
    with pytest.raises(ValueError, match="contiguous"):
        K._launch_args(oid, mode=K.MODE_ELIGIBLE, dists=d.T.contiguous().T,
                       eligible=torch.ones((3, 16), dtype=torch.bool))
    with pytest.raises(ValueError, match="at least one query"):
        K._launch_args(oid, mode=K.MODE_ELIGIBLE, dists=torch.zeros((0, 16)),
                       eligible=torch.ones((0, 16), dtype=torch.bool))
    with pytest.raises(ValueError, match="needs cuda"):
        K.knn_topk(oid, mode=K.MODE_POINT, k=5, num_ids=1, **t)


def test_ptxas_report_reads_registers_smem_and_spills():
    log = (
        "ptxas info    : 0 bytes gmem\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_118pip_lattice_kernelILb1EEEvPKfS2_PKiiS2_PKhiS6_iff'"
        " for 'sm_90a'\n"
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_118pip_lattice_kernelILb1EEEvPKfS2_PKiiS2_PKhiS6_iff\n"
        "    0 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 56 registers, used 1 barriers, 26640 bytes smem,"
        " 440 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_115knn_pick_kernelEPKjiiPiiPyS3_S2_PfPh' for 'sm_90a'\n"
        "ptxas info    : Function properties for "
        "_ZN12_GLOBAL__N_115knn_pick_kernelEPKjiiPiiPyS3_S2_PfPh\n"
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 32 registers, used 1 barriers, 8 bytes cumulative"
        " stack size, 24724 bytes smem, 432 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z17order_scan_kerneliPi'"
        " for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z17order_scan_kerneliPi\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 18 registers, 132 bytes smem\n")
    rows = native.ptxas_report(log)
    assert rows == [
        {"kernel": "pip_lattice_kernel<true>",
         "registers": 56, "smem_bytes": 26640, "spill_stores": 8,
         "spill_loads": 12},
        {"kernel": "knn_pick_kernel", "registers": 32, "smem_bytes": 24724,
         "spill_stores": 4, "spill_loads": 4},
        {"kernel": "order_scan_kernel", "registers": 18,
         "smem_bytes": 132, "spill_stores": 0, "spill_loads": 0}]
    assert native.ptxas_report("") == []


def test_kernel_names_carry_integer_template_arguments():
    """K5's kernels are templates over the lanes per geometry and the kind
    of launch: the report names each instantiation."""
    log = "".join(
        "ptxas info    : Compiling entry function "
        f"'_ZN12_GLOBAL__N_116geom_dist_kernelILi{w}ELi{k}EEEvNS_4ArgsE'"
        " for 'sm_90a'\n"
        "ptxas info    : Used 40 registers, 1584 bytes smem\n"
        for w, k in ((8, 0), (32, 2)))
    assert [r["kernel"] for r in native.ptxas_report(log)] == [
        "geom_dist_kernel<8, 0>", "geom_dist_kernel<32, 2>"]
    assert native._template_args("ILin3ELb0EE") == "<-3, false>"
