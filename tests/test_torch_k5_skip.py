"""K5's exact pair skip on the CPU: the plain versions of its lower bound
(``ops/geom.py`` ``edge_pair_skip_bound``, the box gap of
``hopper_kernels.distance_skip_bound`` where ``orientation_certified``
holds) never exceed the plain f32 ``distances.seg_seg_dist2`` of a pair
whose geometry edge lies in the box, and a certified column has no proper
crossing, checked with hypothesis over the cases where f32 rounding
matters: edges whose ends straddle a binade, near-touching, crossing and
nearly collinear pairs, degenerate and subnormal-length edges, and
coordinates near 116 degrees (the conf's bbox).
"""

import numpy as np
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from spatialflink_tpu_torch.ops import distances as D
from spatialflink_tpu_torch.ops import geom as G
from spatialflink_tpu_torch.ops import hopper_kernels as HK

torch.set_num_threads(1)

BBOX = (115.5, 39.6, 117.6, 41.1)  # the conf's gridBBox
#: boxes where an edge's ends straddle a binade (0, 64, 128), and one
#: around 0 small enough for subnormal differences
BOXES = (BBOX, BBOX, (-1.0, -1.0, 1.0, 1.0), (60.0, 30.0, 70.0, 34.0),
         (120.0, 60.0, 136.0, 68.0), (-1e-19, -1e-19, 1e-19, 1e-19))
KINDS = ("near", "near", "crossing", "touching", "collinear", "collinear",
         "degenerate", "far")


def _f32(v):
    return np.float32(v)


@st.composite
def _pair_case(draw):
    """A query edge b and 1-4 geometry edges, in half the cases all of one
    kind: near b (a few margins off its segment or its ends), crossing it,
    touching it within a few ulps, on b's line beyond its ends (nearly
    collinear, separated), of zero or subnormal length, or anywhere in the
    box.
    Hypothesis picks the box, the kinds and a seed; the values are uniform
    draws of that seed."""
    box = draw(st.sampled_from(BOXES))
    kinds = draw(st.lists(st.sampled_from(KINDS), min_size=1, max_size=4))
    if draw(st.booleans()):
        kinds = [kinds[0]] * len(kinds)
    rng = np.random.default_rng(draw(st.integers(0, 2 ** 32 - 1)))
    span = max(box[2] - box[0], box[3] - box[1])
    margin = HK.distance_skip_margin(max(map(abs, box)))

    def point():
        return (_f32(rng.uniform(box[0], box[2])),
                _f32(rng.uniform(box[1], box[3])))

    def ulps(v, k):
        return _f32(v + _f32(rng.integers(-k, k + 1)) * np.spacing(_f32(v)))

    bx1, by1 = point()
    bx2, by2 = point()
    if rng.random() < 0.2:  # short query edges too
        bx2 = _f32(bx1 + (bx2 - bx1) * 1e-3)
        by2 = _f32(by1 + (by2 - by1) * 1e-3)
    b = np.float32([bx1, by1, bx2, by2])
    edges = []
    for kind in kinds:
        t = rng.random()
        sx, sy = b[0] + t * (b[2] - b[0]), b[1] + t * (b[3] - b[1])
        if kind == "near":
            off = rng.uniform(-1.0, 1.0, 4) * margin * rng.choice([2, 20,
                                                                   2000])
            e = [sx + off[0], sy + off[1], sx + off[2] + span * 1e-4 *
                 rng.normal(), sy + off[3] + span * 1e-4 * rng.normal()]
        elif kind == "crossing":
            nx, ny = -(b[3] - b[1]), b[2] - b[0]
            h = rng.uniform(0.01, 1.0)
            e = [sx + h * nx, sy + h * ny, sx - h * nx, sy - h * ny]
        elif kind == "touching":
            x, y = point()
            e = [ulps(sx, 4), ulps(sy, 4), x, y]
        elif kind == "collinear":
            t1 = rng.uniform(1.0, 4.0) * rng.choice([-1.0, 1.0])
            t2 = t1 + rng.uniform(0.01, 2.0) * np.sign(t1)
            e = [b[0] + t1 * (b[2] - b[0]), b[1] + t1 * (b[3] - b[1]),
                 b[0] + t2 * (b[2] - b[0]), b[1] + t2 * (b[3] - b[1])]
            e = [ulps(v, 2) for v in e]
        elif kind == "degenerate":
            x, y = point()
            tiny = rng.choice([0.0, 1e-40, 1e-44, float(np.spacing(x))])
            e = [x, y, x + tiny, y + tiny * rng.choice([0.0, 1.0])]
        else:
            e = [*point(), *point()]
        edges.append(np.float32(e))
    return b, np.stack(edges)


def _min4(a, b):
    """seg_seg_dist2 without its crossing test: the min of the four
    point-segment terms."""
    def ps(p, s):
        return D.point_segment_dist2(p[..., 0], p[..., 1], s[..., 0],
                                     s[..., 1], s[..., 2], s[..., 3])
    return torch.minimum(
        torch.minimum(ps(a[..., 0:2], b), ps(a[..., 2:4], b)),
        torch.minimum(ps(b[..., 0:2], a), ps(b[..., 2:4], a)))


def _box(a):
    xs, ys = a[:, 0::2], a[:, 1::2]
    return xs.min(), xs.max(), ys.min(), ys.max()


@settings(max_examples=1500, deadline=None)
@given(_pair_case())
def test_edge_pair_skip_bound_never_exceeds_seg_seg_dist2(case):
    """K5 skips the column of query edge b for a geometry when this bound
    exceeds the running min; the plain f32 seg_seg_dist2 of every pair of
    the column is at least the bound, so the min would have stayed."""
    b_np, a_np = case
    a, b = torch.from_numpy(a_np), torch.from_numpy(b_np)
    d2 = D.seg_seg_dist2(a, b[None])
    bound = G.edge_pair_skip_bound(_box(a), b)
    assert float(bound) <= float(d2.min()), (b_np, a_np)
    # a certified column has no proper crossing
    if bool(G.orientation_certified(_box(a), b)):
        assert not bool(D.segments_intersect(a, b[None]).any()), (b_np, a_np)
    # the pair bound of a folded column: each edge's own box against b's
    for i in range(a.shape[0]):
        lb = HK.distance_skip_bound(*_box(a[i:i + 1]), b)
        assert float(lb) <= float(_min4(a[i], b)), (b_np, a_np, i)


def test_orientation_certificate_examples():
    """A box wholly on one side of the line certifies, on either side; a
    box the line crosses does not, nor one on the line's far extension
    (nearly collinear), nor a degenerate query edge."""
    b = torch.tensor([116.0, 40.0, 116.5, 40.5])
    above = (torch.tensor(116.0), torch.tensor(116.1), torch.tensor(40.3),
             torch.tensor(40.4))
    below = (torch.tensor(116.3), torch.tensor(116.4), torch.tensor(40.0),
             torch.tensor(40.1))
    across = (torch.tensor(116.2), torch.tensor(116.3), torch.tensor(40.2),
              torch.tensor(40.3))
    beyond = (torch.tensor(117.0), torch.tensor(117.0), torch.tensor(41.0),
              torch.tensor(41.0))
    assert bool(G.orientation_certified(above, b))
    assert bool(G.orientation_certified(below, b))
    assert not bool(G.orientation_certified(across, b))
    assert not bool(G.orientation_certified(beyond, b))
    point = torch.tensor([116.0, 40.0, 116.0, 40.0])
    assert not bool(G.orientation_certified(above, point))


def test_skip_bound_bites_at_the_main_path_shapes():
    """At the chip phase's shapes (a polygon of 0.002-0.02 degrees against
    the edges of a 64-edge ring of radius 0.35 near 116, 40.5) the bound
    is positive for all but the few ring edges near the polygon, and 0
    only where the certificate fails; no bound exceeds the pair values."""
    th = np.linspace(0.0, 2.0 * np.pi, 65)
    ring = np.stack([116.6 + 0.35 * np.cos(th), 40.55 + 0.35 * np.sin(th)],
                    axis=1).astype(np.float32)
    q = torch.from_numpy(np.concatenate([ring[:-1], ring[1:]], axis=1))
    ph = np.sort(np.random.default_rng(3).uniform(0, 2 * np.pi, 12))
    poly = np.stack([116.98 + 0.01 * np.cos(ph), 40.55 + 0.01 * np.sin(ph)],
                    axis=1).astype(np.float32)
    g = torch.from_numpy(np.concatenate([poly, np.roll(poly, -1, 0)], 1))
    bound = G.edge_pair_skip_bound(_box(g), q)
    d2 = D.seg_seg_dist2(g[:, None], q[None])
    assert (bound <= d2.amin(dim=0)).all()
    assert int((bound > d2.min()).sum()) >= 58
    cert = G.orientation_certified(_box(g), q)
    assert bool(((bound > 0) == cert).all())
