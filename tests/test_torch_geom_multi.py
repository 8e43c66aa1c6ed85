"""The multiQuery form of every polygon/linestring range and kNN option
(16-42, 66-92) on the CPU, the four that tests/test_torch_geom_stream.py
covers (16, 21, 66, 71) aside: the port's run_option (device="cpu") with
``query.multiQuery`` against spatialflink_tpu.driver.run_option on the
same seeded 200-geometry GeoJSON fixture, with 3 query points, 2 query
polygons and the conf's linestring. Per query, window for window: the
selections identical, kNN (objID, distance) lists in order with distances
within 1e-6 relative, and the pruning counters equal. (A separate file so
that the test workers run it beside tests/test_torch_geom_stream.py.)"""

import pytest

from test_torch_geom_stream import KNN, RANGE, assert_windows_equal, run_both

COVERED = (16, 21, 66, 71)


@pytest.mark.parametrize("option", [o for o in RANGE + KNN
                                    if o not in COVERED])
def test_multi_query_form_matches_jax(monkeypatch, option):
    got, want, counts, jcounts = run_both(monkeypatch, option, multi=True)
    assert all(w[2]["queries"] >= 1 for w in want)
    assert_windows_equal(got, want, option > 50)
    assert counts == jcounts
