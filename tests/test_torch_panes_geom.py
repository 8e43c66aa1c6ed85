"""Pane-incremental sliding windows over polygon and linestring streams on
the CPU: range 16-41 and kNN 66-91 with ``query.panes`` (kNN under the
host merge and the device merge) and multiQuery 21/71, through the
PyTorch port's run_option (device="cpu") against
spatialflink_tpu.driver.run_option with panes, window for window and in
order, on the geometry fixture of tests/test_torch_geom_stream.py, and
against the port's full-window run (range as sets, kNN identical); the
checks are those of tests/test_torch_panes.py.
"""

import pytest
import torch

import test_torch_geom_stream as GS
from test_torch_panes import _check

torch.set_num_threads(1)

GEOM_RANGE, GEOM_KNN = [16, 21, 26, 31, 36, 41], [66, 71, 76, 81, 86, 91]


@pytest.mark.parametrize("option", GEOM_RANGE + GEOM_KNN)
def test_geometry_options_with_panes_match_jax(monkeypatch, option):
    _check(monkeypatch, GS, option, GS.GEOJSON)


@pytest.mark.parametrize("option", [21, 71])
def test_multi_query_with_panes_matches_jax(monkeypatch, option):
    _check(monkeypatch, GS, option, GS.GEOJSON, multi=True)
