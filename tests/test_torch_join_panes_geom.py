"""The pane join of the geometry options on the CPU against the JAX
package (the checks of test_torch_join_panes.py, split off to keep each
file short under parallel workers): 106 point x polygon (K4x rows) and
121 polygon x polygon (K5), with the block-coalescing threshold pinned at
0 and at 2**24 in both packages.
"""

import pytest
import torch

from test_torch_join_panes import ALL_BLOCKS, ALL_COALESCED, check_pane_join

torch.set_num_threads(1)


@pytest.mark.parametrize("cells", [ALL_BLOCKS, ALL_COALESCED])
@pytest.mark.parametrize("option", [106, 121])
def test_pane_join_matches_jax(monkeypatch, option, cells):
    check_pane_join(monkeypatch, option, cells)
