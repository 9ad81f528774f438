"""K6's flat arm as device code on the 1-D solutions K6 carries (a tile of
4096 points along the one dim), emulated as
tests/test_torch_flat_emulation.py says (solo at 1, 2 and every tile's
resident blocks, K5 over a box, K7 over 3 padded members), against the
plain version: to the bit, but test_func_1d's math functions (libm
against PyTorch's, rtol 1e-5, atol 1e-6)."""

import pytest

from test_torch_flat_emulation import check_flat_arm
from test_torch_flat_host import FLAT_1D


@pytest.mark.parametrize("name", FLAT_1D)
def test_flat_arm_emulated_matches_plain(name, tmp_path):
    check_flat_arm(name, 4, tmp_path)
