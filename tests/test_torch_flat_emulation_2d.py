"""K6's flat arm as device code: the last three 2-D solutions K6 carries
(test_misc_value_2d, test_scratch_2d, test_stages_2d) at element size 4,
emulated as tests/test_torch_flat_emulation.py says (solo at 1, 2 and
every tile's resident blocks, K5 over a box, K7 over 3 padded members),
against the plain version to the bit."""

import pytest

from test_torch_flat_emulation import check_flat_arm
from test_torch_flat_host import FLAT_2D


@pytest.mark.parametrize("name", FLAT_2D[4:])
def test_flat_arm_emulated_matches_plain(name, tmp_path):
    check_flat_arm(name, 4, tmp_path)
