"""K6's flat arm as device code on the 1-D solutions K6 carries at element
size 2, emulated as tests/test_torch_flat_emulation.py says, against the
plain version: to the bit, but test_func_1d's math functions (an ulp of
libm against PyTorch's flips a bfloat16 rounding: 3e-2, as
tests/test_torch_flat_host.py says)."""

import pytest

from test_torch_flat_emulation import check_flat_arm
from test_torch_flat_host import FLAT_1D


@pytest.mark.parametrize("name", FLAT_1D)
def test_flat_arm_emulated_matches_plain(name, tmp_path):
    check_flat_arm(name, 2, tmp_path)
