"""K6's rewrite arm against ``yask_tpu``: the solutions it opens, whose
vars a later stage rewrites (AWP's free-surface stresses, the
sub-domain boundary overrides of test_boundary_*), run ``-mode fused``
(the plain version on CPU tensors) against ``yask_tpu``'s ``-mode
pallas`` in interpret mode, as tests/test_pallas.py:115-140 runs it.
Tolerance and set-up as in tests/test_torch_scratch.py, whose helper this
file shares.  The awp family runs one K each (2 where the reference's
pallas engages its skew carry); its elastic variants are in
tests/test_torch_rewrite_elastic.py, which keeps each file under a
minute."""

import pytest

from test_torch_scratch import fused_vs_pallas


@pytest.mark.parametrize("name,K", [
    ("awp", 2), ("awp_abc", 1),
    ("test_boundary_1d", 1), ("test_boundary_1d", 2),
    ("test_boundary_2d", 1), ("test_boundary_2d", 2),
    ("test_boundary_3d", 1), ("test_boundary_3d", 2)])
def test_rewrite_families_fused_match_yask_tpu_pallas(name, K):
    fused_vs_pallas(name, None, K)
