"""K6's rewrite arm on AWP's elastic variants (no memory vars) against
``yask_tpu``'s ``-mode pallas`` in interpret mode: the rest of
tests/test_torch_rewrite.py's sweep (set-up and tolerance there)."""

import pytest

from test_torch_scratch import fused_vs_pallas


@pytest.mark.parametrize("name,K", [("awp_elastic", 2),
                                    ("awp_elastic_abc", 1)])
def test_rewrite_families_fused_match_yask_tpu_pallas(name, K):
    fused_vs_pallas(name, None, K)
