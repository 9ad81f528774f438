"""K4 on the rewrite arm (awp) and on a merged pipeline (the RTM chain)
against ``yask_tpu``'s forced trapezoid in interpret mode, as
tests/test_torch_k4_arms.py runs the other arms: the same seeded state
through both packages, one K-step group and a remainder, tolerance
``field_epsilon=1e-4``.
"""

import numpy as np

from yask_tpu_torch.transfer import export_interiors, import_interiors

from test_torch_k4_arms import FEPS, seeded_physical
from test_torch_lowering import mismatches, tpu_import
from test_torch_pipeline import observable, port_pipe, tpu_pipe
from test_torch_stencils import tpu_interiors
from test_torch_trapezoid import (port_ctx, tpu_ctx,  # noqa: F401
                                  tpu_forced_trapezoid)


def test_awp_k4_matches_yask_tpu_interpret(tpu_forced_trapezoid):
    """awp's four stages, two of which a later one rewrites."""
    mine = port_ctx("awp", None, 24, "fused", 2, "-trapezoid", forced=True)
    theirs = tpu_ctx("awp", None, 24, "pallas", 2)
    state = seeded_physical(mine, 3)
    import_interiors(mine, state)
    tpu_import(theirs, state)
    mine.run_solution(0, 2)
    theirs.run_solution(0, 2)
    a, b = export_interiors(mine), tpu_interiors(theirs)
    assert all(np.isfinite(x).all() for s in a.values() for x in s)
    assert mismatches(a, b, field_epsilon=FEPS) == 0
    assert mine.get_stats().get_tiling()["sub_stages"] == 4
    assert theirs.get_stats().get_tiling()["trapezoid"] is True


def test_rtm_chain_k4_matches_yask_tpu_interpret(tpu_forced_trapezoid):
    """The merged RTM chain (3 stages) through K4: the port forces its
    request on the merged context before the first run (its pads were
    planned by ``-trapezoid``)."""
    g, steps = (32, 32, 14), 5
    mine = port_pipe("-mode fused -wf_steps 2 -trapezoid -no-skew", fuse=True,
                     g=g)
    ctx = mine.fused_ctx
    ctx._trapezoid_arg = lambda: True
    theirs = tpu_pipe("-mode pallas -wf_steps 2 -trapezoid", fuse=True, g=g)
    mine.run(0, steps - 1)
    theirs.run(0, steps - 1)
    assert ctx._trapezoid_kernel() is not None
    assert ctx._trapezoid_kernel().spec.stages == 3
    a, b = observable(mine), observable(theirs)
    assert set(a) == set(b) and "smooth.smooth" in a
    assert mismatches(a, b, field_epsilon=FEPS) == 0
