"""K5's C entry point (``<name>_region``) on every arm, built for the host
with g++: ``host_step`` (K1's body) and ``host_stages`` (K6's) run over
the box with the tables moved to its origin, through the same
``call_region_entry`` marshalling the card uses.

Each arm on a shard that has an inner shard face on one side of each
sharded dim and the global edge on the other, from a random state whose
pads hold nonzero ghost values past the inner faces (zero past the
global edge, as a run's are), one group's sub-steps over their full
boxes (the interior grown by the step's reach per later sub-step, reaching
into the pads) and then a ragged box: against ``plain_shard_step`` (each
stage over its grown box, masked to the global domain), bit-equal over
whole tensors; tti by rtol 1e-5 and atol 1e-6 (g++'s libm ``sinf`` and
``cosf`` against PyTorch's, as in tests/test_torch_k7_host.py).
"""

import numpy as np
import pytest

from yask_tpu_torch.ops import fused_stencil
from yask_tpu_torch.parallel.shard_step import _full_box, shard_pallas_plan

from test_torch_fused import host_kernel
from test_torch_k5_arms import CASES, port_ctx

#: per arm: a shard_pallas case of tests/test_torch_k5_arms.py, its sizes
#: here (several blocks per tiled slot, a partial last one) and the mesh
#: position of the shard under test
ARMS = {"scratch-tti": ("tti-K2-x2y2", "-g_x 18 -g_y 18 -g_z 70",
                        {"x": 1, "y": 0}),
        "stages-ssg": ("ssg-K2", "-g_x 18 -g_y 18 -g_z 70",
                       {"x": 0, "y": 1}),
        "rewrite-awp": ("awp-x2", "-g_x 14 -g_y 9 -g_z 70", {"x": 1}),
        "scratch-swe2d": ("swe2d-K2", "-g_x 18 -g_y 70", {"x": 1}),
        "boundary-test_boundary_3d": ("test_boundary_3d",
                                      "-g_x 18 -g_y 18 -g_z 70",
                                      {"x": 1, "y": 0}),
        "misc-gaussian": ("gaussian-x2", "-g_x 26 -g_y 70", {"x": 0}),
        "misc-test_misc_2d": ("test_misc_2d-x2", "-g_x 18 -g_y 70",
                              {"x": 1}),
        "partial-partial_written": ("partial_written-x2",
                                    "-g_x 18 -g_y 9 -g_z 70", {"x": 1}),
        "bf16-iso3dfd": ("iso3dfd_bf16-K2", "-g_x 18 -g_y 18 -g_z 70",
                         {"x": 1, "y": 0}),
        "4d-test_4d": ("test_4d-w2", "-g_w 12 -g_x 9 -g_y 11 -g_z 70",
                       {"w": 1})}
#: (rtol, atol) against the plain version: 0 but for tti's libm calls
PLAIN_TOL = {"scratch-tti": (1e-5, 1e-6)}


def shard_of(arm: str):
    """The arm's shard_pallas plan and the shard under test: (kernel,
    its global origin, the group's full boxes, the step count K)."""
    case, sizes, pos = ARMS[arm]
    ctx = port_ctx(case, "shard_pallas", sizes)
    sp = shard_pallas_plan(ctx)
    mesh = sp.layout.mesh
    at = {d: pos.get(d, 0) for d in ctx.get_domain_dim_names()}
    off = sp.layout.offsets[mesh.index(at)]
    return sp.kernel, off, [_full_box(sp, sp.K, s) for s in range(sp.K)]


def random_state(kern, off, seed: int):
    """Random values over every padded array, zeroed outside the global
    domain (a shard's pads there stay zero in a run)."""
    import torch
    from yask_tpu_torch.compiler.lowering import torch_dtype
    prog = fused_stencil._with_offset(kern.program, off,
                                      torch.device("cpu"))
    rng = np.random.RandomState(seed)
    state = {}
    for n, g in prog.geoms.items():
        if g.is_scratch:
            continue
        state[n] = [fused_stencil._zero_outside_global(
            prog, n, torch.tensor(np.asarray(rng.rand(*g.shape),
                                             np.float32)).to(
                torch_dtype(prog.dtype))) for _ in range(g.num_slots)]
    return state


def ragged(box, n_of):
    """A box past the pads' edge on the low side and short of the
    interior's on the high side, in every dim the group grows (it holds
    the shard's index 0, where a partial-dim output is stored)."""
    return {d: ((lo - 1, n_of[d] - 1) if lo < 0 else (lo, hi))
            for d, (lo, hi) in box.items()}


def k5_steps(fn, kern, off, boxes, seed: int = 3, tol=(0.0, 0.0)):
    """The boxes in turn as sub-steps 0, 1, ... through ``fn`` (the g++
    host entry or the emulated device code) and through
    ``plain_shard_step``, each output held to the plain version's."""
    import torch
    prog, spec = kern.program, kern.spec
    got = want = random_state(kern, off, seed)
    for t, box in enumerate(boxes):
        fused_stencil.check_box(prog, spec, box)
        ins = [got[n][k] for n, k in spec.inputs]
        outs = [got[n][0].clone() if n in spec.base_outputs
                else torch.zeros_like(got[n][0]) for n in spec.outputs]
        assert fused_stencil.call_region_entry(fn, prog, spec, ins, outs,
                                               box, off, t, None) == 0
        got = fused_stencil._rotated(prog, spec, got, outs)
        want = fused_stencil.plain_shard_step(kern, want, t, box, off)
        for n in spec.outputs:
            a, b = got[n][-1].float(), want[n][-1].float()
            assert a.abs().max() > 0, f"{n}: the box wrote nothing"
            torch.testing.assert_close(a, b, rtol=tol[0], atol=tol[1],
                                       equal_nan=False)


def group_boxes(kern, boxes):
    n_of = {d: kern.program.sizes[d] for d in kern.program.ana.domain_dims}
    return boxes + [ragged(boxes[0], n_of)]


@pytest.mark.parametrize("arm", list(ARMS))
def test_k5_host_entry_matches_plain_shard_step(arm, tmp_path):
    kern, off, boxes = shard_of(arm)
    assert kern.spec.stages == 1 or CASES[ARMS[arm][0]][6] == "stages"
    fn = host_kernel(kern.spec, tmp_path, entry=kern.spec.name + "_region")
    fn.argtypes = fused_stencil.region_argtypes()
    k5_steps(fn, kern, off, group_boxes(kern, boxes),
             tol=PLAIN_TOL.get(arm, (0.0, 0.0)))
