"""K7's device code (``fused_step_kernel<S>`` and ``fused_stages_kernel<S>``
over a member batch) on every arm, run on the CPU block by block through
tests/test_torch_kernel_emulation.py's CUDA shim (a thread per CUDA
thread, NaN-filled shared memory).

The same states and checks as tests/test_torch_k7_host.py (2 members,
ragged grids, nonzero pads on the read-only inputs, NaN-filled outputs,
two sub-steps): each member bit-equal to the solo device entry of the
same build on its view, and to ``plain_batched_chunk`` over its interior
(tti by rtol 1e-5 and atol 1e-6 for g++'s libm).  Then ROADMAP.md C15 and
the split of z into member × outer cell × slot-0 block on the 4-D arms:
at a cap of 2 z cells per launch (``YT_MAX_GRID_Z``), with members whose
stacks sit further apart than their size (a member stride that is not
the product of the outer extents and strides), and a deliberately broken
copy that takes the member for the outer cell, which the check sees.
"""

import pytest

from test_torch_k7_host import (PLAIN_TOL, RAGGED, batch_of, bind,
                                k7_steps)
from test_torch_kernel_emulation import emulated_kernel


def emulated_pair(spec, tmp_path, **kw):
    """The solo and the batched entry of one emulated build."""
    fn_solo = emulated_kernel(spec, tmp_path, **kw)
    return fn_solo, bind(tmp_path / f"{spec.name}.so",
                         spec.name + "_batched")


@pytest.mark.parametrize("arm", list(RAGGED))
def test_k7_device_code_matches_plain_and_solo_when_emulated(arm,
                                                             tmp_path):
    ctx, state = batch_of(arm)
    spec = ctx._fused_spec_kernel().spec
    fn_solo, fn_batched = emulated_pair(spec, tmp_path)
    k7_steps(ctx, state, fn_batched, fn_solo,
             tol=PLAIN_TOL.get(arm, (0.0, 0.0)))


@pytest.mark.parametrize("arm", ["4d-test_4d", "4d-four_d_stages",
                                 "bf16-iso3dfd"])
def test_k7_walks_z_in_chunks_over_padded_members_when_emulated(arm,
                                                                tmp_path):
    """2 members x the outer cells (3 in 4-D) x the slot-0 blocks, two z
    cells per launch, each member's stack 6 elements past the last one's
    end (the twin of tests/test_torch_ensemble.py's 70000 members)."""
    from yask_tpu_torch.ops import fused_stencil
    ctx, state = batch_of(arm, seed=47)
    spec = ctx._fused_spec_kernel().spec
    assert fused_stencil.grid_z(ctx._program, spec, members=2) >= 4
    fn_solo, fn_batched = emulated_pair(spec, tmp_path,
                                        defines={"YT_MAX_GRID_Z": 2})
    k7_steps(ctx, state, fn_batched, fn_solo, pad=6)


def test_k7_emulation_fails_when_the_member_is_taken_for_the_outer_cell(
        tmp_path):
    """The split before K7 took outer dims: one index meant the member or
    the outer cell, and a Spec with outer dims dropped the member stride.
    Every member then reads and writes member 0, which the check sees."""
    def conflate(name, text):
        if name != "fused_step.cuh":
            return text
        old = "  idx_t off = idx_t(m) * ms;"
        assert text.count(old) == 1
        return text.replace(old, "  idx_t off = OuterOf<S>::N > 0 ? 0 "
                                 ": idx_t(m) * ms;")
    ctx, state = batch_of("4d-four_d_stages", seed=53)
    spec = ctx._fused_spec_kernel().spec
    fn_solo, fn_batched = emulated_pair(spec, tmp_path, edit=conflate)
    with pytest.raises(AssertionError):
        k7_steps(ctx, state, fn_batched, fn_solo, steps=1)
