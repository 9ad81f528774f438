"""K6's stream arm with scratch sub-stages (tti at r=2 and r=4,
test_scratch_3d) as device code on the CPU: the g++ shim of
tests/test_torch_kernel_emulation.py (one thread per CUDA thread, a fixed
order between barriers, NaN-filled shared memory, each ``cp.async``
leaving its destination NaN until the issuing thread's wait), launched
through the wrapper's own marshalling on CPU tensors.

A scratch var is a computed ring with no output, its sub-stage at its
lag; its planes past the domain are computed from the pads out to its
write halo.  Each case runs from a random state whose read-only inputs
carry nonzero pads (other pad contents give another answer), into
NaN-filled outputs, at sizes with two plane tiles per slot, the last one
partial, and two segments of slot 0, the last one partial.

Tolerance: none against the g++ host path of the same entry (both built
by g++: the same operations in the same order, the same ``sinf``), whole
tensors; none against the plain version for test_scratch_3d, and for tti
rtol 1e-5 and atol 1e-6 on the interiors, since g++'s libm
``sinf``/``cosf`` and PyTorch's vectorized CPU ``sin``/``cos`` differ by
an ulp (tests/test_torch_scratch.py has the same rule)."""

import re

import pytest

from yask_tpu_torch.ops import cuda_emit, fused_stencil

from test_torch_kernel_emulation import emulated_kernel
from test_torch_scratch import port_ctx, with_pads
from test_torch_stream_stages_emulation import RUNG, SEG, items, launch, same
from test_torch_stream_stages_emulation_checks import member_stacks
from test_torch_stream_stages_host import host_entry

#: (slot 0, 1, 2) = (x, y, z): two segments of SEG planes, two plane
#: tiles in y and three in z at the 8x32 rung, each last one partial
RAGGED = "-g_x 14 -g_y 9 -g_z 70"
#: the solutions with scratch sub-stages the arm now takes, and their
#: sub-stage lags (the trig scratch and the rotated derivatives two (r=2)
#: or four (r=4) planes ahead of the update; test_scratch_3d's chain of
#: three with asymmetric write halos)
CASES = [("tti", 2, [2, 2, 0]), ("tti", 4, [4, 4, 0]),
         ("test_scratch_3d", None, [2, 2, 2, 0])]


def scratch_ctx(name, r, seed=21):
    """A seeded context of ``name`` on the CPU, its K6 spec with the
    stream arm at :data:`RUNG` and the solution's own plan's lags."""
    ctx = port_ctx(name, r, f"{RAGGED} -mode fused")
    with_pads(ctx, seed)
    kern = ctx._fused_spec_kernel()
    assert kern.skew_dims == ["x"] and kern.spec.scratch_stages > 0
    spec = cuda_emit.emit(ctx._program, stream_tiles=(RUNG,))
    assert spec.stages_stream.tile == RUNG[:2]
    assert not spec.stages_stream.placed
    return ctx, spec


def check_plain(ctx, spec, name, got, want):
    """``got`` against the plain version's new slots ``want``: whole
    tensors to the bit for test_scratch_3d, the interiors within tti's
    libm tolerance."""
    import torch
    if name != "tti":
        assert same(got, want)
        return
    for n, a, w in zip(spec.outputs, got, want):
        idx = ctx._interior_idx(n)
        torch.testing.assert_close(a[idx], w[idx], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,r,lags", CASES)
def test_scratch_sub_stages_match_when_emulated(name, r, lags, tmp_path):
    """Two sub-steps, on 2 and on all of the work items' blocks: the
    emulated arm bit-equal to the g++ host path, and to the plain
    version (tti within its libm tolerance)."""
    ctx, spec = scratch_ctx(name, r)
    assert spec.stages_stream.lags == lags
    fn = emulated_kernel(spec, tmp_path, entry=spec.name + "_stages_stream")
    (tmp_path / "host").mkdir()
    host = host_entry(spec, tmp_path / "host", "_stages_stream")
    prog = ctx._program
    state = ctx._state
    for t, nres in ((0, 2), (1, items(prog, spec))):
        got = launch(fn, ctx, spec, state, t, nres)
        assert same(got, launch(host, ctx, spec, state, t, 1)), (t, nres)
        want = fused_stencil.plain_chunk(prog, state, t, 1)
        check_plain(ctx, spec, name, got, [want[n][-1] for n in spec.outputs])
        state = want


@pytest.mark.parametrize("name,r", [("tti", 2), ("test_scratch_3d", None)])
def test_k7_over_scratch_sub_stages_matches_each_member_when_emulated(
        name, r, tmp_path):
    """K7 over the arm: 3 members whose stacks sit a padded stride apart,
    each member's outputs bit-equal to its solo run (the g++ host path of
    the solo entry)."""
    import torch
    ctx, spec = scratch_ctx(name, r)
    prog = ctx._program
    fn = emulated_kernel(spec, tmp_path,
                         entry=spec.name + "_stages_stream_batched")
    (tmp_path / "host").mkdir()
    host = host_entry(spec, tmp_path / "host", "_stages_stream")
    states, ins, outs = member_stacks(ctx, spec, (31, 32, 33))
    assert fused_stencil.call_batched_stages_stream_entry(
        fn, prog, spec, ins, outs, 3, 0, None, seg=SEG, nres=5) == 0
    for i, st in enumerate(states):
        solo = launch(host, ctx, spec, st, 0, 1)
        assert all(torch.equal(o[i], s) for o, s in zip(outs, solo)), \
            (name, i)


def test_emulation_fails_when_scratch_past_the_domain_is_zeroed(tmp_path):
    """A ring that holds 0 for the scratch cells past the domain (each
    sub-stage clipped to the domain, not to its write halo) gives tti's
    update at the domain's faces from zeros: the emulation sees it."""
    ctx, spec = scratch_ctx("tti", 2)

    def domain_only(fn, text):
        if fn != "stream_stages.cuh":
            return text
        text, n = re.subn(r"plain_region<S, K, REGION>\(p, s, plo\[s\], "
                          r"phi\[s\]\);",
                          "{ plo[s] = 0; phi[s] = p.n[s]; }", text)
        assert n == 1
        return text
    emu = emulated_kernel(spec, tmp_path, entry=spec.name + "_stages_stream",
                          edit=domain_only)
    (tmp_path / "host").mkdir()
    host = host_entry(spec, tmp_path / "host", "_stages_stream")
    got = launch(emu, ctx, spec, ctx._state, 0, 3)
    assert not same(got, launch(host, ctx, spec, ctx._state, 0, 1))
