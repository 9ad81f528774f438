"""K6's stream arm (``csrc/stream_stages.cuh``) as device code, run on the
CPU block by block: the g++ shim of tests/test_torch_kernel_emulation.py
(one thread per CUDA thread, a fixed order between barriers, NaN-filled
shared memory, each ``cp.async`` leaving its destination NaN until the
issuing thread's wait), launched through the wrapper's own marshalling
(``call_stages_stream_entry``, ``call_batched_stages_stream_entry``) on
CPU tensors.  The g++ host path runs K6's host loop, so only this sees
the rings, the lags, the barriers between sub-stages and the copies.

Each case runs from a random state whose read-only inputs carry nonzero
pads (the rings stage them), into NaN-filled outputs (every cell, pads
included, must be written), at sizes with two plane tiles per slot, the
last one partial, and two segments of slot 0, the last one partial.
Tolerance: none; whole tensors against the plain version.  K7 over the
arm, the checks the emulation must fail and the 16-byte copies are in
tests/test_torch_stream_stages_emulation_checks.py."""

import pytest

from yask_tpu_torch.ops import cuda_emit, fused_stencil

from test_torch_kernel_emulation import emulated_kernel, rtm_ctx
from test_torch_scratch import port_ctx, with_pads

#: two plane tiles per slot at the 8x32 rung, the last partial; slot 0
#: split by SEG in two segments, each longer than the walk's warm-up and
#: prefetch, the last one partial
RAGGED = "-g_x 14 -g_y 9 -g_z 70"
SEG = 8
#: the plane tile (T1, T2, threads) most cases emulate at: the ladder's
#: third rung, half the threads of its first (which
#: test_stream_arm_at_the_first_rung_when_emulated runs), to keep the
#: one-thread-per-CUDA-thread emulation short
RUNG = (8, 32, 256)
SOLUTIONS = ["awp", "awp_elastic_abc", "ssg", "fsg_abc", "test_stages_3d",
             "test_boundary_3d"]


def stream_ctx(name, seed=21, g=RAGGED, rung=RUNG):
    """A seeded context of ``name`` on the CPU and its K6 spec with the
    stream arm at plane tile ``rung`` (None: the ladder's)."""
    ctx = port_ctx(name, None, f"{g} -mode fused")
    with_pads(ctx, seed)
    kern = ctx._fused_spec_kernel()
    assert kern.skew_dims == ["x"] and kern.spec.stages_stream is not None
    if rung is None:
        return ctx, kern.spec
    spec = cuda_emit.emit(ctx._program, stream_tiles=(rung,))
    assert spec.stages_stream.tile == rung[:2]
    return ctx, spec


def items(prog, spec, seg=SEG, nm=1):
    """The work items of one launch (columns x segments x members)."""
    t1, t2 = spec.stages_stream.tile
    n = [prog.sizes[d] for d in prog.ana.domain_dims]
    return -(-n[1] // t1) * -(-n[2] // t2) * -(-n[0] // seg) * nm


def launch(fn, ctx, spec, state, t, nres, seg=SEG, ins=None):
    """One sub-step through the entry into NaN-filled outputs; returns
    the outputs."""
    import torch
    prog = ctx._program
    ins = ins or [state[n][s] for n, s in spec.inputs]
    outs = [torch.full(tuple(prog.geoms[n].shape), float("nan"))
            for n in spec.outputs]
    assert fused_stencil.call_stages_stream_entry(
        fn, prog, spec, ins, outs, t, None, seg=seg, nres=nres) == 0
    return outs


def plain(ctx, spec, state, t):
    want = fused_stencil.plain_chunk(ctx._program, state, t, 1)
    return want, [want[n][-1] for n in spec.outputs]


def same(got, want):
    import torch
    return all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("name", SOLUTIONS)
def test_stream_arm_matches_plain_when_emulated(name, tmp_path):
    """Three sub-steps, on 1, 2 and all of the work items' blocks."""
    ctx, spec = stream_ctx(name)
    fn = emulated_kernel(spec, tmp_path, entry=spec.name + "_stages_stream")
    state = ctx._state
    for t, nres in enumerate((1, 2, items(ctx._program, spec))):
        got = launch(fn, ctx, spec, state, t, nres)
        state, want = plain(ctx, spec, state, t)
        assert same(got, want), (name, t, nres)


def test_stream_arm_at_the_first_rung_when_emulated(tmp_path):
    """awp at the ladder's first rung (16x32 by 512 threads), two plane
    tiles per slot, on 2 blocks."""
    ctx, spec = stream_ctx("awp", g="-g_x 14 -g_y 19 -g_z 70", rung=None)
    assert (spec.stages_stream.tile, spec.stages_stream.threads) == \
        ((16, 32), 512)
    fn = emulated_kernel(spec, tmp_path, entry=spec.name + "_stages_stream")
    got = launch(fn, ctx, spec, ctx._state, 0, 2)
    assert same(got, plain(ctx, spec, ctx._state, 0)[1])


def test_rtm_chain_with_its_image_pushed_when_emulated(tmp_path):
    """The merged RTM chain with its image pushed: a computed ring with
    no output, read at slot-0 offsets by the smoothing."""
    ctx = rtm_ctx(2, False)
    kern = ctx._fused_spec_kernel()
    assert kern.spec.push_vars == ["img__img"] and kern.skew_dims == ["x"]
    spec = cuda_emit.emit(ctx._program, ctx._push_arg(),
                          stream_tiles=(RUNG,))
    assert spec.push_vars == ["img__img"]
    with_pads(ctx, 23)
    fn = emulated_kernel(spec, tmp_path, entry=spec.name + "_stages_stream")
    state = ctx._state
    for t, nres in ((0, 2), (1, items(ctx._program, spec, 6))):
        got = launch(fn, ctx, spec, state, t, nres, seg=6)
        state, want = plain(ctx, spec, state, t)
        assert same(got, want), t


@pytest.mark.parametrize("accumulate, cli", [(True, ""), (False, "-push off")],
                         ids=["accumulating", "push_off"])
def test_rtm_chain_with_nothing_pushed_when_emulated(accumulate, cli,
                                                     tmp_path):
    """The merged RTM chain with nothing pushed: the accumulating chain
    (the image adds to its own last value, so it is a staged input and
    an output) and the pure chain under ``-push off`` (its image an
    output the smoothing reads at slot-0 offsets)."""
    ctx = rtm_ctx(2, accumulate, cli)
    kern = ctx._fused_spec_kernel()
    assert kern.spec.push_vars == [] and kern.skew_dims == ["x"]
    spec = cuda_emit.emit(ctx._program, ctx._push_arg(),
                          stream_tiles=(RUNG,))
    assert "img__img" in spec.outputs
    with_pads(ctx, 23)
    fn = emulated_kernel(spec, tmp_path, entry=spec.name + "_stages_stream")
    state = ctx._state
    for t, nres in ((0, 2), (1, items(ctx._program, spec, 6))):
        got = launch(fn, ctx, spec, state, t, nres, seg=6)
        state, want = plain(ctx, spec, state, t)
        assert same(got, want), t
