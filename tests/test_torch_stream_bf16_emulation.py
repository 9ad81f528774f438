"""K6's stream arm (``csrc/stream_stages.cuh``) at element size 2: its
staged rings of bfloat16 filled with aligned 4-byte pairs, each row from
the pair that holds its first cell (``ring_shift``), its computed rings
holding bfloat16 values each rounded once.

Each case runs the emitted source twice on the CPU: built by g++ for the
host (K6's host loop and the pads) and as device code through the shim
of tests/test_torch_kernel_emulation.py (one thread per CUDA thread, a
fixed order between barriers, NaN-filled shared memory, each
``cp.async`` leaving its destination NaN until the issuing thread's wait,
a misaligned one never completing), launched through the wrapper's own
marshalling on CPU tensors.  The state is random, its read-only inputs
carry nonzero pads (the rings stage them), the outputs come NaN-filled
(every cell, pads included, must be written), two plane tiles per slot
and two segments of slot 0, the last of each partial.  Tolerance: none;
whole tensors against the plain version (``plain_chunk``), whose
bfloat16 rounding hides the ulp by which g++'s libm and PyTorch's
``sin``/``cos`` may differ in float (tti).

The cases: tti r=2 (scratch sub-stages) with every row's first cell the
first of its pair and, with odd pads, the second; awp (rewrites); ssg;
the merged RTM chain with its image pushed and under ``-push off``; K7
over tti (three members); tti r=8 with its rings past a lowered
shared-memory limit (staged inputs read from their allocations, computed
rings in a NaN-filled workspace).  A copy of the header that takes every
row as starting at its first cell fails where that cell is the second of
its pair (its 4-byte copies misaligned)."""

import pytest

import yask_tpu_torch
from yask_tpu_torch.compiler.lowering import BFLOAT16
from yask_tpu_torch.ops import cuda_emit, fused_stencil
from yask_tpu_torch.ops.pipeline import SolutionPipeline, rtm_chain

from test_torch_bf16 import port_ctx
from test_torch_kernel_emulation import emulated_kernel
from test_torch_scratch import with_pads
from test_torch_stream_stages_host import host_entry

#: two plane tiles per slot at the 8x32 rung, the last partial; slot 0 in
#: two segments of SEG planes, the last partial
RAGGED = "-g_x 14 -g_y 9 -g_z 70"
SEG = 8
RUNG = (8, 32, 256)


def bf16_ctx(name, r, cli="", seed=21):
    """A seeded bfloat16 context of ``name`` on the CPU, its read-only
    inputs with nonzero pads; K6's stream arm engaged."""
    ctx = port_ctx(name, r, f"{RAGGED} -mode fused {cli}")
    with_pads(ctx, seed)
    kern = ctx._fused_spec_kernel()
    assert kern.skew_dims == ["x"], kern.skew_reasons
    return ctx


def rtm_bf16(cli=""):
    """The merged RTM chain in bfloat16 (its fused context), seeded."""
    pipe = SolutionPipeline(
        yask_tpu_torch.yk_factory().new_env(device="cpu"),
        *rtm_chain(radius=2, accumulate=False), dtype=BFLOAT16)
    pipe.apply_command_line_options(f"{RAGGED} -mode fused -wf_steps 1 "
                                    f"{cli}")
    pipe.prepare(fuse=True)
    ctx = pipe.fused_ctx
    with_pads(ctx, 23)
    return ctx


def arm_spec(ctx, rung=RUNG):
    """The arm at plane tile ``rung`` for the context's program."""
    spec = cuda_emit.emit(ctx._program, ctx._push_arg(),
                          stream_tiles=(rung,))
    assert spec.stages_stream.tile == rung[:2]
    assert spec.stages_stream.esize == 2
    assert "typedef yt::bf16_t real_t;" in spec.source
    return spec


def shifts(ctx, spec):
    """Each staged ring's pair shift: 1 where its rows' first cell is the
    second element of its 4-byte pair (the kernel's ``ring_shift``)."""
    prog = ctx._program
    out = set()
    for a in spec.tiled:
        n, s = spec.inputs[a]
        ptr = fused_stencil._interior_ptr(ctx._state[n][s], prog.geoms[n])
        out.add(((ptr >> 1) + spec.halos[a][2][0]) & 1)
    return out


def nan_outs(prog, spec, lead=()):
    import torch
    return [torch.full(lead + tuple(prog.geoms[n].shape), float("nan"),
                       dtype=torch.bfloat16) for n in spec.outputs]


def steps_match(fn, ctx, spec, steps=2, nres=3, ws=None):
    """``steps`` sub-steps through ``fn`` into NaN-filled outputs, each
    against ``plain_chunk`` from the same state; True where every output
    tensor is bit-equal."""
    import torch
    prog = ctx._program
    state = ctx._state
    for t in range(steps):
        ins = [state[n][s] for n, s in spec.inputs]
        fused_stencil.check_pair_strides(prog, spec, ins)
        outs = nan_outs(prog, spec)
        assert fused_stencil.call_stages_stream_entry(
            fn, prog, spec, ins, outs, t, None, seg=SEG, nres=nres,
            ws=ws) == 0
        want = fused_stencil.plain_chunk(prog, state, t, 1)
        if not all(torch.equal(o, want[n][-1])
                   for n, o in zip(spec.outputs, outs)):
            return False
        state = want
    return True


@pytest.mark.parametrize("pads,shift", [("", 0), ("-mp_z 1", 1)],
                         ids=["first-of-pair", "second-of-pair"])
def test_tti_pairs_at_both_shifts(pads, shift, tmp_path):
    """tti r=2: its rows start at the first element of a pair, and with
    odd z pads (5: a halo of 4 from an odd interior origin) at the
    second, every ring one cell early; host path and device code."""
    ctx = bf16_ctx("tti", 2, pads)
    spec = arm_spec(ctx)
    assert shifts(ctx, spec) == {shift}
    assert steps_match(host_entry(spec, tmp_path, "_stages_stream"), ctx,
                       spec)
    fn = emulated_kernel(spec, tmp_path, entry=spec.name + "_stages_stream")
    assert steps_match(fn, ctx, spec)


@pytest.mark.parametrize("name,r", [("awp", None), ("ssg", None)])
def test_rewrites_and_stages_match_plain(name, r, tmp_path):
    """awp (a later sub-stage rewriting an earlier one's var) and ssg,
    host path and device code, on 1 and on all blocks."""
    ctx = bf16_ctx(name, r)
    spec = arm_spec(ctx)
    assert steps_match(host_entry(spec, tmp_path, "_stages_stream"), ctx,
                       spec)
    fn = emulated_kernel(spec, tmp_path, entry=spec.name + "_stages_stream")
    assert steps_match(fn, ctx, spec, nres=1)
    assert steps_match(fn, ctx, spec, steps=1, nres=64)


@pytest.mark.parametrize("cli,pushed", [("", ["img__img"]),
                                        ("-push off", [])],
                         ids=["image_pushed", "push_off"])
def test_rtm_chain_matches_plain(cli, pushed, tmp_path):
    """The merged RTM chain in bfloat16: its image a computed ring with no
    output read at slot-0 offsets by the smoothing, or (``-push off``)
    an output the smoothing reads from its staged ring."""
    ctx = rtm_bf16(cli)
    kern = ctx._fused_spec_kernel()
    assert kern.spec.push_vars == pushed and kern.skew_dims == ["x"]
    spec = arm_spec(ctx)
    assert spec.push_vars == pushed
    assert steps_match(host_entry(spec, tmp_path, "_stages_stream"), ctx,
                       spec)
    fn = emulated_kernel(spec, tmp_path, entry=spec.name + "_stages_stream")
    assert steps_match(fn, ctx, spec)


def test_k7_over_tti_matches_each_member(tmp_path):
    """K7 over the arm: three tti members stacked as (3, *shape), one
    launch of ``_stages_stream_batched``, each member bit-equal to its
    plain step (host path and device code)."""
    import torch
    ctxs = [bf16_ctx("tti", 2, seed=40 + i) for i in range(3)]
    prog = ctxs[0]._program
    spec = arm_spec(ctxs[0])
    ins = [torch.stack([c._state[n][s] for c in ctxs])
           for n, s in spec.inputs]
    fused_stencil.check_pair_strides(prog, spec, ins, 1)
    wants = [fused_stencil.plain_chunk(prog, c._state, 0, 1) for c in ctxs]
    for fn in (host_entry(spec, tmp_path, "_stages_stream_batched"),
               emulated_kernel(spec, tmp_path,
                               entry=spec.name + "_stages_stream_batched")):
        outs = nan_outs(prog, spec, (3,))
        assert fused_stencil.call_batched_stages_stream_entry(
            fn, prog, spec, ins, outs, 3, 0, None, seg=SEG, nres=4) == 0
        for i, want in enumerate(wants):
            for n, o in zip(spec.outputs, outs):
                assert torch.equal(o[i], want[n][-1]), (i, n)


def test_tti_r8_rings_past_shared_memory(tmp_path, monkeypatch):
    """tti r=8 at a lowered shared-memory limit: its staged inputs read
    from their allocations and a computed ring in a NaN-filled workspace
    slice per block, two blocks walking every work item."""
    import torch
    ctx = bf16_ctx("tti", 8)
    monkeypatch.setattr(cuda_emit, "SMEM_LIMIT", 60000)
    spec = arm_spec(ctx)
    plan = spec.stages_stream
    assert plan.placed and plan.ws_elems > 0
    assert set(plan.in_place.values()) == {"global"}
    assert "workspace" in plan.cmp_place
    assert plan.smem_bytes <= 60000
    ws = torch.full((2 * plan.ws_elems,), float("nan"), dtype=torch.bfloat16)
    fn = emulated_kernel(spec, tmp_path, entry=spec.name + "_stages_stream")
    assert steps_match(fn, ctx, spec, nres=2, ws=ws)


def test_emulation_fails_with_the_rows_unshifted(tmp_path):
    """Taking every ring row as starting at its first cell where that cell
    is the second of its pair misaligns every 4-byte copy, which faults on
    the card (the emulation never completes it)."""
    ctx = bf16_ctx("tti", 2, "-mp_z 1")
    spec = arm_spec(ctx)
    assert shifts(ctx, spec) == {1}

    def unshifted(name, text):
        if name != "stream_stages.cuh":
            return text
        old = "+ S::halo_lo2(k)) & 1);"
        assert text.count(old) == 1
        return text.replace(old, "+ S::halo_lo2(k)) & 0);")
    fn = emulated_kernel(spec, tmp_path, entry=spec.name + "_stages_stream",
                         edit=unshifted)
    assert not steps_match(fn, ctx, spec, steps=1)
