"""The stream arm past three domain dims, as device code on the CPU: K6's
(and K7's) 4-D sub-step (``<name>_stages_stream``, the ``StreamSpec`` that
``cuda_emit.emit`` prints beside K6's body) and K4's 4-D groups
(``<name>_trap_stream``, ``cuda_emit.emit_trap_stream``'s ``TrapSpec``),
through the g++ shim of tests/test_torch_kernel_emulation.py (one thread
per CUDA thread, a fixed order between barriers, NaN-filled shared
memory, each ``cp.async`` leaving its destination NaN until the issuing
thread's wait), launched through the wrappers' own marshalling
(``call_stages_stream_entry``, ``call_batched_stages_stream_entry``) on
CPU tensors.

The outer dims are windows of the work items: a staged ring holds the
window grown by its readers' outer reach and serves the var's reads at
every outer offset, each sub-stage (K4: of every level) is computed once
over its region in every slot.  Each case: a small plane tile
(:data:`RUNG`, a thread computing several points of a sub-stage) and an
outer window that splits every outer dim in two, the last window
partial; two plane tiles per slot, the last partial; two segments of
slot 0, the last partial; read-only inputs with nonzero pads; NaN-filled
outputs (every cell, the outer pads included, must be written); against
``plain_chunk``, to the bit.  Also: the rings forced past shared memory
(a small shared-memory limit: staged inputs read from their
allocations, computed rings in a NaN-filled workspace), a member batch
of three against each member, and two mutation checks (a level's, and a
sub-stage's, outer growth dropped: the emulation must differ)."""

import dataclasses
import re

import pytest

from yask_tpu_torch.ops import cuda_emit, fused_stencil

from test_torch_4d import port_ctx
from test_torch_k4_host import assert_states
from test_torch_kernel_emulation import emulated_kernel
from test_torch_scratch import with_pads

#: (w, x, y, z): x (slot 0) in two segments of :data:`SEG`, y and z in two
#: plane tiles of :data:`RUNG`, the last of each partial; w in two windows
SIZES = "-g_w 7 -g_x 14 -g_y 6 -g_z 12"
SIZES_5D = "-g_v 3 -g_w 4 -g_x 14 -g_y 6 -g_z 12"
SEG = 8
#: 4x8 plane tiles by 32 threads
RUNG = (4, 8, 32)
#: the outer windows per case: w = 7 as 4 + 3; v = 3 as 2 + 1, w = 4 as
#: 3 + 1
WINDOWS = {"four_d_stages": (4,), "five_d": (2, 3), "test_4d": (4,)}


def ctx_of(case, K=1, seed=21):
    """A seeded CPU context of a 4-D (5-D) case, its read-only inputs with
    nonzero pads."""
    sizes = SIZES_5D if case == "five_d" else SIZES
    trap = f" -wf_steps {K} -trapezoid" if K > 1 else ""
    ctx = port_ctx(case, f"{sizes} -mode fused{trap}")
    with_pads(ctx, seed)
    return ctx


def k6_spec(ctx, case, windows=None):
    """K6's body with its 4-D stream arm at :data:`RUNG` and the case's
    windows; returns (the source's spec, the stream arm's spec)."""
    rung = RUNG + (windows or WINDOWS[case],)
    spec = cuda_emit.emit(ctx._program, stream_tiles=(rung,))
    ss = spec.stream_spec
    assert ss is not None and spec.stages_stream is ss.stages_stream
    assert ss.stages_stream.outer_tile == rung[3]
    return spec, ss


def k4_spec(ctx, case, K, smem_limit=cuda_emit.SMEM_LIMIT):
    prog = ctx._program
    lead = prog.ana.domain_dims[:-1]
    spec, cause = cuda_emit.emit_trap_stream(
        prog, K, ["x", "y"], {d: 8 for d in lead}, smem_limit,
        (RUNG + (WINDOWS[case],),))
    assert cause is None, cause
    assert spec.stages_stream.outer_tile == WINDOWS[case]
    return spec


def launch(fn, ctx, spec, state, t0, nres=3):
    """One launch through the stream entry into NaN-filled outputs, with a
    NaN-filled workspace of ``nres`` slices where rings lie past shared
    memory; rings rotated as the wrappers do."""
    import torch
    prog = ctx._program
    plan = spec.stages_stream
    ins = [state[n][s] for n, s in spec.inputs]
    outs = [torch.full(tuple(prog.geoms[n].shape), float("nan"))
            for n in spec.outputs]
    ws = (torch.full((nres * plan.ws_elems,), float("nan"))
          if plan.ws_elems else None)
    assert fused_stencil.call_stages_stream_entry(
        fn, prog, spec, ins, outs, t0, None, seg=SEG, nres=nres,
        ws=ws) == 0
    return fused_stencil._rotated(prog, spec, state, outs)


def work_items(ctx, spec, nm=1):
    prog = ctx._program
    dims = prog.ana.domain_dims
    plan = spec.stages_stream
    no = spec.outer
    n = [prog.sizes[d] for d in dims]
    items = -(-n[no] // SEG) * -(-n[no + 1] // plan.tile[0]) \
        * -(-n[no + 2] // plan.tile[1]) * nm
    for w, e in zip(plan.outer_tile, n[:no]):
        assert -(-e // w) == 2 and e % w
        items *= -(-e // w)
    return items


@pytest.mark.parametrize("case", ["four_d_stages", "five_d"])
def test_k6_4d_stream_arm_matches_plain_when_emulated(case, tmp_path):
    """One sub-step of K6's 4-D (5-D) stream arm, two steps in a row."""
    ctx = ctx_of(case)
    prog = ctx._program
    spec, ss = k6_spec(ctx, case)
    assert work_items(ctx, ss) > 3
    fn = emulated_kernel(spec, tmp_path, entry=spec.name + "_stages_stream")
    state = ctx._state
    for t in range(2):
        got = launch(fn, ctx, ss, state, t)
        want = fused_stencil.plain_chunk(prog, state, t, 1)
        assert_states(got, want)
        state = want


@pytest.mark.parametrize("case,K", [("test_4d", 2), ("test_4d", 3),
                                    ("four_d_stages", 2)])
def test_k4_4d_stream_arm_matches_plain_when_emulated(case, K, tmp_path):
    """One K-step group of K4's 4-D stream arm."""
    ctx = ctx_of(case, K)
    prog = ctx._program
    spec = k4_spec(ctx, case, K)
    assert work_items(ctx, spec) > 3
    fn = emulated_kernel(spec, tmp_path, entry=spec.name + "_trap_stream")
    fn.argtypes = fused_stencil.stages_stream_argtypes()
    got = launch(fn, ctx, spec, ctx._state, 0)
    assert_states(got, fused_stencil.plain_chunk(prog, ctx._state, 0, K))


@pytest.mark.parametrize("arm", ["K4", "K6"])
def test_rings_past_shared_memory_match_plain_when_emulated(arm, tmp_path,
                                                            monkeypatch):
    """A small shared-memory limit: staged inputs read from their
    allocations, computed rings in a NaN-filled workspace of two slices,
    two blocks walking more work items than that."""
    if arm == "K4":
        ctx = ctx_of("four_d_stages", 2)
        spec = k4_spec(ctx, "four_d_stages", 2, smem_limit=8000)
        entry, K = spec.name + "_trap_stream", 2
        src = spec
    else:
        monkeypatch.setattr(cuda_emit, "SMEM_LIMIT", 3000)
        ctx = ctx_of("four_d_stages")
        src, spec = k6_spec(ctx, "four_d_stages")
        entry, K = src.name + "_stages_stream", 1
    plan = spec.stages_stream
    assert plan.placed and plan.ws_elems > 0
    assert "global" in plan.in_place.values()
    assert "workspace" in plan.cmp_place
    assert work_items(ctx, spec) > 2
    fn = emulated_kernel(src, tmp_path, entry=entry)
    fn.argtypes = fused_stencil.stages_stream_argtypes()
    got = launch(fn, ctx, spec, ctx._state, 0, nres=2)
    assert_states(got, fused_stencil.plain_chunk(ctx._program, ctx._state,
                                                 0, K))


@pytest.mark.parametrize("arm", ["K4", "K6"])
def test_member_batch_matches_each_member_when_emulated(arm, tmp_path):
    """Three members stacked as (3, *shape) per ring slot: one launch of
    ``_stages_stream_batched`` (K7 over K6's 4-D stream arm, four_d_stages)
    or ``_trap_stream_batched`` (K4's, test_4d at K = 2), each member
    bit-equal to its own plain step or group."""
    import torch
    case, K = ("test_4d", 2) if arm == "K4" else ("four_d_stages", 1)
    ctxs = [ctx_of(case, K, seed=40 + i) for i in range(3)]
    prog = ctxs[0]._program
    if arm == "K4":
        spec = src = k4_spec(ctxs[0], case, K)
        entry = spec.name + "_trap_stream_batched"
    else:
        src, spec = k6_spec(ctxs[0], case)
        entry = src.name + "_stages_stream_batched"
    fn = emulated_kernel(src, tmp_path, entry=entry)
    fn.argtypes = fused_stencil.batched_stages_stream_argtypes()
    ins = [torch.stack([c._state[n][s] for c in ctxs])
           for n, s in spec.inputs]
    outs = [torch.full((3,) + tuple(prog.geoms[n].shape), float("nan"))
            for n in spec.outputs]
    assert fused_stencil.call_batched_stages_stream_entry(
        fn, prog, spec, ins, outs, 3, 0, None, seg=SEG, nres=5) == 0
    for i, c in enumerate(ctxs):
        want = fused_stencil.plain_chunk(prog, c._state, 0, K)
        got = fused_stencil._rotated(prog, spec, c._state,
                                     [o[i] for o in outs])
        assert_states(got, want)


def no_outer_growth(text: str, level_only: bool) -> str:
    """The Spec with the outer growth of its sub-stages' regions dropped:
    every sub-stage's (``level_only`` False), or the first level's alone
    (K4: sub-stage 0 of test_4d's two levels)."""
    for fn in ("sub_olo", "sub_ohi"):
        pat = (rf"(static constexpr int {fn}\(int k, int j\) \{{ return )"
               r"([^;]*);")
        body = re.search(pat, text).group(2)
        new = (re.sub(r"k == 0 && j == 0 \? -?\d+ : ", "", body)
               if level_only else "0")
        assert new != body
        text = re.sub(pat, lambda m: m.group(1) + new + ";", text)
    return text


@pytest.mark.parametrize("arm", ["K4", "K6"])
def test_emulation_fails_without_the_outer_growth(arm, tmp_path):
    """K4 (test_4d, K = 2) with level 1 not grown by what level 2 reads
    of it at w offsets, and K6 (four_d_stages) with its sub-stages not
    grown in w: a later read lands outside what its writer computed, and
    the emulation sees it."""
    import torch
    if arm == "K4":
        ctx = ctx_of("test_4d", 2)
        spec = k4_spec(ctx, "test_4d", 2)
        src = dataclasses.replace(spec, source=no_outer_growth(
            spec.source, True))
        entry, K = spec.name + "_trap_stream", 2
    else:
        ctx = ctx_of("four_d_stages")
        body, spec = k6_spec(ctx, "four_d_stages")
        src = dataclasses.replace(body, source=no_outer_growth(
            body.source, False))
        entry, K = body.name + "_stages_stream", 1
    fn = emulated_kernel(src, tmp_path, entry=entry)
    fn.argtypes = fused_stencil.stages_stream_argtypes()
    got = launch(fn, ctx, spec, ctx._state, 0)
    want = fused_stencil.plain_chunk(ctx._program, ctx._state, 0, K)
    assert any(not torch.equal(a, b) for n in want
               for a, b in zip(got[n], want[n]))
