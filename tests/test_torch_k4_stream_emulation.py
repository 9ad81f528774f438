"""K4's stream arm (``<name>_trap_stream``: K6's stream arm over the K
levels of ``cuda_emit.emit_trap_stream``'s ``TrapSpec``) as device code
on the CPU, through the g++ shim of tests/test_torch_kernel_emulation.py
(one thread per CUDA thread, a fixed order between barriers, NaN-filled
shared memory, each ``cp.async`` leaving its destination NaN until the
issuing thread's wait), launched through the wrapper's own marshalling
(``call_stages_stream_entry``, ``call_batched_stages_stream_entry``) on
CPU tensors.

One K-step group per case, from a random state whose read-only inputs
carry nonzero pads, into NaN-filled outputs (every cell, pads included,
must be written), at sizes with two plane tiles per slot, the last one
partial, and two segments of slot 0, the last one partial, held against
``plain_chunk`` over the K steps: to the bit, but tti, whose ``sinf`` and
``cosf`` in g++'s libm and PyTorch's differ by an ulp (tests/
test_torch_scratch.py's tolerance, rtol 1e-5, atol 1e-6).  Most cases run
a small plane tile (:data:`RUNG`, a thread computing several points of a
sub-stage) to keep the emulation short; iso3dfd K=2 runs the planner's.
Also: the rings forced past shared memory (a small ``smem_limit``: staged
inputs read from their allocations, computed rings in a NaN-filled
workspace walked by fewer blocks than work items) and a member batch of
three (``_trap_stream_batched``) against each member's group.  The
mutation checks and the comparison with ``yask_tpu`` are in
tests/test_torch_k4_stream_checks.py."""

import pytest

import yask_tpu_torch
from yask_tpu_torch.ops import cuda_emit, fused_stencil
from yask_tpu_torch.ops.pipeline import SolutionPipeline, rtm_chain

from test_torch_k4_host import LIBM_TOL, assert_states
from test_torch_kernel_emulation import emulated_kernel
from test_torch_scratch import with_pads

#: slot 0 split in two segments of SEG planes, the last partial; slots 1
#: and 2 in two plane tiles of :data:`RUNG`, the last partial
SIZES = (14, 6, 12)
SEG = 8
#: 4x8 plane tiles by 32 threads (each thread a few points of a sub-stage)
RUNG = (4, 8, 32)


def reverse_3d():
    """A 3-D reverse-time solution in the port's DSL: A(t-1) from A(t) at
    offsets and A(t+1) at the point (three ring slots, step_dir -1)."""
    from yask_tpu_torch.compiler.solution import yc_factory
    soln = yc_factory().new_solution("reverse_3d")
    t = soln.new_step_index("t")
    x, y, z = (soln.new_domain_index(d) for d in "xyz")
    a = soln.new_var("A", [t, x, y, z])
    c = soln.new_var("C", [x, y, z])
    a(t - 1, x, y, z).EQUALS(
        (a(t, x - 1, y, z) + a(t, x + 2, y, z) + a(t, x, y - 1, z)
         + a(t, x, y + 1, z) + a(t, x, y, z - 2) + a(t, x, y, z + 1))
        * 0.125 + a(t + 1, x, y, z) * c(x, y, z))
    return soln


def k4_stream_ctx(name, r, K, sizes=SIZES, seed=23):
    """A seeded CPU context of ``name`` (a registered solution, "reverse"
    for :func:`reverse_3d`, "rtm" for the merged RTM chain) under
    ``-mode fused -wf_steps K -trapezoid``, its read-only inputs with
    nonzero pads; the chain's context is the merged one."""
    fac = yask_tpu_torch.yk_factory()
    env = fac.new_env(device="cpu")
    opts = (" ".join(f"-g_{d} {n}" for d, n in zip("xyz", sizes))
            + f" -mode fused -wf_steps {K} -trapezoid")
    if name == "rtm":
        pipe = SolutionPipeline(env, *rtm_chain(radius=2, accumulate=False))
        pipe.apply_command_line_options(opts)
        pipe.prepare(fuse=True)
        ctx = pipe.fused_ctx
    else:
        ctx = (fac.new_solution(env, reverse_3d()) if name == "reverse"
               else fac.new_solution(env, stencil=name, radius=r))
        ctx.apply_command_line_options(opts)
        ctx.prepare_solution()
    with_pads(ctx, seed)
    return ctx


def stream_spec(ctx, K, rung=RUNG, smem_limit=cuda_emit.SMEM_LIMIT):
    """K4's stream arm for the context's program at plane tile ``rung``
    (None: the planner's)."""
    prog = ctx._program
    lead = prog.ana.domain_dims[:-1]
    spec, cause = cuda_emit.emit_trap_stream(
        prog, K, lead[-2:], {d: 8 for d in lead}, smem_limit,
        (rung,) if rung else None)
    assert cause is None, cause
    if rung:
        assert spec.stages_stream.tile == rung[:2]
    return spec


def entry(spec, tmp_path, batched=False):
    """The emulated ``_trap_stream`` (or ``_trap_stream_batched``)."""
    name = spec.name + "_trap_stream" + ("_batched" if batched else "")
    fn = emulated_kernel(spec, tmp_path, entry=name)
    fn.argtypes = (fused_stencil.batched_stages_stream_argtypes() if batched
                   else fused_stencil.stages_stream_argtypes())
    return fn


def work_items(prog, spec, seg=SEG, nm=1):
    t1, t2 = spec.stages_stream.tile
    n = [prog.sizes[d] for d in prog.ana.domain_dims]
    return -(-n[1] // t1) * -(-n[2] // t2) * -(-n[0] // seg) * nm


def group(fn, ctx, spec, state, t0, nres, seg=SEG):
    """One group through the entry into NaN-filled outputs, with a
    NaN-filled workspace of ``nres`` slices where rings lie past shared
    memory; rings rotated as ``trapezoid_chunk`` does."""
    import torch
    prog = ctx._program
    ins = [state[n][s] for n, s in spec.inputs]
    outs = [torch.full(tuple(prog.geoms[n].shape), float("nan"))
            for n in spec.outputs]
    ws = (torch.full((nres * spec.stages_stream.ws_elems,), float("nan"))
          if spec.stages_stream.ws_elems else None)
    assert fused_stencil.call_stages_stream_entry(
        fn, prog, spec, ins, outs, t0, None, seg=seg, nres=nres,
        ws=ws) == 0
    return fused_stencil._rotated(prog, spec, state, outs)


def start_of(ctx):
    """The group's first step (a reverse-time solution steps down)."""
    return 9 if ctx._program.ana.step_dir < 0 else 0


#: (solution, radius, K, plane tile): iso3dfd at K = 2 (the planner's
#: rung), 3 and 4; the multi-stage, scratch, rewrite, reverse-time and
#: chain cases at K = 2
CASES = [("iso3dfd", 2, 2, None), ("iso3dfd", 2, 3, RUNG),
         ("iso3dfd", 2, 4, RUNG), ("tti", 2, 2, RUNG),
         ("awp", None, 2, RUNG), ("ssg", 2, 2, RUNG),
         ("test_stages_3d", None, 2, RUNG), ("reverse", None, 2, RUNG),
         ("rtm", None, 2, RUNG)]


@pytest.mark.parametrize("name,r,K,rung", CASES)
def test_k4_stream_arm_matches_plain_when_emulated(name, r, K, rung,
                                                   tmp_path):
    sizes = (14, 20, 40) if rung is None else SIZES
    ctx = k4_stream_ctx(name, r, K, sizes)
    prog = ctx._program
    spec = stream_spec(ctx, K, rung)
    assert spec.trap["arm"] == "stream" and spec.trap["K"] == K
    fn = entry(spec, tmp_path)
    t0 = start_of(ctx)
    got = group(fn, ctx, spec, ctx._state, t0, 3)
    want = fused_stencil.plain_chunk(prog, ctx._state, t0, K)
    assert_states(got, want, **(LIBM_TOL if name == "tti" else {}))


def test_rings_past_shared_memory_match_plain_when_emulated(tmp_path):
    """ssg at K = 2 with 20,000 B of shared memory: staged inputs read
    from their allocations, computed rings in a NaN-filled workspace of
    two slices, two blocks walking more work items than that."""
    ctx = k4_stream_ctx("ssg", 2, 2)
    prog = ctx._program
    spec = stream_spec(ctx, 2, smem_limit=20000)
    plan = spec.stages_stream
    assert plan.placed and plan.ws_elems > 0
    assert "global" in plan.in_place.values()
    assert "workspace" in plan.cmp_place
    assert work_items(prog, spec) > 2
    fn = entry(spec, tmp_path)
    got = group(fn, ctx, spec, ctx._state, 0, 2)
    assert_states(got, fused_stencil.plain_chunk(prog, ctx._state, 0, 2))


def test_member_batch_matches_each_member_when_emulated(tmp_path):
    """awp at K = 2, three members stacked as (3, *shape) per ring slot:
    one launch of ``_trap_stream_batched``, each member bit-equal to its
    own group."""
    import torch
    ctxs = [k4_stream_ctx("awp", None, 2, seed=40 + i) for i in range(3)]
    prog = ctxs[0]._program
    spec = stream_spec(ctxs[0], 2)
    fn = entry(spec, tmp_path, batched=True)
    ins = [torch.stack([c._state[n][s] for c in ctxs])
           for n, s in spec.inputs]
    outs = [torch.full((3,) + tuple(prog.geoms[n].shape), float("nan"))
            for n in spec.outputs]
    assert fused_stencil.call_batched_stages_stream_entry(
        fn, prog, spec, ins, outs, 3, 0, None, seg=SEG, nres=5) == 0
    for i, c in enumerate(ctxs):
        want = fused_stencil.plain_chunk(prog, c._state, 0, 2)
        got = fused_stencil._rotated(prog, spec, c._state,
                                     [o[i] for o in outs])
        assert_states(got, want)
