"""K4's own code on the new arms, built by g++ for the host.

The emitted source (``csrc/trapezoid.cuh`` with the solution's Spec) runs
its host path: one thread per tile, tiles in order, every level buffer
(the shared-memory ones and the workspace ones) filled with NaN before
every tile, fresh outputs NaN-filled (a cell no pass writes shows).  Each
case runs with the buffers placed as on the card and again with the
workspace placement forced on (``resolve_trapezoid(smem_limit=)``: every
buffer, or all but a few, in the workspace).  One K-step group against
``plain_chunk``: bit-equal (the same operations in the same order),
except that tti calls ``sinf``/``cosf``, where g++'s libm and PyTorch's
vectorised CPU functions differ by an ulp (tests/test_torch_scratch.py's
tolerance, rtol 1e-5, atol 1e-6); tti is held to the bit against K6's own
host path (the same libm) instead.  The member batch (``<name>_trap_
batched``) against each member's solo group, to the bit.
"""

import ctypes
import shutil
import subprocess

import pytest

import yask_tpu_torch
from yask_tpu_torch.compiler.solution_base import create_solution
from yask_tpu_torch.ops import cuda_emit, fused_stencil
from yask_tpu_torch.transfer import import_interiors

from test_torch_fused import CSRC, host_kernel
from test_torch_k4_arms import seeded_physical

#: tests/test_torch_scratch.py: g++'s libm against PyTorch's
LIBM_TOL = dict(rtol=1e-5, atol=1e-6)


def k4_ctx(name, r, sizes, K, eb=4, cli=""):
    """A CPU context of ``name`` at ``eb`` bytes per element under forced
    ``-trapezoid`` (sizes in solution-dim order)."""
    fac = yask_tpu_torch.yk_factory()
    src = create_solution(name, radius=r)
    src.get_soln().set_element_bytes(eb)
    ctx = fac.new_solution(fac.new_env(device="cpu"), src)
    ctx._trapezoid_arg = lambda: True
    dims = " ".join(f"-g_{d} {n}"
                    for d, n in zip(ctx.get_domain_dim_names(), sizes))
    ctx.apply_command_line_options(f"{dims} -mode fused -wf_steps {K} "
                                   f"-trapezoid -no-skew {cli}")
    ctx.prepare_solution()
    import_interiors(ctx, seeded_physical(ctx, 13))
    return ctx


def build(spec, tmp_path):
    """g++ build of an emitted K4 source: (solo entry, batched entry)."""
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to test K4's host path"
    src = tmp_path / f"{spec.name}.cpp"
    so = tmp_path / f"{spec.name}.so"
    src.write_text(spec.source)
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    CSRC, "-o", str(so), str(src)], check=True,
                   capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    fn, bfn = getattr(lib, spec.name), getattr(lib, spec.name
                                                + "_trap_batched")
    fn.argtypes = fused_stencil.trapezoid_argtypes()
    bfn.argtypes = fused_stencil.trap_batched_argtypes()
    fn.restype = bfn.restype = ctypes.c_int
    return fn, bfn


def host_group(fn, prog, spec, state, t0, nm=0):
    """One group through the host entry: NaN-filled fresh outputs (a var
    with unwritten misc slices from its evicted slots), pads re-zeroed,
    rings rotated, as ``trapezoid_chunk`` does; ``nm`` members stacked."""
    import torch
    kern = fused_stencil.TrapezoidKernel(prog, spec)
    kern.dtype = next(iter(state.values()))[0].dtype
    lead = (nm,) if nm else ()
    outs = fused_stencil.trap_outputs(kern, state, "cpu", lead)
    for n, o in zip(spec.outputs, outs):
        if n not in spec.base_outputs:
            o.fill_(float("nan"))
    ins = [state[n][s] for n, s in spec.inputs]
    for p in range(len(spec.trap["passes"])):
        rc = (fused_stencil.call_trap_batched_entry(
                  fn, prog, spec, ins, outs, p, nm, t0, None) if nm else
              fused_stencil.call_trapezoid_entry(fn, prog, spec, ins, outs,
                                                 p, t0, None))
        assert rc == 0
    for n, o in zip(spec.outputs, outs):
        for m in (o if nm else [o]):
            fused_stencil._zero_pads(prog, n, m)
    return fused_stencil._rotated(prog, spec, state, outs)


def assert_states(got, want, **tol):
    import torch
    assert got.keys() == want.keys()
    for n in want:
        for a, b in zip(got[n], want[n]):
            torch.testing.assert_close(a, b, **(tol or dict(rtol=0, atol=0)))


#: (solution, radius, sizes, K, element size, smem limits): every arm of
#: the slice, at the card's limit and with the workspace forced on
CASES = [
    ("ssg", None, (18, 18, 9), 2, 4, (cuda_emit.SMEM_LIMIT, 0)),
    ("tti", 2, (18, 18, 9), 2, 4, (cuda_emit.SMEM_LIMIT, 30000)),
    ("awp", None, (26, 26, 7), 2, 4, (0,)),
    ("gaussian", 2, (28, 12), 2, 4, (cuda_emit.SMEM_LIMIT, 0)),
    # unwritten misc slices, read in global memory (no level buffer)
    ("test_misc_2d", None, (28, 12), 3, 4, (cuda_emit.SMEM_LIMIT,)),
    ("rtm_fwd", 2, (20, 20, 9), 3, 4, (4000,)),
    ("iso3dfd", 2, (34, 34, 11), 2, 2, (cuda_emit.SMEM_LIMIT, 0)),
    ("tti", 2, (18, 18, 9), 2, 2, (30000,))]


@pytest.mark.parametrize("name,r,sizes,K,eb,limits", CASES)
def test_k4_host_path_new_arms_bit_equal_plain(name, r, sizes, K, eb, limits,
                                               tmp_path):
    ctx = k4_ctx(name, r, sizes, K, eb)
    prog = ctx._program
    want = fused_stencil.plain_chunk(prog, ctx._state, 0, K)
    libm = name == "tti"
    for lim in limits:
        spec = cuda_emit.resolve_trapezoid(prog, K, True, smem_limit=lim)
        if lim < cuda_emit.SMEM_LIMIT:
            assert spec.trap["ws_block_bytes"] > 0
        fn, _bfn = build(spec, tmp_path)
        got = host_group(fn, prog, spec, ctx._state, 0)
        if not libm:
            assert_states(got, want)
        elif eb == 4:
            assert_states(got, want, **LIBM_TOL)
        else:
            # an ulp of float before the bfloat16 rounding may move the
            # bfloat16 value by one of its own ulps
            assert_states(got, want, rtol=1e-2, atol=1e-5)


def test_tti_k4_host_bit_equals_k6_host(tmp_path):
    """tti: K4's levels and K6's steps (both g++, the same libm) agree to
    the bit, workspace placement forced on."""
    K = 2
    ctx = k4_ctx("tti", 2, (18, 18, 9), K)
    prog = ctx._program
    spec = cuda_emit.resolve_trapezoid(prog, K, True, smem_limit=30000)
    fn, _bfn = build(spec, tmp_path)
    got = host_group(fn, prog, spec, ctx._state, 0)
    k6 = cuda_emit.emit(prog)
    f6 = host_kernel(k6, tmp_path)
    state = ctx._state
    for t in range(K):
        ins = [state[n][s] for n, s in k6.inputs]
        outs = fused_stencil.copy_base(
            fused_stencil.FusedKernel(prog), state, "cpu")
        assert fused_stencil.call_entry(f6, prog, k6, ins, outs, t,
                                        None) == 0
        state = fused_stencil._rotated(prog, k6, state, outs)
    assert_states(got, state)


@pytest.mark.parametrize("name,r,sizes,eb,lim", [
    ("iso3dfd", 2, (34, 34, 11), 4, cuda_emit.SMEM_LIMIT),
    ("tti", 2, (18, 18, 9), 4, 30000),
    ("gaussian", 2, (28, 12), 2, 0)])
def test_k4_member_batch_host_bit_equals_solo(name, r, sizes, eb, lim,
                                              tmp_path):
    import torch
    K, nm = 2, 3
    ctxs = [k4_ctx(name, r, sizes, K, eb) for _ in range(nm)]
    for i, c in enumerate(ctxs):
        import_interiors(c, seeded_physical(c, 20 + i))
    prog = ctxs[0]._program
    spec = cuda_emit.resolve_trapezoid(prog, K, True, smem_limit=lim)
    fn, bfn = build(spec, tmp_path)
    stacked = {n: [torch.stack([c._state[n][s] for c in ctxs])
                   for s in range(len(ring))]
               for n, ring in ctxs[0]._state.items()}
    got = host_group(bfn, prog, spec, stacked, 0, nm=nm)
    for i, c in enumerate(ctxs):
        solo = host_group(fn, prog, spec, c._state, 0)
        assert_states({n: [a[i] for a in ring] for n, ring in got.items()},
                      solo)


def oldest_read_by_a_later_stage():
    """Two stages: the first writes u, reading u(t-1) at its point (so u
    has 2 slots, the new level taking the oldest one's place); the second
    reads u(t-1) at its point too, after the first wrote this level, and
    u(t+1) at an x offset."""
    from yask_tpu_torch.compiler.solution import yc_factory
    soln = yc_factory().new_solution("oldest_read_by_a_later_stage")
    t, x = soln.new_step_index("t"), soln.new_domain_index("x")
    y, z = soln.new_domain_index("y"), soln.new_domain_index("z")
    u = soln.new_var("u", [t, x, y, z])
    v = soln.new_var("v", [t, x, y, z])
    u(t + 1, x, y, z).EQUALS(u(t, x, y + 1, z) * 0.5
                             + u(t - 1, x, y, z) * 0.25)
    v(t + 1, x, y, z).EQUALS(v(t, x, y, z) * 0.5
                             + u(t + 1, x + 1, y, z) * 0.125
                             + u(t - 1, x, y, z) * 0.25)
    return soln


def test_oldest_slot_read_by_a_later_stage_takes_s_plus_1_buffers(
        tmp_path):
    """ROADMAP.md C18: were u's levels to share its S = 2 buffers, the
    first stage would overwrite u(t-1) before the second reads it; K4
    keeps S + 1 and matches plain_chunk."""
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(device="cpu"),
                           oldest_read_by_a_later_stage())
    ctx._trapezoid_arg = lambda: True
    ctx.apply_command_line_options("-g_x 12 -g_y 12 -g_z 9 -mode fused "
                                   "-wf_steps 3 -trapezoid -no-skew")
    ctx.prepare_solution()
    import_interiors(ctx, seeded_physical(ctx, 5))
    prog = ctx._program
    assert prog.geoms["u"].num_slots == 2 and len(prog.ana.stages) == 2
    spec = ctx._trapezoid_kernel().spec
    # u: S + 1 = 3; v: its one slot, read at the point by its writer
    # alone, level over level in place
    assert prog.geoms["v"].num_slots == 1
    assert spec.trap["buffers"] == 3 + 1
    fn, _bfn = build(spec, tmp_path)
    assert_states(host_group(fn, prog, spec, ctx._state, 0),
                  fused_stencil.plain_chunk(prog, ctx._state, 0, 3))


def test_in_place_ring_needs_every_read_of_the_oldest_slot_at_the_point():
    """A ring of S buffers (level L over level L-S in place) only where
    the oldest slot is read at the point by the sub-stage that writes the
    slice; a read at an offset, or by another sub-stage, takes S+1."""
    iso = k4_ctx("iso3dfd", 2, (34, 34, 11), 2)
    spec = iso._trapezoid_kernel().spec
    # pressure: 2 slots, t-1 read at the point: 2 buffers
    assert spec.trap["buffers"] == 2
    ssg = k4_ctx("ssg", None, (18, 18, 9), 2)
    sspec = ssg._trapezoid_kernel().spec
    rings = sum(g.num_slots for g in ssg._program.geoms.values()
                if g.is_written and not g.is_scratch)
    assert sspec.trap["buffers"] > rings
