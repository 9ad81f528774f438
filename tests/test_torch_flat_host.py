"""K6's flat arm through the g++ host path: every 1-D and 2-D solution K6
carries (a solution that leaves slot 0 unused) takes the flat arm of the
emitter (wide tiles served by fewer threads, resident blocks walking the
tiles, two staged buffers), and its entries built for the host
(``host_stages``, which runs the same ``Spec::stage<K>`` and, like the
device code, zeroes every output's pads) give ``plain_chunk``'s bits.

Each solution at element sizes 4 and 2, on a ragged grid (three tiles in
each tiled slot, a partial last one), from random interiors with nonzero
pads on the read-only inputs (a scratch var is computed past the domain
and reads them), into NaN-filled outputs: K6's entry and K7's (two
members whose stacks sit apart by more than a member, as a padded
stride) against ``plain_chunk`` and ``plain_batched_chunk`` over whole
tensors, pads included, and K5's over a box of the domain against
``plain_shard_chunk``, to the bit.  Tolerance: none, but for
test_func_1d's math functions, where g++'s libm and PyTorch's vectorized
CPU functions may differ by an ulp of float: rtol 1e-5, atol 1e-6 at
element size 4 (as tti's elsewhere); at element size 2 such an ulp flips
a bfloat16 rounding, which the later ops carry (up to 2 bfloat16 ulps
seen), so 3e-2, the bfloat16 tolerance of tests/test_torch_bf16.py."""

import ctypes

import pytest

import yask_tpu_torch
from yask_tpu_torch.compiler.solution_base import create_solution
from yask_tpu_torch.ops import cuda_emit, fused_stencil

from test_torch_fused import host_kernel
from test_torch_k7_host import bind, padded
from test_torch_scratch import with_pads

#: the 2-D and 1-D solutions K6 carries
FLAT_2D = ("box", "gaussian", "swe2d", "test_boundary_2d",
           "test_misc_value_2d", "test_scratch_2d", "test_stages_2d")
FLAT_1D = ("test_boundary_1d", "test_func_1d", "test_scratch_1d",
           "test_scratch_boundary_1d", "test_scratch_stages_1d",
           "test_stages_1d", "test_step_cond_1d")
FLAT = FLAT_2D + FLAT_1D
RADIUS = {"gaussian": 2, "box": 2}
#: three tiles or more per tiled slot, the last partial: 64x64 (32x64
#: for swe2d) in 2-D, 4096 points in 1-D
RAGGED_2D, RAGGED_1D = "-g_x 150 -g_y 150", "-g 9000"
#: (rtol, atol) against the plain version per element size: 0 but for
#: libm's functions
LIBM = {("test_func_1d", 4): (1e-5, 1e-6),
        ("test_func_1d", 2): (3e-2, 3e-2)}


def flat_ctx(name, eb=4, cli="", sizes=(RAGGED_1D, RAGGED_2D)):
    """A prepared ``-mode fused`` context of ``name`` at element size
    ``eb`` on its ragged grid (``sizes``: the 1-D and the 2-D one; ``cli``
    adds options)."""
    fac = yask_tpu_torch.yk_factory()
    src = create_solution(name, radius=RADIUS.get(name))
    src.get_soln().set_element_bytes(eb)
    ctx = fac.new_solution(fac.new_env(device="cpu"), src)
    size = sizes[0] if name in FLAT_1D else sizes[1]
    ctx.apply_command_line_options(f"{size} -mode fused {cli}")
    ctx.prepare_solution()
    return ctx


def tol(name, eb):
    rtol, atol = LIBM.get((name, eb), (0.0, 0.0))
    return dict(rtol=rtol, atol=atol)


def fresh_outputs(prog, spec, state, lead=()):
    """One sub-step's outputs as the flat arm's wrapper allocates them,
    with NaN where it takes ``torch.empty``: a copy of the evicted slot
    for a var with unwritten misc slices, zeros for a partial-dim one."""
    import torch
    dims = list(prog.ana.domain_dims)
    dtype = state[spec.inputs[0][0]][0].dtype
    out = []
    for n in spec.outputs:
        shape = tuple(lead) + tuple(prog.geoms[n].shape)
        if n in spec.base_outputs:
            out.append(state[n][0].clone())
        else:
            full = list(prog.geoms[n].domain_dims) == dims
            out.append(torch.full(shape, float("nan") if full else 0.0,
                                  dtype=dtype))
    return out


def inner_box(prog, spec):
    """K5's box: per dim from one past the lowest start the inputs' reads
    and pads allow to 5 short of the interior's end, or less where the
    reads above would pass the pads (a partial first and last tile)."""
    slot = cuda_emit.slot_map(prog.ana.domain_dims)
    box = {}
    for d, s_ in slot.items():
        reads = [(prog.geoms[n].pads[d], spec.reach[a][s_])
                 for a, (n, _s) in enumerate(spec.inputs)
                 if d in prog.geoms[n].domain_dims]
        n = prog.sizes[d]
        box[d] = (1 + max(r[0] - p[0] for p, r in reads),
                  min([n - 5] + [n + p[1] - r[1] for p, r in reads]))
    return box


def stacked(ctx, nm, seed):
    """``nm`` members' states (random interiors, nonzero pads on the
    read-only inputs) stacked as (nm, *shape)."""
    ens = ctx.new_ensemble(nm)
    for i in range(nm):
        with ens.member(i) as c:
            with_pads(c, seed + i)
    return ens._stack_states()


@pytest.mark.parametrize("eb", [4, 2])
@pytest.mark.parametrize("name", FLAT)
def test_flat_arm_host_entries_match_plain(name, eb, tmp_path):
    import torch
    ctx = flat_ctx(name, eb)
    with_pads(ctx, 17)
    prog = ctx._program
    spec = cuda_emit.emit(prog)
    flat = spec.flat
    assert flat["code"] == "flat_engaged" and spec.stages > 1
    assert f"FLAT_NT = {flat['threads']}" in spec.source
    assert flat["points_per_thread"] > 1 and spec.tile[0] == 1
    assert flat["smem_bytes"] == spec.smem_bytes <= cuda_emit.SMEM_LIMIT
    fn = host_kernel(spec, tmp_path)
    state = ctx._state
    for t in range(2):
        outs = fresh_outputs(prog, spec, state)
        assert fused_stencil.call_entry(
            fn, prog, spec, [state[n][s] for n, s in spec.inputs], outs, t,
            None) == 0
        state = fused_stencil.plain_chunk(prog, state, t, 1)
        for n, a in zip(spec.outputs, outs):
            torch.testing.assert_close(a, state[n][-1], **tol(name, eb))
    # K7: two members, their stacks a padded stride apart
    nm = 2
    stack = stacked(ctx, nm, 23)
    bfn = bind(tmp_path / f"{spec.name}.so", spec.name + "_batched", True)
    ins = [padded(stack[n][s], 5) for n, s in spec.inputs]
    outs = [padded(o, 3) for o in fresh_outputs(prog, spec, stack, (nm,))]
    assert fused_stencil.call_batched_entry(bfn, prog, spec, ins, outs, nm,
                                            0, None) == 0
    want = fused_stencil.plain_batched_chunk(prog, stack, 0, 1, nm)
    for n, a in zip(spec.outputs, outs):
        torch.testing.assert_close(a, want[n][-1], **tol(name, eb))
    # K5: a box of the domain at global origin 0, outputs zeroed as its
    # wrapper makes them
    box = inner_box(prog, spec)
    fused_stencil.check_box(prog, spec, box)
    rfn = getattr(ctypes.CDLL(str(tmp_path / f"{spec.name}.so")),
                  spec.name + "_region")
    rfn.argtypes = fused_stencil.region_argtypes(True)
    rfn.restype = ctypes.c_int
    ins = [state[n][s] for n, s in spec.inputs]
    outs = [state[n][0].clone() if n in spec.base_outputs
            else torch.zeros_like(state[n][0]) for n in spec.outputs]
    assert fused_stencil.call_region_entry(rfn, prog, spec, ins, outs, box,
                                           {}, 0, None) == 0
    want = fused_stencil.plain_shard_chunk(
        fused_stencil._with_offset(prog, {}, torch.device("cpu")), state, 0,
        box, spec.base_outputs)
    for n, a in zip(spec.outputs, outs):
        torch.testing.assert_close(a, want[n][-1], **tol(name, eb))
