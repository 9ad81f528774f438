"""K6's stream arm with its rings past shared memory: the plans of the
solutions whose rings fit no plane tile (tti, ssg and fsg at r=8), the
reads of a staged input without a ring, and the device code run on the
CPU with a lowered shared-memory limit (the g++ shim of
tests/test_torch_kernel_emulation.py).

Where no rung's rings fit ``cuda_emit.SMEM_LIMIT`` the computed rings
take shared memory first, by first fit, and those that do not fit a
workspace slice per resident block; then the staged inputs' rings, by
their readers' reads per byte; an input left without a ring is read from
its own allocation.  The emulated cases lower the limit so that staged
inputs go without rings and one computed ring goes to the workspace,
which the launch hands in NaN-filled.  Tolerance: none against the plain
version for ssg; for tti none against the g++ host path of the same
entry, and rtol 1e-5 and atol 1e-6 against the plain version (g++'s
libm ``sinf``/``cosf`` and PyTorch's CPU ``sin``/``cos`` differ by an
ulp)."""

import re

import pytest

import yask_tpu_torch
from yask_tpu_torch.ops import cuda_emit, fused_stencil, tile_planner
from yask_tpu_torch.parallel.shard_step import _full_box, shard_pallas_plan

from test_torch_kernel_emulation import emulated_kernel
from test_torch_scratch import port_ctx, with_pads
from test_torch_stream_stages_emulation import RUNG, SEG, same
from test_torch_stream_stages_emulation_checks import member_stacks
from test_torch_stream_stages_host import ENGAGED, SCRATCH, host_entry

#: the solutions whose rings fit no plane tile, at r=8
PLACED = [("tti", 8), ("ssg", 8), ("fsg", 8)]
RAGGED = "-g_x 14 -g_y 9 -g_z 70"
#: the lowered limits (bytes of shared memory) at which the 8x32 rung's
#: staged inputs go without rings and one computed ring goes to the
#: workspace: ssg r=2's velocity rings (2160 + 1728 + 1728 cells) and
#: tti r=2's six (4 x 1296 + 2 x 2160)
LIMITS = {"ssg": 4 * (2160 + 1728 + 400), "tti": 4 * (4 * 1296 + 2160 + 400)}


def ctx_of(name, r, eb, g="-g 12"):
    """A context of ``name`` at radius ``r`` and element size ``eb`` on
    the CPU (``-mode fused``)."""
    from yask_tpu_torch.compiler.solution_base import create_solution
    fac = yask_tpu_torch.yk_factory()
    src = create_solution(name, radius=r)
    src.get_soln().set_element_bytes(eb)
    ctx = fac.new_solution(fac.new_env(device="cpu"), src)
    ctx.apply_command_line_options(f"{g} -mode fused")
    ctx.prepare_solution()
    return ctx


@pytest.mark.parametrize("eb", [4, 8])
@pytest.mark.parametrize("name,r", PLACED)
def test_r8_plans_place_their_rings_past_shared_memory(name, r, eb):
    """The computed rings first, the staged inputs after them; the
    workspace slice within the cap, the blocks within the L2; the stream
    arm engaged, solo and over member batches, with its placement in its
    reason.  (The placement does not depend on the domain's size, only
    the segments do: a small domain keeps the CPU's state small.)"""
    ctx = ctx_of(name, r, eb)
    kern = ctx._fused_spec_kernel()
    plan = kern.spec.stages_stream
    assert kern.spec.workspace and plan.placed
    assert plan.smem_bytes <= cuda_emit.SMEM_LIMIT
    assert 0 <= plan.ws_elems * eb <= cuda_emit.WS_STAGES_BLOCK_BYTES
    if plan.ws_elems:
        assert plan.ws_elems * eb * plan.ws_blocks <= tile_planner.L2_BYTES
    # the computed rings took shared memory before any staged input
    cmp_smem = [o for o, p in zip(plan.cmp_offsets, plan.cmp_place)
                if p == "smem"]
    assert cmp_smem and all(o > max(cmp_smem)
                            for o in plan.in_offsets.values())
    assert "global" in plan.in_place.values()
    assert all(o < plan.smem_elems for a, o in plan.in_offsets.items())
    assert "SS_WS_ELEMS = " in kern.spec.source \
        and "ss_glob(int k)" in kern.spec.source
    for batched in (False, True):
        reasons = []
        assert cuda_emit.skew_engaged_dims(ctx._program, reasons=reasons,
                                           spec=kern.spec,
                                           batched=batched) == ["x"]
        assert reasons[0]["kernel"] == "stages_stream"
        assert "rings past shared memory" in reasons[0]["detail"]
    rec = kern.tiling(1)["stages_stream"]
    assert rec["ws_block_bytes"] == plan.ws_elems * eb
    assert set(rec["ring_places"].values()) <= {"smem", "global"}
    assert set(rec["computed_ring_places"]) <= {"smem", "workspace"}


@pytest.mark.parametrize("eb", [4, 8])
@pytest.mark.parametrize("name,r", [("tti", 2), ("tti", 4),
                                    ("test_scratch_3d", None)])
def test_scratch_solutions_engage_solo_and_batched(name, r, eb):
    """The scratch solutions the arm newly takes engage it at element
    sizes 4 and 8, solo and over member batches (tti r=4's rings at 8
    bytes partly past shared memory), and at element size 2 too, solo
    and batched, with no element-size reason (its rings of bfloat16
    pairs)."""
    ctx = ctx_of(name, r, eb)
    spec = ctx._fused_spec_kernel().spec
    assert spec.scratch_stages > 0
    for batched in (False, True):
        reasons = []
        assert cuda_emit.skew_engaged_dims(ctx._program, reasons=reasons,
                                           spec=spec,
                                           batched=batched) == ["x"]
        assert reasons[0]["code"] == "skew_engaged"
        assert reasons[0]["kernel"] == "stages_stream"
    assert spec.stages_stream.smem_bytes <= cuda_emit.SMEM_LIMIT
    bf = ctx_of(name, r, 2)
    for batched in (False, True):
        reasons = []
        assert cuda_emit.skew_engaged_dims(bf._program, reasons=reasons,
                                           batched=batched) == ["x"]
        assert reasons[0]["code"] == "skew_engaged"
        assert reasons[0]["kernel"] == "stages_stream"
        assert not any("element size 2" in x.get("detail", "")
                       for x in reasons)


#: at element size 2, per r=8 solution: (the plane tile, whether some
#: staged input is read from its allocation, whether a computed ring lies
#: in a workspace); tti, ssg and fsg keep every computed ring in shared
#: memory, test_scratch_3d and test_stages_3d every ring
R8_AT_2 = {"tti": ((16, 32), True, False), "ssg": ((16, 32), True, False),
           "fsg": ((16, 32), True, False),
           "test_scratch_3d": ((8, 32), False, False),
           "test_stages_3d": ((8, 32), False, False)}


@pytest.mark.parametrize("name", list(R8_AT_2))
def test_r8_rings_at_element_size_2(name):
    """bfloat16 rings are half the bytes: at r=8 the computed rings that
    went to a workspace at element size 4 fit shared memory at 2, and
    test_scratch_3d's and test_stages_3d's rings all fit it (at 8x32 by
    256 threads); where some ring stays past it the plan is placed, its
    workspace empty."""
    spec4 = ctx_of(name, 8, 4)._fused_spec_kernel().spec.stages_stream
    kern = ctx_of(name, 8, 2)._fused_spec_kernel()
    plan = kern.spec.stages_stream
    assert kern.skew_dims == ["x"] and plan.esize == 2
    tile, glob, ws = R8_AT_2[name]
    assert plan.tile == tile
    assert ("global" in plan.in_place.values()) == glob
    assert ("workspace" in plan.cmp_place) == ws == (plan.ws_elems > 0)
    assert plan.placed == (glob or ws)
    assert spec4.placed
    assert ("workspace" in spec4.cmp_place) == (name != "test_stages_3d")
    assert plan.smem_bytes <= cuda_emit.SMEM_LIMIT
    # a staged ring's row at element size 2: the pair shift's cell more,
    # rounded up to even
    for a, elems in plan.in_elems.items():
        halo = kern.spec.halos[a]
        row = tile_planner.stream_row(tile[1] + sum(halo[2]), 2)
        assert elems == -(-(plan.in_depths[a] * (tile[0] + sum(halo[1]))
                            * row) // 8) * 8


def test_the_rung_with_the_fewest_bytes_outside_shared_memory():
    """tti r=8 at element size 4: of the rungs whose workspace slices fit
    the cap, the plan takes the one whose ring-less inputs' reads and
    workspace rings' traffic are the fewest bytes per point."""
    ctx = ctx_of("tti", 8, 4)
    prog = ctx._program
    best = ctx._fused_spec_kernel().spec.stages_stream
    for rung in tile_planner.STAGES_STREAM_TILES:
        other = cuda_emit.emit(prog, stream_tiles=(rung,)).stages_stream
        assert other.outside_per_point >= best.outside_per_point


@pytest.mark.parametrize("name,r",
                         [(n, None) for n in ENGAGED + SCRATCH] + PLACED)
def test_reads_of_staged_inputs_stay_inside_their_allocations(name, r):
    """Every read of a staged input by a cell of a sub-stage's plain
    region (the domain grown by its clip: a scratch var's write halo)
    lies inside the input's allocation, so an input read without a ring
    needs no guard: the zeros its ring would hold past the allocation are
    read only by cells outside the plain region, which hold 0."""
    ctx = ctx_of(name, r, 4)
    prog = ctx._program
    pt = cuda_emit._print(prog, [])
    dims = list(prog.ana.domain_dims)
    spec = ctx._fused_spec_kernel().spec
    for a in spec.tiled:
        g = prog.geoms[spec.inputs[a][0]]
        for j, offs in pt.pr.offs3[a].items():
            u = pt.subs[j]
            for o in offs:
                for s_, d in enumerate(dims):
                    lo, hi = g.pads[d]
                    assert u.clip_lo[s_] - o[s_] <= lo, (a, j, o, d)
                    assert u.clip_hi[s_] + o[s_] <= hi, (a, j, o, d)


@pytest.mark.parametrize("name,r",
                         [(n, None) for n in ENGAGED + SCRATCH] + PLACED)
def test_k5_reads_of_staged_inputs_stay_inside_the_shards_allocation(name,
                                                                     r):
    """K5 over the arm: on 2x2 shards of a group of 2 steps, every read
    of a staged input by a cell of a sub-stage's plain region over a
    sub-step's box (``plain_region<S, K, true>``: the global domain grown
    by its clip, in box coordinates, kept to the box grown by the
    sub-stage's region) lies inside the shard's allocation, on every
    shard, so an input read without a ring needs no guard there either."""
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(devices=["cpu"] * 4), stencil=name,
                           radius=r)
    ctx.apply_command_line_options(
        "-g_x 64 -g_y 64 -g_z 12 -mode shard_pallas -wf_steps 2 -nr_x 2 "
        "-nr_y 2")
    ctx.prepare_solution()
    sp = shard_pallas_plan(ctx)
    kern = sp.kernel
    assert kern.skew_dims == ["x"]
    prog = kern.program
    spec = kern.spec
    pt = cuda_emit._print(prog, [])
    dims = list(prog.ana.domain_dims)
    for off in sp.layout.offsets:
        for s_ in range(2):
            box = _full_box(sp, 2, s_)
            for a in spec.tiled:
                g = prog.geoms[spec.inputs[a][0]]
                for j, offs in pt.pr.offs3[a].items():
                    u = pt.subs[j]
                    for q, d in enumerate(dims):
                        blo, bhi = box[d]
                        go = blo + off.get(d, 0)
                        lo = max(-u.clip_lo[q] - go, -u.lo[q])
                        hi = min(prog.global_last[d] + 1 + u.clip_hi[q] - go,
                                 bhi - blo + u.hi[q])
                        plo, phi = g.pads[d]
                        for o in offs if lo < hi else ():
                            assert blo + lo + o[q] >= -plo, (a, j, o, d)
                            assert blo + hi - 1 + o[q] \
                                <= prog.sizes[d] - 1 + phi, (a, j, o, d)


def placed_spec(ctx, name, monkeypatch):
    """``ctx``'s spec at the 8x32 rung under the lowered limit: its staged
    inputs without rings, one computed ring in the workspace."""
    with monkeypatch.context() as m:
        m.setattr(cuda_emit, "SMEM_LIMIT", LIMITS[name])
        spec = cuda_emit.emit(ctx._program, stream_tiles=(RUNG,))
    plan = spec.stages_stream
    assert set(plan.in_place.values()) == {"global"}
    assert plan.cmp_place.count("workspace") == 1 and plan.ws_elems > 0
    return spec


def launch_ws(fn, ctx, spec, state, t, nres, ins=None):
    """One sub-step through the entry into NaN-filled outputs, with a
    NaN-filled workspace of ``nres`` slices; returns the outputs."""
    import torch
    prog = ctx._program
    ins = ins or [state[n][s] for n, s in spec.inputs]
    outs = [torch.full(tuple(prog.geoms[n].shape), float("nan"))
            for n in spec.outputs]
    ws = torch.full((nres * spec.stages_stream.ws_elems,), float("nan"))
    assert fused_stencil.call_stages_stream_entry(
        fn, prog, spec, ins, outs, t, None, seg=SEG, nres=nres, ws=ws) == 0
    return outs


def check(ctx, spec, name, got, host, want):
    import torch
    assert same(got, host)
    if name != "tti":
        assert same(got, want)
        return
    for n, a, w in zip(spec.outputs, got, want):
        idx = ctx._interior_idx(n)
        torch.testing.assert_close(a[idx], w[idx], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["ssg", "tti"])
def test_rings_past_shared_memory_match_when_emulated(name, tmp_path,
                                                      monkeypatch):
    """Two sub-steps on 2 and 3 blocks: the emulated arm with every staged
    input read from its allocation and one computed ring in the
    workspace, bit-equal to the g++ host path and to the plain version
    (tti within its libm tolerance)."""
    ctx = port_ctx(name, 2, f"{RAGGED} -mode fused")
    with_pads(ctx, 21)
    spec = placed_spec(ctx, name, monkeypatch)
    fn = emulated_kernel(spec, tmp_path, entry=spec.name + "_stages_stream")
    (tmp_path / "host").mkdir()
    host = host_entry(spec, tmp_path / "host", "_stages_stream")
    state = ctx._state
    for t, nres in ((0, 2), (1, 3)):
        got = launch_ws(fn, ctx, spec, state, t, nres)
        hout = launch_ws(host, ctx, spec, state, t, 1)
        want = fused_stencil.plain_chunk(ctx._program, state, t, 1)
        check(ctx, spec, name, got, hout, [want[n][-1] for n in spec.outputs])
        state = want


def test_k7_over_rings_past_shared_memory_when_emulated(tmp_path,
                                                        monkeypatch):
    """K7 over the placed arm: ssg r=2, 3 members a padded stride apart,
    each member's outputs bit-equal to its solo plain step."""
    import torch
    ctx = port_ctx("ssg", 2, f"{RAGGED} -mode fused")
    spec = placed_spec(ctx, "ssg", monkeypatch)
    prog = ctx._program
    fn = emulated_kernel(spec, tmp_path,
                         entry=spec.name + "_stages_stream_batched")
    states, ins, outs = member_stacks(ctx, spec, (31, 32, 33))
    ws = torch.full((4 * spec.stages_stream.ws_elems,), float("nan"))
    assert fused_stencil.call_batched_stages_stream_entry(
        fn, prog, spec, ins, outs, 3, 0, None, seg=SEG, nres=4, ws=ws) == 0
    for i, st in enumerate(states):
        want = fused_stencil.plain_chunk(prog, st, 0, 1)
        assert same([o[i] for o in outs],
                    [want[n][-1] for n in spec.outputs]), i


def test_emulation_fails_when_ring_less_reads_stop_at_the_domain(
        tmp_path, monkeypatch):
    """A ring-less input read as 0 past the domain (a guard at the domain
    instead of the allocation) changes ssg's velocities at the domain's
    faces, which read the stresses in the pads: the reads of a ring-less
    input do reach the pads, and the emulation sees them."""
    ctx = port_ctx("ssg", 2, f"{RAGGED} -mode fused")
    with_pads(ctx, 21)
    spec = placed_spec(ctx, "ssg", monkeypatch)

    def domain_guard(fn, text):
        if fn != "stream_stages.cuh":
            return text
        text, n = re.subn(
            r"return global_at<S>\(\*p, A, m, 0, g0 \+ o0, g1 \+ o1, "
            r"g2 \+ o2\);",
            "const int c0 = g0 + o0, c1 = g1 + o1, c2 = g2 + o2;\n"
            "      if (k >= 0 && (c0 < 0 || c0 >= p->n[0] || c1 < 0\n"
            "                     || c1 >= p->n[1] || c2 < 0\n"
            "                     || c2 >= p->n[2]))\n"
            "        return typename S::real_t(0);\n"
            "      return global_at<S>(*p, A, m, 0, c0, c1, c2);", text)
        assert n == 1
        return text
    emu = emulated_kernel(spec, tmp_path, entry=spec.name + "_stages_stream",
                          edit=domain_guard)
    want = fused_stencil.plain_chunk(ctx._program, ctx._state, 0, 1)
    got = launch_ws(emu, ctx, spec, ctx._state, 0, 3)
    assert not same(got, [want[n][-1] for n in spec.outputs])

