"""K1's stream arm past three domain dims on the host: the gate, the
segment rule and the g++ host path of the solo and K7 entries.

``csrc/stream_step.cuh`` takes a single-stage solution with outer dims
(a Spec that prints ``NOUTER``): each outer cell a coordinate of the work
items beside the segments and the member, each read at an outer offset an
input of its own (``KernelSpec.in_outer``, as on K1's body), the pad pass
over every slot's pads.  The source carries ``<name>_stream`` and
``<name>_stream_batched`` (``YT_FUSED_STREAM_OUTER_ENTRY``: K5 over it
walks a 3-D box, so a 4-D source has no ``_stream_region``).

* Under ``-skew`` (the default) test_4d engages the arm solo and over
  member batches; ``-no-skew`` keeps K1's body (``skew_disabled``);
  four_d_partial keeps the body with its partial-dim reason; K5 over a
  test_4d shard keeps its body with a reason that names K1's arm.
* The plan keeps 40 registers a thread past three dims and, of the rungs
  keeping 1,536 threads an SM, takes the one staging the fewest in-plane
  cells a point; the segment rule counts the outer
  cells among the columns: at 128⁴ and 8 × 64⁴ slot 0 walks in segments
  of 64 planes, not the few planes the plane columns alone would give.
* The emitted entries built by g++ (the host path: K1's host loop over
  every outer cell and member, then the pads) against ``plain_chunk`` and
  ``plain_batched_chunk`` into NaN-filled outputs, at element sizes 4, 8
  and 2 (bfloat16 with an odd minor pad, ``-mp_z 1``), slot 0 in two
  segments, 3 members of different states: bit-equal, pads included.
tests/test_torch_stream_k1_4d_emulation.py runs the same cases as device
code.
"""

import ctypes

import pytest

import yask_tpu_torch
from yask_tpu_torch.compiler.solution_base import create_solution
from yask_tpu_torch.ops import cuda_emit, fused_stencil, tile_planner
from yask_tpu_torch.parallel.shard_step import shard_pallas_plan

from test_torch_4d import four_d_partial
from test_torch_stream_k5k7_host import (codes, host_lib, member_states,
                                         two_segments)

#: element bytes -> the ragged 4-D sizes of the entry cases (w outer; x
#: slot 0, two segments; y and z partial against the plane tiles)
SIZES = {4: "-g_w 3 -g_x 10 -g_y 6 -g_z 40",
         8: "-g_w 3 -g_x 10 -g_y 6 -g_z 40",
         2: "-g_w 3 -g_x 10 -g_y 6 -g_z 40 -mp_z 1"}
NM = 3

#: built host libraries of the module, by source name
_LIBS = {}


def ctx_4d(eb: int, cli: str, env=None, src=None):
    """A prepared test_4d context at ``eb`` bytes an element (or one of
    the solution ``src``, as built)."""
    fac = yask_tpu_torch.yk_factory()
    if src is None:
        src = create_solution("test_4d")
        src.get_soln().set_element_bytes(eb)
    ctx = fac.new_solution(env or fac.new_env(device="cpu"), src)
    ctx.apply_command_line_options(cli)
    ctx.prepare_solution()
    return ctx


def emitted(prog, tiles=None):
    """``cuda_emit.emit(prog)``, with the stream arm planned over the
    plane tiles ``tiles`` alone where given."""
    orig = tile_planner.STREAM_TILES
    tile_planner.STREAM_TILES = tiles or orig
    try:
        spec = cuda_emit.emit(prog)
    finally:
        tile_planner.STREAM_TILES = orig
    assert spec.stream is not None and spec.outer == 1
    return spec


def slot0_extent(prog) -> int:
    """The extent of slot 0, the walk's dim (the first of the last three
    domain dims)."""
    return prog.sizes[prog.ana.domain_dims[-3]]


def bind(lib, spec, entry):
    """Entry ``_stream`` or ``_stream_batched`` of ``lib``."""
    fn = getattr(lib, spec.name + entry)
    fn.argtypes = (fused_stencil.batched_stream_argtypes()
                   if entry.endswith("_batched")
                   else fused_stencil.stream_argtypes())
    fn.restype = ctypes.c_int
    return fn


def nan_like(prog, spec, dtype, lead=()):
    import torch
    return [torch.full(tuple(lead) + tuple(prog.geoms[n].shape),
                       float("nan"), dtype=dtype) for n in spec.outputs]


def solo_steps(fn, prog, spec, wrap=None, strays=None, steps: int = 2):
    """``steps`` sub-steps through the solo entry ``fn`` into NaN-filled
    outputs, slot 0 walked in two segments, against ``plain_chunk``: every
    cell's bits, pads included; ``wrap`` puts each input in a margin of
    stray words, ``strays()`` counts the reads of them."""
    import torch
    state = member_states(prog, 1, 7)
    state = {n: [a[0] for a in ring] for n, ring in state.items()}
    seg = two_segments(slot0_extent(prog))
    for t in range(steps):
        ins = [(wrap or (lambda a: a))(state[n][k]) for n, k in spec.inputs]
        outs = nan_like(prog, spec, ins[0].dtype)
        if strays:
            strays()
        assert fused_stencil.call_stream_entry(fn, prog, spec, ins, outs, t,
                                               None, seg) == 0
        if strays:
            assert strays() == 0, "an input was read past its allocation"
        want = fused_stencil.plain_chunk(prog, state, t, 1)
        for n, got in zip(spec.outputs, outs):
            torch.testing.assert_close(got, want[n][-1], rtol=0, atol=0,
                                       equal_nan=False)
        assert want[spec.outputs[0]][-1].float().abs().max() > 0
        state = want


def batch_steps(fn, prog, spec, wrap=None, strays=None, nm: int = NM,
                steps: int = 2):
    """``steps`` sub-steps of ``nm`` members through the batch entry
    ``fn`` into NaN-filled stacks, slot 0 walked in two segments, against
    ``plain_batched_chunk``: every member's bits, pads included."""
    import torch
    state = member_states(prog, nm, 11)
    seg = two_segments(slot0_extent(prog))
    for t in range(steps):
        ins = [(wrap or (lambda a: a))(state[n][k]) for n, k in spec.inputs]
        outs = nan_like(prog, spec, ins[0].dtype, (nm,))
        if strays:
            strays()
        assert fused_stencil.call_batched_stream_entry(
            fn, prog, spec, ins, outs, nm, t, None, seg) == 0
        if strays:
            assert strays() == 0, "an input was read past its allocation"
        want = fused_stencil.plain_batched_chunk(prog, state, t, 1, nm)
        for n, got in zip(spec.outputs, outs):
            for i in range(nm):
                torch.testing.assert_close(got[i], want[n][-1][i], rtol=0,
                                           atol=0)
        state = want
    # the members really differ
    out = state[spec.outputs[0]][-1]
    assert not torch.equal(out[0], out[1])


def host_entry(spec, tmp_path, entry):
    if spec.name not in _LIBS:
        _LIBS[spec.name] = host_lib(spec, tmp_path)
    return bind(_LIBS[spec.name], spec, entry)


@pytest.mark.parametrize("eb", [4, 8, 2])
@pytest.mark.parametrize("entry", ["_stream", "_stream_batched"])
def test_host_path_of_the_4d_stream_arm_matches_plain(entry, eb, tmp_path):
    ctx = ctx_4d(eb, f"{SIZES[eb]} -mode fused")
    prog = ctx._program
    spec = emitted(prog)
    assert "YT_FUSED_STREAM_OUTER_ENTRY" in spec.source
    assert "_region(" not in spec.source.split("YT_FUSED_STREAM_OUTER")[-1]
    fn = host_entry(spec, tmp_path, entry)
    (batch_steps if entry.endswith("_batched") else solo_steps)(
        fn, prog, spec)


# ---------------------------------------------------------------------------
# the gate, the records and the segments
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("eb", [4, 2])
def test_test_4d_takes_the_arm_solo_and_in_batches(eb):
    """test_4d engages K1's stream arm solo (``_stream``) and over member
    batches (``_stream_batched``), its record naming the outer cells and
    the segment; ``-no-skew`` keeps K1's body with ``skew_disabled``."""
    kern = ctx_4d(eb, "-g 8 -mode fused")._fused_spec_kernel()
    assert kern.skew_dims == ["x"] and kern.spec.stages == 1
    til = kern.tiling(1)
    assert til["kernel"] == "stream_step" and til["skew"] is True
    assert til["name"] == kern.spec.name + "_stream"
    assert til["stream"]["outer_cells"] == 8
    assert til["stream"]["segment_planes"] * til["stream"]["segments"] >= 8
    rec = til["skew_reasons"][0]
    assert rec["code"] == "skew_engaged" and rec["dim"] == "x"
    assert "8 outer cell(s) in w" in rec["detail"]
    assert "segment(s) of" in rec["detail"]
    w = next(r for r in til["skew_reasons"] if r.get("dim") == "w")
    assert w["code"] == "skew_ineligible"
    assert "coordinate of its work items" in w["detail"]
    til = kern.tiling(1, members=3)
    assert til["kernel"] == "batched_step" and til["skew"] is True
    assert til["name"] == kern.spec.name + "_stream_batched"
    assert til["skew_reasons"][0]["kernel"] == "stream_batched"
    assert "3 members" in til["skew_reasons"][0]["detail"]
    body = ctx_4d(eb, "-g 8 -mode fused -no-skew")._fused_spec_kernel()
    for members in (0, 3):
        til = body.tiling(1, members)
        assert til["skew"] is False
        assert til["name"] == body.spec.name + ("_batched" if members
                                                else "")
        assert codes(til["skew_reasons"]) == ["skew_disabled"]
    assert body.spec.source == kern.spec.source


def test_four_d_partial_keeps_k1s_body_with_the_partial_dim_reason():
    kern = ctx_4d(4, "-g_w 4 -g_x 9 -g_y 11 -g_z 70 -mode fused",
                  src=four_d_partial("yask_tpu_torch"))._fused_spec_kernel()
    assert kern.skew_dims == [] and kern.spec.stream is None
    til = kern.tiling(1)
    assert til["name"] == kern.spec.name and til["skew"] is False
    assert set(codes(til["skew_reasons"])) == {"skew_ineligible"}
    assert "partial-dim" in til["skew_reasons"][0]["detail"]
    assert "_stream" not in kern.spec.source.split("struct Spec")[-1]


def test_k5_over_a_4d_box_keeps_its_body_naming_k1s_arm():
    fac = yask_tpu_torch.yk_factory()
    shard = ctx_4d(4, "-g 8 -mode shard_pallas -nr_x 2",
                   env=fac.new_env(devices=["cpu"] * 2))
    k5 = shard_pallas_plan(shard).kernel
    assert k5.skew_dims == [] and k5.region
    assert set(codes(k5.skew_reasons)) == {"skew_ineligible"}
    detail = k5.skew_reasons[0]["detail"]
    assert "4-D solution" in detail and "K1's" in detail
    assert k5.tiling(1)["skew"] is False
    # the shard's source holds the solo arm; K5 keeps its body's entry
    assert k5.spec.stream is not None and k5.stream_region_fn is None


@pytest.mark.parametrize("g,members", [(128, 0), (64, 8)])
def test_segments_count_the_outer_cells(g, members):
    """At 128⁴ (solo) and 8 × 64⁴ (K7) the columns the waves count hold
    the outer cells (and members): slot 0 walks in at most two segments
    of 64 planes, where the three slot extents alone would cut it into
    segments of a few planes, each re-staging the rings' h0 planes."""
    kern = ctx_4d(4, f"-g {g} -mode fused")._fused_spec_kernel()
    plan = kern.spec.stream
    assert plan.outer_cells == g
    cols = -(-g // plan.tile[0]) * -(-g // plan.tile[1])
    assert plan.blocks // plan.segments == cols * g
    blocks = tile_planner.SMS * plan.per_sm
    if members:
        b = kern.batch_segment(members)
        seg, segs = b["segment_planes"], b["segments"]
        assert b["columns"] == cols * g
        assert b["blocks"] == cols * g * segs * members
        assert (seg, segs) == tile_planner.stream_segments(
            g, cols * g * members, blocks, plan.h0)
    else:
        seg, segs = plan.seg, plan.segments
    # a solo member's plane columns alone: 2-plane (64⁴) and 11-plane
    # (128⁴) segments
    alone = tile_planner.stream_segments(g, cols, blocks, plan.h0)[0]
    assert alone <= 11 and seg >= 64 and segs <= 2


def test_the_4d_plan_keeps_40_registers_and_three_quarters_of_an_sm():
    """Past three domain dims a thread keeps at least
    ``STREAM_OUTER_MIN_REGS`` registers (two 1024-thread blocks an SM
    would leave 32), and of the rungs that keep ``STREAM_OUTER_THREADS``
    threads resident the plan takes the one staging the fewest in-plane
    cells per point, at every size: test_4d's 16x32 tiles at element size
    4, 3 blocks an SM (1,536 threads), where 3-D keeps the ladder's first
    fit; at 8 no rung keeps 1,536 (shared memory), and the most resident
    threads win.  At 2 (two points a thread) a thread keeps
    ``STREAM_PAIR_MIN_REGS`` (64) in blocks of at most
    ``STREAM_PAIR_OUTER_BLOCK`` (256) threads, so 1,024 threads stay:
    16x32 tiles of 256 threads, 4 blocks an SM, with a register queue of
    2."""
    for eb, tile, per_sm, queue in ((4, (16, 32), 3, 2),
                                    (2, (16, 32), 4, 2),
                                    (8, (16, 64), 1, 3)):
        for g in ("-g 128", "-g_w 3 -g_x 10 -g_y 6 -g_z 40"):
            plan = ctx_4d(eb, f"{g} -mode fused")._fused_spec_kernel() \
                .spec.stream
            assert (plan.tile, plan.per_sm) == (tile, per_sm), (eb, g)
            assert plan.queue == queue, (eb, g)
            nt = tile_planner.stream_threads(*tile, eb)
            regs = tile_planner.thread_registers(nt, per_sm)
            if eb == 4:
                assert nt * per_sm == tile_planner.STREAM_OUTER_THREADS
            if eb == 2:
                assert regs == tile_planner.STREAM_PAIR_MIN_REGS == 64
                assert nt == tile_planner.STREAM_PAIR_OUTER_BLOCK
                assert plan.record()["pairs"]["registers"] == regs
            assert regs >= tile_planner.STREAM_OUTER_MIN_REGS
    halos = {1: ((1, 3), (3, 2), (2, 1)), 2: ((1, 3), (3, 2), (2, 1))}
    three_d = tile_planner.stream_plan(halos, (128, 128, 128), 4)
    assert three_d.tile == (16, 64) and three_d.per_sm == 2
