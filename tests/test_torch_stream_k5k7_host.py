"""K5 and K7 over K1's stream arm on the host: the gate and its reason
records, and the g++ host path of the two entries.

``csrc/stream_step.cuh`` carries ``stream_step_kernel<S, BATCH,
REGION>``: K7 over K1's stream arm (``<name>_stream_batched``, the member
a coordinate of the grid beside the segments) and K5 over it
(``<name>_stream_region``, the walk over one shard's box).

* Under ``-skew`` (the default) a member batch and a shard's box of every
  3-D single-stage solution the solo arm takes engage the arm
  (``skew_engaged``, kernels ``stream_batched`` and ``stream_region``) at
  element sizes 4 and 2; ``-no-skew`` keeps K1's body, and K5 over a
  4-D box keeps it with its reason (tests/test_torch_stream_k1_4d_*.py
  hold K7 over the arm past three dims).
* The segment rule is the plan's (``tile_planner.stream_segments``) at
  the extents walked: the box's, and the batch's columns times its
  members.
* The emitted entries built by g++ (the host path: K1's host loop over
  every member and the pads, or over the box at global coordinates)
  against ``plain_shard_step`` and ``plain_batched_chunk``, into
  NaN-filled outputs: bit-equal, every cell outside a box left NaN.

The shards: iso3dfd at r=2 and r=8, fp32 and bf16, ``-wf_steps 2`` on
2x2 shards (r=8: 2 in x), shard (0, 0) (its low faces the global edge,
its high faces inner ones), from a random state whose pads hold nonzero
ghosts past the inner faces; the sub-steps of one group over their full
boxes (the first grown into the pads), then a ragged box, each walked in
two segments, the last one partial.
tests/test_torch_stream_k5k7_emulation.py runs the same cases as device
code.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest

import yask_tpu_torch
from yask_tpu_torch.ops import cuda_emit, fused_stencil, tile_planner
from yask_tpu_torch.parallel.shard_step import _full_box, shard_pallas_plan

from test_torch_bf16 import bf16_source
from test_torch_k5_host import random_state, ragged
from test_torch_kernel_emulation import CSRC

#: id -> (radius, element bytes, sizes and ranks); a group of 2: slot 0
#: (x) of a shard at least 12 planes and r x K wide, z whole (r=2: 2x2
#: shards and two column blocks of the emulation's plane tile in z; r=8:
#: two shards in x, one column block)
REGION = {"r2_fp32": (2, 4, "-g_x 24 -g_y 18 -g_z 40 -nr_x 2 -nr_y 2"),
          "r2_bf16": (2, 2, "-g_x 24 -g_y 18 -g_z 40 -nr_x 2 -nr_y 2"),
          "r8_fp32": (8, 4, "-g_x 32 -g_y 16 -g_z 24 -nr_x 2"),
          "r8_bf16": (8, 2, "-g_x 32 -g_y 16 -g_z 24 -nr_x 2")}
#: id -> (radius, element bytes, sizes) of the member batches (3 members)
BATCH = {"r2_fp32": (2, 4, "-g_x 20 -g_y 9 -g_z 40"),
         "r2_bf16": (2, 2, "-g_x 20 -g_y 9 -g_z 40"),
         "r8_fp32": (8, 4, "-g_x 20 -g_y 9 -g_z 40"),
         "r8_bf16": (8, 2, "-g_x 20 -g_y 9 -g_z 40")}
NM = 3


def codes(reasons):
    return [r["code"] for r in reasons]


def source(name, r, eb):
    """The solution's source: registered, at element size 2 rebuilt with
    two bytes an element."""
    return (bf16_source("yask_tpu_torch", name, r) if eb == 2
            else {"stencil": name, "radius": r})


def new_ctx(env, name, r, eb, cli):
    fac = yask_tpu_torch.yk_factory()
    src = source(name, r, eb)
    ctx = (fac.new_solution(env, src) if eb == 2
           else fac.new_solution(env, **src))
    ctx.apply_command_line_options(cli)
    ctx.prepare_solution()
    return ctx


def shard_case(case, tiles=None, cli=""):
    """The case's K5 kernel (``-mode shard_pallas``, ``cli``), shard (0,
    0)'s global origin, the group's full boxes and a ragged one, and the
    spec (emitted at the plane tiles ``tiles`` where given: the
    emulation's small blocks)."""
    r, eb, sizes = REGION[case]
    fac = yask_tpu_torch.yk_factory()
    n = 4 if "-nr_y" in sizes else 2
    ctx = new_ctx(fac.new_env(devices=["cpu"] * n), "iso3dfd", r, eb,
                  f"{sizes} -mode shard_pallas -wf_steps 2 {cli}")
    sp = shard_pallas_plan(ctx)
    kern = sp.kernel
    prog = kern.program
    off = sp.layout.offsets[sp.layout.mesh.index(
        {d: 0 for d in prog.ana.domain_dims})]
    boxes = [_full_box(sp, 2, s) for s in range(2)]
    boxes.append(ragged(boxes[0], prog.sizes))
    return kern, emitted(prog, tiles) if tiles else kern.spec, off, boxes


def batch_case(case, tiles=None):
    """The case's ``-mode fused`` context (CPU) and its spec (at
    ``tiles`` where given)."""
    r, eb, sizes = BATCH[case]
    fac = yask_tpu_torch.yk_factory()
    ctx = new_ctx(fac.new_env(device="cpu"), "iso3dfd", r, eb,
                  f"{sizes} -mode fused")
    prog = ctx._program
    return ctx, emitted(prog, tiles) if tiles else \
        ctx._fused_spec_kernel().spec


def emitted(prog, tiles):
    """``cuda_emit.emit(prog)`` with K1's stream arm planned over the
    plane tiles ``tiles`` alone."""
    orig = tile_planner.STREAM_TILES
    tile_planner.STREAM_TILES = tiles
    try:
        spec = cuda_emit.emit(prog)
    finally:
        tile_planner.STREAM_TILES = orig
    assert spec.stream is not None and spec.stream.tile == tiles[0]
    return spec


def two_segments(n0: int) -> int:
    """A segment length that walks ``n0`` planes in two segments, the last
    one shorter."""
    seg = n0 // 2 + 1
    assert -(-n0 // seg) == 2 and n0 % seg
    return seg


def box_mask(prog, name, box):
    import torch
    g = prog.geoms[name]
    m = torch.zeros(tuple(g.shape), dtype=torch.bool)
    m[fused_stencil._box_idx(g, box)] = True
    return m


def region_steps(fn, kern, spec, off, boxes, wrap=None, strays=None):
    """The boxes in turn as sub-steps 0, 1, ... through ``fn``, each into
    NaN-filled outputs and walked in two segments: inside the box the
    plain version's bits, outside it NaN; ``wrap`` puts each input in a
    margin of stray words, ``strays()`` counts the reads of them."""
    import torch
    prog = kern.program
    state = random_state(kern, off, 5)
    for t, box in enumerate(boxes):
        fused_stencil.check_box(prog, spec, box)
        ins = [(wrap or (lambda a: a))(state[n][k]) for n, k in spec.inputs]
        outs = [torch.full(tuple(prog.geoms[n].shape), float("nan"),
                           dtype=ins[0].dtype) for n in spec.outputs]
        x = box[prog.ana.domain_dims[0]]
        if strays:
            strays()
        assert fused_stencil.call_region_stream_entry(
            fn, prog, spec, ins, outs, box, off, t, None,
            two_segments(x[1] - x[0])) == 0
        if strays:
            assert strays() == 0, "an input was read past its allocation"
        want = fused_stencil.plain_shard_step(kern, state, t, box, off)
        for name, got in zip(spec.outputs, outs):
            inside = box_mask(prog, name, box)
            assert got[~inside].isnan().all(), \
                f"{name}: a cell outside the box was written"
            torch.testing.assert_close(got[inside], want[name][-1][inside],
                                       rtol=0, atol=0)
            assert got[inside].float().abs().max() > 0, f"{name}: box is 0"
        state = want


def member_states(prog, nm: int, seed: int):
    """(nm, *shape) stacks of random interiors, a different state per
    member, zero pads (as a run keeps them)."""
    import torch
    from yask_tpu_torch.compiler.lowering import torch_dtype
    rng = np.random.RandomState(seed)
    state = {}
    for n, g in prog.geoms.items():
        if g.is_scratch:
            continue
        state[n] = [torch.stack([
            fused_stencil._zero_pads(prog, n, torch.tensor(np.asarray(
                rng.rand(*g.shape), np.float32)).to(torch_dtype(prog.dtype)))
            for _ in range(nm)]) for _s in range(g.num_slots)]
    return state


def batch_steps(fn, prog, spec, nm: int = NM, steps: int = 2):
    """``steps`` sub-steps of ``nm`` members through ``fn`` into NaN-filled
    stacks, slot 0 walked in two segments, rings rotated, against
    ``plain_batched_chunk``: every member's bits, pads included."""
    import torch
    state = member_states(prog, nm, 11)
    want = state
    n0 = prog.sizes[prog.ana.domain_dims[0]]
    for t in range(steps):
        ins = [state[n][k] for n, k in spec.inputs]
        outs = [torch.full((nm,) + tuple(prog.geoms[n].shape), float("nan"),
                           dtype=ins[0].dtype) for n in spec.outputs]
        assert fused_stencil.call_batched_stream_entry(
            fn, prog, spec, ins, outs, nm, t, None, two_segments(n0)) == 0
        state = fused_stencil._rotated(prog, spec, state, outs)
        want = fused_stencil.plain_batched_chunk(prog, want, t, 1, nm)
        for n in spec.outputs:
            for i in range(nm):
                torch.testing.assert_close(state[n][-1][i], want[n][-1][i],
                                           rtol=0, atol=0)
    # the members really differ
    out = state[spec.outputs[0]][-1]
    assert not torch.equal(out[0], out[1])


def host_lib(spec, tmp_path):
    """The emitted source built for the host by g++ (its entries run K1's
    host loop)."""
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to test the emitted entries"
    src = tmp_path / f"{spec.name}.cpp"
    so = tmp_path / f"{spec.name}.so"
    src.write_text(spec.source)
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    CSRC, "-o", str(so), str(src)], check=True,
                   capture_output=True, timeout=300)
    return ctypes.CDLL(str(so))


def bind(lib, spec, entry):
    """Entry ``_stream_region`` or ``_stream_batched`` of ``lib``."""
    fn = getattr(lib, spec.name + entry)
    fn.argtypes = (fused_stencil.region_stream_argtypes()
                   if entry.endswith("_region")
                   else fused_stencil.batched_stream_argtypes())
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.parametrize("case", list(REGION))
def test_host_path_of_k5_over_the_stream_arm_matches_plain(case, tmp_path):
    kern, spec, off, boxes = shard_case(case)
    assert kern.skew_dims == ["x"]
    fn = bind(host_lib(spec, tmp_path), spec, "_stream_region")
    region_steps(fn, kern, spec, off, boxes)


@pytest.mark.parametrize("case", list(BATCH))
def test_host_path_of_k7_over_the_stream_arm_matches_plain(case, tmp_path):
    ctx, spec = batch_case(case)
    fn = bind(host_lib(spec, tmp_path), spec, "_stream_batched")
    batch_steps(fn, ctx._program, spec)


# ---------------------------------------------------------------------------
# the gate, the records and the segments
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("eb", [4, 2])
@pytest.mark.parametrize("name,r", [("iso3dfd", 8), ("3axis", 1),
                                    ("cube", 1), ("iso3dfd_sponge", 2)])
def test_batches_and_boxes_take_the_arm_the_solo_run_takes(name, r, eb):
    """Every 3-D single-stage solution the solo arm takes engages it over
    member batches (``stream_batched``) and shards' boxes
    (``stream_region``), at element sizes 4 and 2; ``-no-skew`` keeps
    K1's body over both."""
    fac = yask_tpu_torch.yk_factory()
    solo = new_ctx(fac.new_env(device="cpu"), name, r, eb,
                   "-g 16 -mode fused")
    kern = solo._fused_spec_kernel()
    assert kern.skew_dims == ["x"] and kern.spec.stages == 1
    til = kern.tiling(1, members=3)
    assert til["kernel"] == "batched_step" and til["skew"] is True
    assert til["name"] == kern.spec.name + "_stream_batched"
    assert codes(til["skew_reasons"])[0] == "skew_engaged"
    rec = til["skew_reasons"][0]
    assert rec["kernel"] == "stream_batched"
    assert "plane tile" in rec["detail"] and "threads" in rec["detail"]
    assert "segment(s) of" in rec["detail"] and "3 members" in rec["detail"]
    assert "skew_not_ported" not in codes(til["skew_reasons"])
    b = kern.batch_segment(3)
    assert (til["segment_planes"], til["segments"]) == (
        b["segment_planes"], b["segments"])
    shard = new_ctx(fac.new_env(devices=["cpu"] * 2), name, r, eb,
                    "-g 16 -mode shard_pallas -nr_x 2")
    k5 = shard_pallas_plan(shard).kernel
    assert k5.skew_dims == ["x"]
    assert k5.skew_reasons[0]["kernel"] == "stream_region"
    assert k5.tiling(1)["name"] == k5.spec.name + "_stream_region"
    for cli, env in (("-g 16 -mode fused -no-skew", fac.new_env(
            device="cpu")),):
        body = new_ctx(env, name, r, eb, cli)._fused_spec_kernel()
        til = body.tiling(1, members=3)
        assert til["name"] == body.spec.name + "_batched"
        assert til["skew"] is False
        assert codes(til["skew_reasons"]) == ["skew_disabled"]
    off = new_ctx(fac.new_env(devices=["cpu"] * 2), name, r, eb,
                  "-g 16 -mode shard_pallas -nr_x 2 -no-skew")
    k5 = shard_pallas_plan(off).kernel
    assert k5.skew_dims == [] and codes(k5.skew_reasons) == ["skew_disabled"]


def test_a_4d_single_stage_solution_keeps_k1s_body():
    """test_4d (single-stage, 4-D): what this test pinned before K1's
    stream arm took outer dims (K7 kept K1's body with the emitter's "4-D
    solution" reason) is gone: K7 runs over the arm
    (``_stream_batched``); K5 over a 4-D box keeps K1's body, its reason
    naming K1's stream arm."""
    fac = yask_tpu_torch.yk_factory()
    ctx = new_ctx(fac.new_env(device="cpu"), "test_4d", None, 4,
                  "-g 8 -mode fused")
    kern = ctx._fused_spec_kernel()
    til = kern.tiling(1, members=3)
    assert til["name"] == kern.spec.name + "_stream_batched" and til["skew"]
    assert codes(til["skew_reasons"])[0] == "skew_engaged"
    assert til["skew_reasons"][0]["kernel"] == "stream_batched"
    shard = new_ctx(fac.new_env(devices=["cpu"] * 2), "test_4d", None, 4,
                    "-g 8 -mode shard_pallas -nr_x 2")
    k5 = shard_pallas_plan(shard).kernel
    assert k5.skew_dims == []
    assert set(codes(k5.skew_reasons)) == {"skew_ineligible"}
    assert "4-D solution" in k5.skew_reasons[0]["detail"]
    assert "K1's" in k5.skew_reasons[0]["detail"]


def test_segments_follow_the_extents_walked():
    """One rule (``tile_planner.stream_segments``, waves of blocks times
    the planes each walks with its re-staged h0): the plan at the
    domain's extents, a box at its own, a batch with its members'
    columns in the waves."""
    fac = yask_tpu_torch.yk_factory()
    ctx = new_ctx(fac.new_env(device="cpu"), "iso3dfd", 8, 4,
                  "-g_x 512 -g_y 64 -g_z 64 -mode fused")
    kern = ctx._fused_spec_kernel()
    plan = kern.spec.stream
    assert plan.h0 == 16
    cols = plan.blocks // plan.segments
    assert (plan.seg, plan.segments) == tile_planner.stream_segments(
        512, cols, tile_planner.SMS * plan.per_sm, 16)
    for nm in (1, 3, 8):
        b = kern.batch_segment(nm)
        assert (b["segment_planes"], b["segments"]) == \
            tile_planner.stream_segments(512, cols * nm,
                                         tile_planner.SMS * plan.per_sm, 16)
        assert b["blocks"] == cols * b["segments"] * nm
    # more members, more columns: segments no more numerous
    assert kern.batch_segment(8)["segments"] <= \
        kern.batch_segment(1)["segments"]
    assert kern.batch_segment(1)["segment_planes"] == plan.seg
    box = {"x": (-8, 72), "y": (0, 64), "z": (0, 64)}
    r = kern.region_segment(box)
    assert (r["segment_planes"], r["segments"]) == \
        tile_planner.stream_segments(80, cols, tile_planner.SMS
                                     * plan.per_sm, 16)
    assert r["box"] == [[-8, 72], [0, 64], [0, 64]]
