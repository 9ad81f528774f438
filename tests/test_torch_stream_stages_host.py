"""K6's stream arm on the host: its plan, its gate, its wrappers' routing
and the plain version it runs on CPU tensors.

* awp's plan (each sub-stage's lag, each ring's depth) against the values
  worked out by hand from awp's reads.
* The gate's reason code for every registered 3-D solution on K6's body
  at element sizes 2, 4 and 8 (at 2 its rings of bfloat16 pairs), for
  the workspace arm, for K7 over K1's stream arm and for K5; ``-no-skew`` keeps
  ``fused_stages_kernel``.
* The emitted entries built by g++ (the host path: K6's host loop and the
  pads) against the plain version, solo and over a member batch, into
  NaN-filled outputs: bit-equal.
* awp, ssg and fsg under ``-mode fused`` (the plain version on the CPU)
  against ``yask_tpu`` at ``field_epsilon=1e-4`` (the reference's
  staggered sums, as tests/test_torch_scratch.py has it), each run's
  ``get_tiling()`` reporting the arm; tti at r=2, 4 and 8,
  test_scratch_3d and ssg r=8 against ``jit`` and ``pallas``
  (interpret mode) alike."""

import ctypes
import shutil
import subprocess

import pytest

import yask_tpu
import yask_tpu_torch
from yask_tpu.runtime.init_utils import init_solution_vars as tpu_init
from yask_tpu_torch.ops import cuda_emit, fused_stencil, tile_planner
from yask_tpu_torch.runtime.init_utils import init_solution_vars as port_init
from yask_tpu_torch.transfer import export_interiors, import_interiors

from test_torch_4d import four_d_stages
from test_torch_bf16 import bf16_source
from test_torch_kernel_emulation import CSRC
from test_torch_lowering import mismatches, seeded_interiors
from test_torch_partial import SOLUTIONS as PARTIAL
from test_torch_scratch import port_ctx, with_pads
from test_torch_stencils import tpu_interiors

#: the registered 3-D solutions on K6's body the arm takes at element
#: sizes 2, 4 and 8
ENGAGED = ["awp", "awp_abc", "awp_elastic", "awp_elastic_abc", "fsg",
           "fsg2", "fsg_abc", "fsg2_abc", "fsg_merged", "fsg_merged_abc",
           "ssg", "ssg2", "ssg_merged", "test_boundary_3d", "test_stages_3d"]
#: and those with scratch vars, which it takes too (their scratch
#: sub-stages computed rings)
SCRATCH = ["test_scratch_3d", "tti"]


def codes(reasons):
    return [r["code"] for r in reasons]


def test_awp_lags_and_ring_depths_by_hand():
    """awp's stresses (sub-stage 1) and their boundary rewrite (2) read the
    velocities (0) at slot-0 offsets up to +2 (the staggered fourth-order
    differences read x - 2 .. x + 1 and x - 1 .. x + 2), so the
    velocities run two planes ahead: lags [2, 0, 0, 0], and a segment's
    walk starts 2 + 2 planes early (the velocities' reach below and
    their lag).  A staged input's ring holds the planes its readers read
    at their lags, the 2 planes in flight and one more (3): the
    velocities read stress_xx(t) at x - 1 .. x + 2 (planes z + 1 ..
    z + 4) and the stresses read it at x (plane z), 5 planes;
    stress_xy(t) and stress_xz(t) at x - 2 .. x + 1 and x, 4 planes;
    stress_yy(t), stress_yz(t) and stress_zz(t) at x by both (planes
    z + 2 and z), 3 planes; vel_x(t) .. vel_z(t) and rho at the point by
    the velocities alone (plane z + 2), 1 plane.  A computed ring holds
    the planes its readers read and its writer's newest: vel_x is read
    at x - 2 .. x + 1 from plane z (planes z - 2 .. z + 2: 5), vel_y
    and vel_z at x - 1 .. x + 2 (z - 1 .. z + 2: 4), the tiles the
    later sub-stages read at the point 1."""
    ctx = port_ctx("awp", None, "-g 32 -mode fused")
    spec = ctx._fused_spec_kernel().spec
    plan = spec.stages_stream
    assert plan.lags == [2, 0, 0, 0] and plan.warm == 4
    assert plan.prefetch == 2 and plan.tile == (16, 32)
    slot_0 = {"vel_x": 1, "rho": 1, "vel_y": 1, "vel_z": 1,
              "stress_xx": 5, "stress_xy": 4, "stress_xz": 4,
              "stress_yy": 3, "stress_yz": 3, "stress_zz": 3}
    depths = {spec.inputs[a][0]: d for a, d in plan.in_depths.items()}
    assert depths == {v: n + 3 for v, n in slot_0.items()}
    assert all(spec.inputs[a][1] == (1 if v.startswith("stress") else 0)
               for a, v in ((a, spec.inputs[a][0]) for a in spec.tiled))
    assert dict(zip(spec.computed, plan.cmp_depths)) == {
        "vel_x": 5, "vel_y": 4, "vel_z": 4, "mem_xx": 1, "mem_yy": 1,
        "mem_zz": 1, "stress_xz": 1, "stress_yz": 1, "stress_zz": 1}
    # the rings fit one block per SM at 16x32, 512 threads
    assert plan.smem_bytes <= cuda_emit.SMEM_LIMIT and plan.threads == 512
    assert plan.in_depths == {a: tile_planner.ring_depth(lo, hi, 2)
                              for a, (lo, hi) in plan.in_reach.items()}


@pytest.mark.parametrize("eb", [2, 4, 8])
@pytest.mark.parametrize("name", ENGAGED + SCRATCH)
def test_gate_codes_of_every_3d_k6_solution(name, eb):
    from yask_tpu_torch.compiler.solution_base import create_solution
    fac = yask_tpu_torch.yk_factory()
    src = create_solution(name)
    src.get_soln().set_element_bytes(eb)
    ctx = fac.new_solution(fac.new_env(device="cpu"), src)
    ctx.apply_command_line_options("-g 12 -mode fused")
    ctx.prepare_solution()
    kern = ctx._fused_spec_kernel()
    assert kern.spec.stages > 1
    # every element size engages the arm, element size 2 with its
    # bfloat16 pair rings
    assert codes(kern.skew_reasons)[0] == "skew_engaged"
    assert not any("element size 2" in r.get("detail", "")
                   for r in kern.skew_reasons)
    assert kern.skew_dims == ["x"]
    assert kern.skew_reasons[0]["kernel"] == "stages_stream"
    assert kern.spec.stages_stream is not None
    assert kern.spec.smem_bytes <= cuda_emit.SMEM_LIMIT
    assert kern.spec.stages_stream.smem_bytes <= cuda_emit.SMEM_LIMIT
    assert "YT_STAGES_STREAM_ENTRIES" in kern.spec.source
    assert cuda_emit.skew_engaged_dims(ctx._program, skew=True) == ["x"]


#: the plane tile each admitted solution's rings fit at element size 8
#: (at 4 every one fits the ladder's first, 16x32)
RUNG_AT_8 = {"awp": (4, 32), "awp_abc": (4, 32), "awp_elastic": (8, 32),
             "awp_elastic_abc": (4, 32), "fsg": (8, 32), "fsg2": (8, 32),
             "fsg_abc": (4, 32), "fsg2_abc": (4, 32), "fsg_merged": (8, 32),
             "fsg_merged_abc": (4, 32), "ssg": (4, 32), "ssg2": (4, 32),
             "ssg_merged": (4, 32), "test_boundary_3d": (16, 32),
             "test_stages_3d": (16, 32)}


def test_every_rung_but_one_is_taken_at_element_size_8():
    """The ladder's rungs that registered solutions take: at element size
    8 the rings of nine solutions fit only 4x32 by 128 threads, of four
    8x32 by 256; 8x64 and 4x64 are the other plane tiles chip_smoke
    phase 17 (b) times."""
    from yask_tpu_torch.compiler.solution_base import create_solution
    got = {}
    for name in ENGAGED:
        fac = yask_tpu_torch.yk_factory()
        src = create_solution(name)
        src.get_soln().set_element_bytes(8)
        ctx = fac.new_solution(fac.new_env(device="cpu"), src)
        ctx.apply_command_line_options("-g 12 -mode fused")
        ctx.prepare_solution()
        plan = ctx._fused_spec_kernel().spec.stages_stream
        got[name] = plan.tile
        assert (plan.tile + (plan.threads,)) in \
            tile_planner.STAGES_STREAM_TILES
    assert got == RUNG_AT_8
    assert tile_planner.STAGES_STREAM_TILES == (
        (16, 32, 512), (8, 64, 512), (8, 32, 256), (4, 64, 256),
        (4, 32, 128))


def test_workspace_arm_falls_back():
    """The workspace arm's solutions (ssg r=8) take the stream arm, its
    rings placed past shared memory; it falls back only where the
    computed rings alone exceed shared memory and the workspace a block
    may take (``SMEM_LIMIT`` and ``WS_STAGES_BLOCK_BYTES``, both lowered
    here), with their size."""
    ctx = port_ctx("ssg", 8, "-g 12 -mode fused")
    kern = ctx._fused_spec_kernel()
    assert kern.spec.workspace and kern.skew_dims == ["x"]
    assert codes(kern.skew_reasons) == ["skew_engaged", "skew_ineligible"]
    assert "rings past shared memory" in kern.skew_reasons[0]["detail"]
    assert kern.spec.stages_stream.placed
    with pytest.MonkeyPatch.context() as m:
        m.setattr(cuda_emit, "SMEM_LIMIT", 16384)
        m.setattr(cuda_emit, "WS_STAGES_BLOCK_BYTES", 1024)
        spec = cuda_emit.emit(ctx._program)
        reasons = []
        assert cuda_emit.skew_engaged_dims(ctx._program, reasons=reasons,
                                           spec=spec) == []
    assert spec.workspace and spec.stages_stream is None
    assert codes(reasons) == ["skew_fallback"] * 2
    why = reasons[0]["detail"]
    assert "ROADMAP.md A5" in why and "1024 bytes of workspace" in why


def test_no_skew_keeps_fused_stages_kernel(monkeypatch):
    """``-no-skew`` keeps K6's body: its reason, its tiling, and
    ``stages_step`` launching ``<name>`` (counted in ``launches``) where
    ``-skew`` launches ``<name>_stages_stream`` (``stream_launches``);
    both arms come from one source."""
    skew = port_ctx("awp", None, "-g 16 -mode fused")
    off = port_ctx("awp", None, "-g 16 -mode fused -no-skew")
    ks, ko = skew._fused_spec_kernel(), off._fused_spec_kernel()
    assert ks.spec.source == ko.spec.source
    assert "YT_FUSED_STAGES_ENTRY" in ko.spec.source
    assert ko.skew_dims == [] and codes(ko.skew_reasons) == ["skew_disabled"]
    til = ko.tiling(1)
    assert til["kernel"] == "stages_step" and til["name"] == ko.spec.name
    assert til["skew"] is False and "stages_stream" not in til
    til = ks.tiling(1)
    assert til["kernel"] == "stages_step" and til["skew"] is True
    assert til["name"] == ks.spec.name + "_stages_stream"
    assert til["stages_stream"]["lags"] == [2, 0, 0, 0]
    calls = []
    monkeypatch.setattr(fused_stencil, "_launch",
                        lambda k, s, t, what: calls.append("body") or s)
    monkeypatch.setattr(fused_stencil, "_launch_stages_stream",
                        lambda k, s, t, nm: calls.append(("stream", nm))
                        or s)
    monkeypatch.setattr(fused_stencil, "_launch_batched",
                        lambda k, s, t, nm, what: calls.append("batch")
                        or s)
    for w in (fused_stencil.stages_step, fused_stencil.batched_stages_step):
        monkeypatch.setattr(w, "launches", 0)
        monkeypatch.setattr(w, "stream_launches", 0)
    fused_stencil.stages_step(ks, {}, 0)
    fused_stencil.stages_step(ko, {}, 0)
    fused_stencil.batched_stages_step(ks, {}, 0, 3)
    fused_stencil.batched_stages_step(ko, {}, 0, 3)
    assert calls == [("stream", None), "body", ("stream", 3), "batch"]
    assert (fused_stencil.stages_step.launches,
            fused_stencil.stages_step.stream_launches) == (1, 1)
    assert (fused_stencil.batched_stages_step.launches,
            fused_stencil.batched_stages_step.stream_launches) == (1, 1)


def shard_awp(cli=""):
    """awp under ``-mode shard_pallas`` on 2x2 CPU shards, one step run
    (K5's plain version)."""
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(devices=["cpu"] * 4), stencil="awp")
    ctx.apply_command_line_options(
        f"-g 16 -mode shard_pallas -wf_steps 1 -nr_x 2 -nr_y 2 {cli}")
    ctx.prepare_solution()
    import_interiors(ctx, seeded_interiors(ctx, 2))
    ctx.run_solution(0, 0)
    return ctx


def test_k5_and_k7_over_k1_keep_their_reasons():
    """K5 over K6's body takes K6's stream arm over its boxes (its reason
    names ``stages_stream_region``, the record each box's segments); K7
    over K1's body takes K1's stream arm (``stream_batched``) and keeps
    its body under ``-no-skew``; K7 over K6's body takes the arm where the
    solo run does."""
    ctx = shard_awp()
    til = ctx.get_stats().get_tiling()
    kern = ctx._shard.kernel
    assert til["kernel"] == "shard_step" and til["skew"] is True
    assert til["name"] == kern.spec.name + "_stages_stream_region"
    assert codes(til["skew_reasons"])[0] == "skew_engaged"
    assert til["skew_reasons"][0]["kernel"] == "stages_stream_region"
    assert til["stages_stream"]["box_segments"] == [
        kern.region_segment({"x": (0, 8), "y": (0, 8), "z": (0, 16)})]
    iso = port_ctx("iso3dfd", 2, "-g 16 -mode fused")
    til = iso._fused_spec_kernel().tiling(1, members=3)
    assert til["kernel"] == "batched_step" and til["skew"] is True
    assert til["name"].endswith("_stream_batched")
    assert codes(til["skew_reasons"])[0] == "skew_engaged"
    assert til["skew_reasons"][0]["kernel"] == "stream_batched"
    iso = port_ctx("iso3dfd", 2, "-g 16 -mode fused -no-skew")
    til = iso._fused_spec_kernel().tiling(1, members=3)
    assert til["kernel"] == "batched_step" and til["skew"] is False
    assert codes(til["skew_reasons"]) == ["skew_disabled"]
    awp = port_ctx("awp", None, "-g 16 -mode fused")
    til = awp._fused_spec_kernel().tiling(1, members=3)
    assert til["kernel"] == "batched_stages_step" and til["skew"] is True
    assert til["name"].endswith("_stages_stream_batched")
    assert codes(til["skew_reasons"])[0] == "skew_engaged"


def test_no_skew_keeps_k5_over_k6s_body():
    """``-no-skew`` under ``shard_pallas`` keeps K5 over K6's body
    (``<name>_region``), with ``skew_disabled``; both arms come from one
    source."""
    ctx = shard_awp("-no-skew")
    til = ctx.get_stats().get_tiling()
    kern = ctx._shard.kernel
    assert kern.skew_dims == [] and kern.region
    assert til["kernel"] == "shard_step" and til["skew"] is False
    assert til["name"] == kern.spec.name + "_region"
    assert codes(til["skew_reasons"]) == ["skew_disabled"]
    assert "stages_stream" not in til
    assert kern.spec.source == shard_awp()._shard.kernel.spec.source


#: K6 solutions whose shards keep K5's body: the source, the sizes and
#: mesh, and the emitter's reason (4-D, misc on a 2-D domain, a
#: partial-dim output)
K5_REFUSED = {
    "four_d_stages": (lambda: four_d_stages("yask_tpu_torch"),
                      "-g_w 8 -g_x 5 -g_y 9 -g_z 16 -nr_w 2", "4-D solution"),
    "gaussian": (lambda: "gaussian", "-g 32 -nr_x 2 -nr_y 2", "2-D solution"),
    "partial_written": (lambda: PARTIAL["partial_written"]("yask_tpu_torch"),
                        "-g_x 32 -g_y 16 -g_z 16 -nr_x 2 -nr_y 2",
                        "partial-dim")}


@pytest.mark.parametrize("case", list(K5_REFUSED))
def test_k5_keeps_its_body_with_the_emitters_reason(case):
    """Where K6's stream arm refuses a solution, its shards keep K5 over
    K6's body (``<name>_region``) and the tiling gives the emitter's
    reason, as the single-domain run does."""
    src, cli, words = K5_REFUSED[case]
    fac = yask_tpu_torch.yk_factory()
    n = 2 if "-nr_w" in cli else 4
    env = fac.new_env(devices=["cpu"] * n)
    s = src()
    ctx = (fac.new_solution(env, stencil=s, radius=2) if isinstance(s, str)
           else fac.new_solution(env, s))
    ctx.apply_command_line_options(f"{cli} -mode shard_pallas -wf_steps 1")
    ctx.prepare_solution()
    import_interiors(ctx, seeded_interiors(ctx, 4))
    ctx.run_solution(0, 0)
    til = ctx.get_stats().get_tiling()
    kern = ctx._shard.kernel
    assert kern.spec.stages > 1 and kern.skew_dims == []
    assert til["skew"] is False and til["name"] == kern.spec.name + "_region"
    assert set(codes(til["skew_reasons"])) == {"skew_ineligible"}
    assert words in til["skew_reasons"][0]["detail"]


def test_k5_over_bf16_tti_takes_the_stream_arm():
    """tti r=2 at element size 2 on 2x2 shards: its shards run K5 over
    K6's stream arm (``<name>_stages_stream_region``, its rings of
    bfloat16 pairs), with no element-size reason, where they kept K5's
    body before the arm took element size 2; on CPU tensors K5's plain
    version runs and the arm launches nothing."""
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(devices=["cpu"] * 4),
                           bf16_source("yask_tpu_torch", "tti", 2))
    ctx.apply_command_line_options("-g_x 32 -g_y 32 -g_z 16 -nr_x 2 "
                                   "-nr_y 2 -mode shard_pallas -wf_steps 1")
    ctx.prepare_solution()
    import_interiors(ctx, seeded_interiors(ctx, 4))
    n0 = fused_stencil.shard_step.stream_launches
    ctx.run_solution(0, 0)
    assert fused_stencil.shard_step.stream_launches == n0
    til = ctx.get_stats().get_tiling()
    kern = ctx._shard.kernel
    assert kern.spec.stages > 1 and kern.skew_dims == ["x"]
    assert til["skew"] is True
    assert til["name"] == kern.spec.name + "_stages_stream_region"
    assert codes(til["skew_reasons"])[0] == "skew_engaged"
    assert til["skew_reasons"][0]["kernel"] == "stages_stream_region"
    assert not any("element size 2" in r.get("detail", "")
                   for r in til["skew_reasons"])


def test_member_batch_takes_the_sessions_skew_request():
    """The push-off kernel a pushing session's batches run takes the
    session's ``-skew`` request (the RTM chain's pipeline pushes its
    image; a batch of awp members under ``-no-skew`` keeps the body)."""
    awp = port_ctx("awp", None, "-g 16 -mode fused -push on")
    batch = awp._batched_kernel()
    assert batch is not awp._fused_spec_kernel()
    assert batch.skew_dims == ["x"]
    off = port_ctx("awp", None, "-g 16 -mode fused -push on -no-skew")
    assert off._batched_kernel().skew_dims == []


def host_entry(spec, tmp_path, entry):
    """The emitted source built for the host by g++ (its entries run K6's
    host loop and the pads) and one entry bound like the card's."""
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to test the emitted entries"
    src = tmp_path / f"{spec.name}.cpp"
    so = tmp_path / f"{spec.name}.so"
    src.write_text(spec.source)
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    CSRC, "-o", str(so), str(src)], check=True,
                   capture_output=True, timeout=300)
    fn = getattr(ctypes.CDLL(str(so)), spec.name + entry)
    fn.argtypes = (fused_stencil.batched_stages_stream_argtypes()
                   if entry.endswith("_batched")
                   else fused_stencil.stages_stream_argtypes())
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.parametrize("name", ["awp", "fsg_abc", "test_stages_3d"])
def test_host_path_of_the_entries_matches_plain(name, tmp_path):
    import torch
    ctx = port_ctx(name, None, "-g_x 9 -g_y 11 -g_z 40 -mode fused")
    with_pads(ctx, 4)
    prog, spec = ctx._program, ctx._fused_spec_kernel().spec
    state = ctx._state
    ins = [state[n][s] for n, s in spec.inputs]
    want = fused_stencil.plain_chunk(prog, state, 0, 1)
    solo = host_entry(spec, tmp_path, "_stages_stream")
    outs = [torch.full(tuple(prog.geoms[n].shape), float("nan"))
            for n in spec.outputs]
    assert fused_stencil.call_stages_stream_entry(solo, prog, spec, ins,
                                                  outs, 0, None) == 0
    assert all(torch.equal(o, want[n][-1])
               for n, o in zip(spec.outputs, outs))
    batch = host_entry(spec, tmp_path, "_stages_stream_batched")
    ins2 = [torch.stack([a, a]) for a in ins]
    outs2 = [torch.full((2,) + tuple(prog.geoms[n].shape), float("nan"))
             for n in spec.outputs]
    assert fused_stencil.call_batched_stages_stream_entry(
        batch, prog, spec, ins2, outs2, 2, 0, None) == 0
    assert all(torch.equal(o[i], want[n][-1])
               for n, o in zip(spec.outputs, outs2) for i in (0, 1))


#: (solution, radius, the reference's modes, the plan's plane tile at
#: g = 20): the arm's solutions with scratch sub-stages and those whose
#: rings lie past shared memory (r=8) also against ``yask_tpu``'s pallas
#: in interpret mode
CROSS = [("awp", None, ("jit",), [16, 32]), ("ssg", None, ("jit",), [16, 32]),
         ("fsg", None, ("jit",), [16, 32]),
         ("tti", 2, ("jit", "pallas"), [16, 32]),
         ("tti", 4, ("jit", "pallas"), [8, 32]),
         ("tti", 8, ("jit", "pallas"), [16, 32]),
         ("test_scratch_3d", None, ("jit", "pallas"), [16, 32]),
         ("ssg", 8, ("jit", "pallas"), [16, 32])]


@pytest.mark.parametrize("name,r,modes,tile", CROSS, ids=[
    n if r is None and n != "test_scratch_3d" else f"{n}-{r}"
    for n, r, _m, _t in CROSS])
def test_fused_matches_yask_tpu_and_reports_the_arm(name, r, modes, tile):
    """On CPU tensors ``-mode fused`` runs the plain version, which matches
    the reference's ``jit`` (and ``pallas``, interpret mode) from the
    shared ``init_solution_vars`` law; the tiling reports the arm the
    card would run, and no kernel launches."""
    mine = port_ctx(name, r, "-g 20 -mode fused -wf_steps 2")
    port_init(mine)
    n0 = fused_stencil.stages_step.stream_launches
    mine.run_solution(0, 3)
    assert fused_stencil.stages_step.stream_launches == n0
    for mode in modes:
        tfac = yask_tpu.yk_factory()
        theirs = tfac.new_solution(tfac.new_env(), stencil=name, radius=r)
        theirs.apply_command_line_options("-g 20")
        theirs.get_settings().mode = mode
        theirs.get_settings().wf_steps = 2
        theirs.prepare_solution()
        tpu_init(theirs)
        theirs.run_solution(0, 3)
        assert mismatches(export_interiors(mine), tpu_interiors(theirs),
                          field_epsilon=1e-4) == 0, mode
    til = mine.get_stats().get_tiling()
    assert til["kernel"] == "stages_step" and til["skew"] is True
    assert til["skew_dims"] == ["x"]
    assert til["name"].endswith("_stages_stream")
    assert til["stages_stream"]["plane_tile"] == tile
    assert ("workspace" in set(til["stages_stream"]["computed_ring_places"])
            or "global" in set(til["stages_stream"]["ring_places"].values())
            ) == (r == 8)
