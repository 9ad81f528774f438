"""K4's stream arm on the host: its plan, its reason records, its g++
host path and its wrapper, on the CPU.

* The plan by hand: iso3dfd r=2 K=4 (each level r planes ahead of the
  one that reads it: lags 6, 4, 2, 0; each level's plane tile grown by
  (K − L)·r; the input rings' reach around the walk's plane and their
  depths; level 1 to 3's computed rings of 5 planes), tti r=2 and awp at
  K=2 (the scratch sub-stages' and the velocities' lags within a level
  on top of the level's).
* The reason records: under ``-trapezoid`` with ``-skew`` (the default) a
  3-D or 4-D solution runs the stream arm at element sizes 4 and 2
  (``trapezoid_stream``, one launch per group in ``get_tiling()``; at 2
  its rings of bfloat16 pairs); 2-D and ``-no-skew`` (at element sizes 4
  and 2, 3-D and 4-D) keep the two-phase passes, each
  ``trapezoid_diamond`` record naming why (``stream_cause``); a forced
  stream request where the arm does not run raises, and at element size
  2 returns the arm's spec.
* The emitted K1/K6 sources (``emit_digest``) of the solutions the arm
  takes stay byte-identical to ``tests/emit_digests.json``.
* The ``_trap_stream`` entries built by g++ for the host (K6's host loop
  over the K levels' sub-stages, then the pads) against ``plain_chunk``,
  solo and for two stacked members, into NaN-filled outputs: to the bit.
* The wrapper: CPU tensors run the plain version and launch nothing;
  ``trapezoid_chunk`` itself refuses CPU tensors.
"""

import ctypes
import json
import os
import shutil
import subprocess

import pytest

from yask_tpu_torch.ops import cuda_emit, fused_stencil
from yask_tpu_torch.utils.exceptions import YaskException

from test_torch_fused import CSRC
from test_torch_k4_host import assert_states, k4_ctx
from test_torch_k4_stream_emulation import k4_stream_ctx, stream_spec


def codes(reasons):
    return [r["code"] for r in reasons]


def test_iso3dfd_k4_plan_by_hand():
    ctx = k4_stream_ctx("iso3dfd", 2, 4, (48, 48, 48))
    spec = stream_spec(ctx, 4, rung=None)
    plan, tr = spec.stages_stream, spec.trap
    assert tr["level_lags"] == [[6], [4], [2], [0]]
    assert [lo for lo, _hi in tr["level_growth"]] \
        == [[6, 6, 6], [4, 4, 4], [2, 2, 2], [0, 0, 0]]
    assert plan.tile == (16, 32) and plan.threads == 512
    # p(t), read at ±2 by level 1 (lag 6) and at the point by level 2
    # (lag 4); p(t-1) at the point by level 1; vel at the point by all
    ins = {spec.inputs[a]: a for a in spec.tiled}
    assert plan.in_reach[ins[("pressure", 1)]] == (-4, 8)
    assert plan.in_reach[ins[("pressure", 0)]] == (-6, 6)
    assert plan.in_reach[ins[("vel", 0)]] == (0, 6)
    assert [plan.in_depths[ins[k]] for k in (("pressure", 1),
                                             ("pressure", 0),
                                             ("vel", 0))] \
        == [4 + 2 + plan.prefetch, 2 + plan.prefetch, 8 + plan.prefetch]
    # level L's pressure, read by L + 1 at ±2 and L + 2 at the point
    assert plan.cmp_depths == [5, 5, 5] and plan.cmp_lo == [-2, 0, 2]
    assert spec.outputs == ["pressure", "pressure"]
    assert tr["out_levels"] == [3, 4]


@pytest.mark.parametrize("name,r,lags", [
    ("tti", 2, [[6, 6, 4], [2, 2, 0]]),
    ("awp", None, [[6, 4, 4, 4], [2, 0, 0, 0]])])
def test_k2_lags_by_level(name, r, lags):
    ctx = k4_stream_ctx(name, r, 2)
    spec = stream_spec(ctx, 2, rung=None)
    assert spec.trap["level_lags"] == lags
    assert spec.stages_stream.lags == sum(lags, [])
    # level 1 grows by what level 2 reads of it: 2·r in slot 0, beyond
    # the level's own sub-stage regions
    assert [hi[0] for _lo, hi in spec.sub_regions] == sum(lags, [])
    assert spec.trap["level_growth"][1] == ([0, 0, 0], [0, 0, 0])


def test_3d_fp32_runs_the_stream_arm_and_reports_it():
    ctx = k4_ctx("iso3dfd", 2, (32, 32, 32), 4, cli="-skew")
    kern = ctx._trapezoid_kernel()
    assert kern.stream and kern.spec.trap["arm"] == "stream"
    assert codes(ctx._trap[1]) == ["trapezoid_forced", "trapezoid_stream"]
    assert "lags per level [[6], [4], [2], [0]]" \
        in ctx._trap[1][-1]["detail"]
    c0 = fused_stencil.trapezoid_chunk.stream_launches
    ctx.run_solution(0, 3)
    assert fused_stencil.trapezoid_chunk.stream_launches == c0
    til = ctx.get_stats().get_tiling()
    assert til["arm"] == "trap_stream" and til["launches_per_group"] == 1
    assert til["name"] == kern.spec.name + "_trap_stream"
    assert til["level_lags"] == [[6], [4], [2], [0]]
    assert til["trap_stream"]["plane_tile"] == [16, 32]
    assert til["reasons"][-1]["code"] == "trapezoid_stream"
    batch = kern.tiling(4, 3)
    assert batch["name"].endswith("_trap_stream_batched")
    assert batch["members"] == 3


@pytest.mark.parametrize("name,r,sizes,eb,cli,cause", [
    ("iso3dfd", 2, (32, 32, 32), 2, "", "skew_disabled"),
    ("test_4d", None, (12, 12, 12, 12), 2, "", "skew_disabled"),
    ("wave2d", 2, (32, 32), 4, "-skew", "2-D solution"),
    ("iso3dfd", 2, (32, 32, 32), 4, "", "skew_disabled")])
def test_the_two_phase_passes_keep_the_refusals(name, r, sizes, eb, cli,
                                                cause):
    ctx = k4_ctx(name, r, sizes, 2, eb, cli)
    kern = ctx._trapezoid_kernel()
    assert kern is not None and not kern.stream
    assert "passes" in kern.spec.trap
    dia = [x for x in ctx._trap[1] if x["code"] == "trapezoid_diamond"]
    assert dia and all(cause in x["stream_cause"] for x in dia)
    ctx.run_solution(0, 1)
    til = ctx.get_stats().get_tiling()
    assert til["launches_per_group"] == len(kern.spec.trap["passes"])
    if eb == 2:
        # the arm takes element size 2: forced, it resolves
        spec = cuda_emit.resolve_trapezoid(ctx._program, 2, True, skew=True)
        assert spec.trap["arm"] == "stream"
        assert "typedef yt::bf16_t real_t;" in spec.source


@pytest.mark.parametrize("name,r,sizes", [
    ("iso3dfd", 2, (32, 32, 32)), ("test_4d", None, (12, 12, 12, 12))])
def test_bf16_runs_the_stream_arm_and_reports_it(name, r, sizes):
    """At element size 2 under ``-skew`` K4's groups run the stream arm,
    3-D and 4-D (its rings filled with 4-byte pairs), with no
    element-size reason; on CPU tensors its plain version runs and the
    arm launches nothing."""
    ctx = k4_ctx(name, r, sizes, 2, 2, "-skew")
    kern = ctx._trapezoid_kernel()
    assert kern.stream and kern.spec.trap["arm"] == "stream"
    assert kern.spec.stages_stream.esize == 2
    assert "typedef yt::bf16_t real_t;" in kern.spec.source
    assert codes(ctx._trap[1]) == ["trapezoid_forced", "trapezoid_stream"]
    assert not any("element size 2" in str(x) for x in ctx._trap[1])
    c0 = fused_stencil.trapezoid_chunk.stream_launches
    ctx.run_solution(0, 1)
    assert fused_stencil.trapezoid_chunk.stream_launches == c0
    til = ctx.get_stats().get_tiling()
    assert til["arm"] == "trap_stream" and til["launches_per_group"] == 1
    assert til["name"] == kern.spec.name + "_trap_stream"


def test_4d_fp32_runs_the_stream_arm_and_reports_it():
    """test_4d at 12⁴ under a forced ``-trapezoid`` with ``-skew``: K4's
    stream arm (``_trap_stream``, one launch per group), the outer dim w
    a window of its work items, slot 0 (x) streamed."""
    ctx = k4_ctx("test_4d", None, (12, 12, 12, 12), 2, cli="-skew")
    kern = ctx._trapezoid_kernel()
    assert kern.stream and kern.spec.trap["arm"] == "stream"
    assert kern.spec.outer == 1 and kern.spec.stages_stream.outer_tile
    assert codes(ctx._trap[1]) == ["trapezoid_forced", "trapezoid_stream"]
    assert "outer window" in ctx._trap[1][-1]["detail"]
    ctx.run_solution(0, 1)
    til = ctx.get_stats().get_tiling()
    assert til["arm"] == "trap_stream" and til["launches_per_group"] == 1
    assert til["name"] == kern.spec.name + "_trap_stream"
    assert til["skew_dims"] == ["x"]
    assert til["trap_stream"]["outer_window"] == list(
        kern.spec.stages_stream.outer_tile)


def test_emitted_k1_and_k6_sources_are_unchanged():
    from yask_tpu_torch.ops.emit_digest import digests
    path = os.path.join(os.path.dirname(__file__), "emit_digests.json")
    want = json.load(open(path))
    names = ["iso3dfd", "tti", "awp", "ssg", "test_stages_3d"]
    got = digests(names, element_bytes=(4, 8))
    assert got == {k: want[k] for k in got}


def host_entries(spec, tmp_path):
    """The g++ host build of a K4 stream source: (solo, batched)."""
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to test the host path"
    src = tmp_path / f"{spec.name}.cpp"
    so = tmp_path / f"{spec.name}.so"
    src.write_text(spec.source)
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    CSRC, "-o", str(so), str(src)], check=True,
                   capture_output=True, timeout=300)
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, spec.name + "_trap_stream")
    bfn = getattr(lib, spec.name + "_trap_stream_batched")
    fn.argtypes = fused_stencil.stages_stream_argtypes()
    bfn.argtypes = fused_stencil.batched_stages_stream_argtypes()
    fn.restype = bfn.restype = ctypes.c_int
    return fn, bfn


@pytest.mark.parametrize("name,r,K", [("iso3dfd", 2, 3), ("awp", None, 2),
                                      ("test_stages_3d", None, 2)])
def test_host_path_matches_plain(name, r, K, tmp_path):
    import torch
    ctxs = [k4_stream_ctx(name, r, K, seed=60 + i) for i in range(2)]
    prog = ctxs[0]._program
    spec = stream_spec(ctxs[0], K, rung=None)
    fn, bfn = host_entries(spec, tmp_path)
    state = ctxs[0]._state
    ins = [state[n][s] for n, s in spec.inputs]
    outs = [torch.full(tuple(prog.geoms[n].shape), float("nan"))
            for n in spec.outputs]
    assert fused_stencil.call_stages_stream_entry(
        fn, prog, spec, ins, outs, 0, None, nres=1) == 0
    assert_states(fused_stencil._rotated(prog, spec, state, outs),
                  fused_stencil.plain_chunk(prog, state, 0, K))
    ins = [torch.stack([c._state[n][s] for c in ctxs])
           for n, s in spec.inputs]
    outs = [torch.full((2,) + tuple(prog.geoms[n].shape), float("nan"))
            for n in spec.outputs]
    assert fused_stencil.call_batched_stages_stream_entry(
        bfn, prog, spec, ins, outs, 2, 0, None, nres=1) == 0
    for i, c in enumerate(ctxs):
        assert_states(
            fused_stencil._rotated(prog, spec, c._state,
                                   [o[i] for o in outs]),
            fused_stencil.plain_chunk(prog, c._state, 0, K))


def test_cpu_tensors_run_the_plain_version_and_launch_nothing():
    ctx = k4_ctx("iso3dfd", 2, (20, 20, 20), 2, cli="-skew")
    kern = ctx._trapezoid_kernel()
    assert kern.stream
    state = ctx._state
    c0 = (fused_stencil.trapezoid_chunk.stream_launches,
          fused_stencil.batched_trapezoid_chunk.stream_launches)
    assert_states(kern.chunk(dict(state), 0, 2),
                  fused_stencil.plain_chunk(ctx._program, state, 0, 2))
    assert (fused_stencil.trapezoid_chunk.stream_launches,
            fused_stencil.batched_trapezoid_chunk.stream_launches) == c0
    with pytest.raises(YaskException, match="not a CUDA tensor"):
        fused_stencil.trapezoid_chunk(kern, state, 0, 2)
    with pytest.raises(YaskException, match="groups of 2"):
        kern.chunk(dict(state), 0, 3)
