"""K4's port (``-mode fused -trapezoid``) against yask_tpu's trapezoid.

* The port's ``TilePlan(unit=8)`` gives every geometry answer of
  ``yask_tpu``'s ``TilePlan`` (whose sublane unit is 8 for fp32); the
  eligibility is the same, and the pad need is the reference's minus its
  ``2·sub_t`` DMA slab rounding.  Exact.
* End to end on the CPU, the port's forced trapezoid (plain versions on CPU
  tensors) against ``yask_tpu``'s ``-mode pallas`` trapezoid run in
  interpret mode as tests/test_trapezoid.py runs it (the build forced to
  ``trapezoid=True`` through a monkeypatched ``build_pallas_chunk``).
  Tolerance: ``field_epsilon=1e-4``, the repo's policy for a fused in-tile
  evaluation against an unfused one (the Pallas tile contracts
  multiply-adds).
* K4's own code (phase 1 and the diamonds, csrc/trapezoid.cuh) built by
  g++ for the host, one thread per block, NaN-filled buffers and outputs,
  against ``plain_chunk``: bit-equal (the same operations in the same
  order).  The threaded emulation with shared-memory barriers is in
  tests/test_torch_kernel_emulation.py.
* The resolution: the CLI knob, the reason codes, the fallbacks (auto) and
  raises (forced) for the band floor, missing pads and multi-stage
  solutions, and the refusals of batched K4.
"""

import ctypes
import importlib
import os
import shutil
import subprocess

import numpy as np
import pytest

import yask_tpu
import yask_tpu_torch
from yask_tpu_torch.ops import cuda_emit, fused_stencil
from yask_tpu_torch.ops.tile_planner import TilePlan
from yask_tpu_torch.transfer import export_interiors, import_interiors
from yask_tpu_torch.utils.exceptions import YaskException

from test_torch_lowering import (mismatches, seeded_interiors, tpu_export,
                                 tpu_import)

CSRC = os.path.join(os.path.dirname(fused_stencil.__file__), "..", "csrc")


def force(ctx):
    """Make the context's trapezoid request True (K4 past its gate,
    raising where it cannot run), as tests/test_trapezoid.py forces
    ``build_pallas_chunk(trapezoid=True)``."""
    ctx._trapezoid_arg = lambda: True
    return ctx


def port_ctx(stencil, radius, g, mode="fused", K=2, cli="", forced=False):
    """A prepared port context on the CPU; ``g`` is one size or one per
    solution dim; ``forced`` forces the trapezoid request."""
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(device="cpu"), stencil=stencil,
                           radius=radius)
    if forced:
        force(ctx)
    if isinstance(g, int):
        sizes = f"-g {g}"
    else:
        sizes = " ".join(f"-g_{d} {n}"
                         for d, n in zip(ctx.get_domain_dim_names(), g))
    ctx.apply_command_line_options(f"{sizes} -mode {mode} -wf_steps {K} "
                                   f"{cli}")
    ctx.prepare_solution()
    return ctx


def tpu_ctx(stencil, radius, g, mode="pallas", K=2, trap=True):
    fac = yask_tpu.yk_factory()
    ctx = fac.new_solution(fac.new_env(), stencil=stencil, radius=radius)
    ctx.apply_command_line_options(f"-g {g} -wf_steps {K}")
    ctx.get_settings().mode = mode
    ctx.get_settings().trapezoid_tiling = trap
    ctx.prepare_solution()
    return ctx


# ---------------------------------------------------------------------------
# the geometry against yask_tpu's
# ---------------------------------------------------------------------------

PLANS = [("iso3dfd", 8, 2, 48), ("cube", 1, 4, 48), ("iso3dfd", 2, 3, 48),
         ("iso3dfd", 2, 4, 48), ("ssg", 4, 2, 48), ("tti", 2, 2, 48),
         ("awp", None, 2, 48), ("gaussian", 2, 2, 48)]


@pytest.mark.parametrize("stencil,r,K,g", PLANS)
def test_tileplan_unit8_matches_yask_tpu(stencil, r, K, g):
    """Exact: every geometry answer for the uniform, the two-dim and the
    one-dim trapezoid plans, volumes at three blocks, and the per-stage
    widths and windows of the multi-stage ones (ssg, tti's scratch chain,
    awp's four stages, gaussian's three)."""
    from yask_tpu.ops.tile_planner import TilePlan as TpuPlan
    mine = port_ctx(stencil, r, g, "torch", K)._program
    theirs = tpu_ctx(stencil, r, g, "jit", K, trap=False)._program
    lead = list(mine.ana.domain_dims[:-1])
    for trap in ([], lead, lead[:1], lead[-1:]):
        a = TilePlan(mine, K, trap_dims=trap, unit=8)
        b = TpuPlan(theirs, K, trap_dims=trap)
        assert a.margins() == b.margins()
        assert a.min_block() == b.min_block()
        assert a.margin_override() == b.margin_override()
        for d in lead:
            assert a.halo(d) == b.halo(d)
            if d in trap:
                assert a.diamond(d) == b.diamond(d)
            for lvl in range(1, K + 1):
                assert a.cl(d, lvl) == b.cl(d, lvl)
                assert a.write_shrink(d, lvl) == b.write_shrink(d, lvl)
        assert a.stage_widths() == b.stage_widths()
        for blk in (8, 16, 24):
            block = {d: blk for d in lead}
            assert a.volumes(block) == b.volumes(block)
            for x, y in zip(a.dataflow(block), b.dataflow(block)):
                assert (x["read"], x["write"]) == (y["read"], y["write"])
            assert a.stage_flow(block) == b.stage_flow(block)
            for lvl in a.stage_flow(block):
                st = lvl["stages"]
                for s0, s1 in zip(st, st[1:]):
                    assert s1["read"] == s0["write"]


@pytest.mark.parametrize("stencil,r,K,g", PLANS + [("iso3dfd", 2, 1, 16),
                                                   ("wave2d", 2, 2, 16)])
def test_eligibility_and_pad_need_match_yask_tpu(stencil, r, K, g):
    """Exact; the port's pad need drops the reference's 2·sub_t slab
    rounding (the card copies no DMA slabs)."""
    import jax.numpy as jnp
    from yask_tpu.ops.pallas_stencil import (trapezoid_eligible_dims,
                                             trapezoid_pad_need)
    mine = port_ctx(stencil, r, g, "torch", K)._program
    theirs = tpu_ctx(stencil, r, g, "jit", K, trap=False)._program
    assert cuda_emit.trapezoid_eligible_dims(mine, K) \
        == trapezoid_eligible_dims(theirs, K)
    for rd in (0, 1, 2, 8):
        for k in (1, 2, 3, 4):
            slab = 2 * 8 if rd > 0 and k >= 2 else 0
            assert cuda_emit.trapezoid_pad_need(rd, k, unit=8) + slab \
                == trapezoid_pad_need(jnp.float32, rd, k)


def test_unit1_plan_is_exact_on_the_card():
    """unit=1: band half-widths and write shrinks are (lvl−1)·r in every
    trapezoid dim; the megacore credit is 1."""
    prog = port_ctx("cube", 1, 48, "torch", 4)._program
    tp = TilePlan(prog, 4, trap_dims=["x", "y"])
    assert [tp.cl("y", lvl) for lvl in (1, 2, 3, 4)] == [0, 1, 2, 3]
    assert tp.write_shrink("y", 4) == 3 and tp.min_block() == {"x": 7,
                                                               "y": 7}
    assert TilePlan.PARALLEL_CORES == 1
    assert cuda_emit.trapezoid_pad_need(1, 4) == 4 + 3


# ---------------------------------------------------------------------------
# end to end against yask_tpu's trapezoid in interpret mode
# ---------------------------------------------------------------------------


@pytest.fixture
def tpu_forced_trapezoid(monkeypatch):
    """yask_tpu's context asks build_pallas_chunk for trapezoid=None (the
    gate) under -trapezoid; force it, as tests/test_trapezoid.py forces
    its chunks."""
    from yask_tpu.ops import pallas_stencil as ps
    orig = ps.build_pallas_chunk

    def forced(*args, **kw):
        if "trapezoid" in kw and kw["trapezoid"] is None:
            kw["trapezoid"] = True
        return orig(*args, **kw)
    monkeypatch.setattr(ps, "build_pallas_chunk", forced)


@pytest.mark.parametrize("stencil,r,g,K,steps", [
    ("iso3dfd", 2, 32, 4, 6),          # a remainder group of 2 steps
    ("iso3dfd_sponge", 2, 24, 2, 5),   # IF_DOMAIN sponge conditions
    ("wave2d", 2, 32, 2, 5)])          # 2-D: a single lead dim
def test_trapezoid_e2e_matches_yask_tpu_interpret(tpu_forced_trapezoid,
                                                  stencil, r, g, K, steps):
    mine = port_ctx(stencil, r, g, "fused", K, "-trapezoid -no-skew",
                    forced=True)
    theirs = tpu_ctx(stencil, r, g, "pallas", K)
    state = seeded_interiors(mine, 3)
    import_interiors(mine, state)
    tpu_import(theirs, state)
    mine.run_solution(0, steps - 1)
    theirs.run_solution(0, steps - 1)
    assert mismatches(export_interiors(mine), tpu_export(theirs),
                      field_epsilon=1e-4) == 0
    a, b = mine.get_stats().get_tiling(), theirs.get_stats().get_tiling()
    assert a["trapezoid"] is b["trapezoid"] is True
    assert a["trap_dims"] == b["trap_dims"] \
        == list(mine._ana.domain_dims[:-1][-2:])
    assert a["trapezoid_request"] == "forced"
    assert [d["dim"] for d in a["diamond"]] \
        == [d["dim"] for d in b["diamond"]]


# ---------------------------------------------------------------------------
# K4's code on the host (g++), against plain_chunk
# ---------------------------------------------------------------------------


def host_trapezoid(spec, tmp_path):
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to test K4's host path"
    src = tmp_path / f"{spec.name}.cpp"
    so = tmp_path / f"{spec.name}.so"
    src.write_text(spec.source)
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    CSRC, "-o", str(so), str(src)], check=True,
                   capture_output=True, timeout=300)
    fn = getattr(ctypes.CDLL(str(so)), spec.name)
    fn.argtypes = fused_stencil.trapezoid_argtypes()
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.parametrize("stencil,r,g,K,cli", [
    ("iso3dfd", 2, (48, 48, 21), 4, ""), ("iso3dfd", 2, (48, 64, 35), 3, ""),
    ("cube", 1, (24, 24, 19), 4, ""), ("3axis", 1, (30, 18, 9), 2, ""),
    ("iso3dfd_sponge", 2, (24, 24, 13), 2, ""),
    ("wave2d", 8, (96, 37), 2, "-b_x 24"),
    ("iso3dfd", 2, (48, 48, 21), 4, "-b_x 16 -b_y 48"),
    # several stages, the level buffers past shared memory in the
    # workspace (the other new arms: tests/test_torch_k4_host.py)
    ("ssg", None, (18, 18, 9), 2, "")])
def test_k4_host_path_bit_equals_plain(stencil, r, g, K, cli, tmp_path):
    import torch
    ctx = port_ctx(stencil, r, g, "fused", K, f"-trapezoid -no-skew {cli}",
                   forced=True)
    import_interiors(ctx, seeded_interiors(ctx, 13))
    prog = ctx._program
    spec = ctx._trapezoid_kernel().spec
    fn = host_trapezoid(spec, tmp_path)
    state = ctx._state
    for t0 in (0, K):
        ins = [state[n][s] for n, s in spec.inputs]
        outs = [torch.full(tuple(prog.geoms[n].shape), float("nan"))
                for n in spec.outputs]
        for p in range(len(spec.trap["passes"])):
            assert fused_stencil.call_trapezoid_entry(
                fn, prog, spec, ins, outs, p, t0, None) == 0
        for n, o in zip(spec.outputs, outs):
            fused_stencil._zero_pads(prog, n, o)
        got = fused_stencil._rotated(prog, spec, state, outs)
        want = fused_stencil.plain_chunk(prog, state, t0, K)
        for n in want:
            for a, b in zip(got[n], want[n]):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
        state = want


def test_k4_one_dim_list_runs_only_that_dim(tmp_path):
    """trapezoid=["x"]: only x decomposes (one diamond pass); y is
    uniform.  Host path bit-equal to plain_chunk."""
    import torch
    ctx = port_ctx("iso3dfd", 2, (48, 20, 13), "fused", 4, "-trapezoid")
    import_interiors(ctx, seeded_interiors(ctx, 2))
    prog = ctx._program
    reasons = []
    spec = cuda_emit.resolve_trapezoid(prog, 4, ["x"], reasons=reasons)
    assert spec.trap["trap_dims"] == ["x"]
    assert codes(reasons) == ["trapezoid_forced", "trapezoid_diamond"]
    with pytest.raises(YaskException, match="requested"):
        cuda_emit.resolve_trapezoid(prog, 4, ["z"])
    fn = host_trapezoid(spec, tmp_path)
    state = ctx._state
    ins = [state[n][s] for n, s in spec.inputs]
    outs = [torch.full(tuple(prog.geoms[n].shape), float("nan"))
            for n in spec.outputs]
    for p in (0, 1):
        assert fused_stencil.call_trapezoid_entry(fn, prog, spec, ins, outs,
                                                  p, 0, None) == 0
    for n, o in zip(spec.outputs, outs):
        fused_stencil._zero_pads(prog, n, o)
    got = fused_stencil._rotated(prog, spec, state, outs)
    want = fused_stencil.plain_chunk(prog, state, 0, 4)
    for n in want:
        for a, b in zip(got[n], want[n]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_k4_wrapper_takes_plain_version_only_for_cpu_tensors():
    ctx = port_ctx("iso3dfd", 2, 32, "fused", 4, "-trapezoid", forced=True)
    trap = ctx._trapezoid_kernel()
    p0 = fused_stencil.trapezoid_chunk.phase1_launches
    trap.chunk(ctx._state, 0, 4)                # CPU: plain_chunk
    assert fused_stencil.trapezoid_chunk.phase1_launches == p0
    assert trap.fn is None                      # nothing was built
    with pytest.raises(YaskException, match="groups of 4"):
        trap.chunk(ctx._state, 0, 3)
    meta = {n: [a.to("meta") for a in ring]
            for n, ring in ctx._state.items()}
    with pytest.raises(YaskException, match="CUDA or CPU"):
        trap.chunk(meta, 0, 4)
    import torch
    trap.dtype = torch.float32
    with pytest.raises(YaskException, match="not a CUDA tensor"):
        fused_stencil.trapezoid_chunk(trap, ctx._state, 0, 4)
    assert fused_stencil.trapezoid_chunk.phase1_launches == p0


# ---------------------------------------------------------------------------
# the resolution: knob, reasons, fallbacks and raises
# ---------------------------------------------------------------------------


def test_trapezoid_cli_knob():
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(device="cpu"), stencil="iso3dfd",
                           radius=2)
    ctx.apply_command_line_options("-g 24 -trapezoid")
    assert ctx.get_settings().trapezoid_tiling is True
    assert ctx._trapezoid_arg() is None
    ctx.apply_command_line_options("-no-trapezoid")
    assert ctx.get_settings().trapezoid_tiling is False
    assert ctx._trapezoid_arg() is False


def test_harness_runs_trapezoid_and_reports_reasons(monkeypatch):
    import io
    from yask_tpu_torch.main import run_harness
    from yask_tpu_torch.runtime.context import StencilContext
    monkeypatch.setattr(StencilContext, "_trapezoid_arg",
                        lambda self: True)
    out = io.StringIO()
    assert run_harness(["-stencil", "iso3dfd", "-radius", "2", "-g", "32",
                        "-device", "cpu", "-mode", "fused", "-wf_steps", "4",
                        "-trapezoid", "-num_trials", "1",
                        "-trial_steps", "4"], out=out) == 0
    text = out.getvalue()
    assert "'trapezoid': True" in text and "trapezoid_forced" in text
    assert "trapezoid reasons:" in text


def codes(reasons):
    return [r["code"] for r in reasons]


def test_auto_gate_records_its_numbers_and_engages():
    """iso3dfd r=2 K=4: the per-variant-block gate engages; the numbers
    are in the record; pads are planned for the diamond windows."""
    ctx = port_ctx("iso3dfd", 2, 48, "fused", 4, "-trapezoid -no-skew")
    need = cuda_emit.trapezoid_pad_need(2, 4)
    assert min(ctx._program.geoms["pressure"].pads["x"]) >= need
    trap = ctx._trapezoid_kernel()
    reasons = ctx._trap[1]
    assert trap is not None
    assert codes(reasons) == ["trapezoid_engaged"] * 2 \
        + ["trapezoid_diamond"] * 2
    assert "vs uniform" in reasons[0]["detail"] \
        and "skew" in reasons[0]["detail"]
    ctx.run_solution(0, 5)
    til = ctx.get_stats().get_tiling()
    assert til["trapezoid"] is True and til["trap_dims"] == ["x", "y"]
    assert til["trapezoid_request"] == "auto"
    assert til["reasons"] == reasons


def test_ineligible_and_off_record_their_codes():
    ctx = port_ctx("iso3dfd", 2, 16, "fused", 1, "-trapezoid")
    assert ctx._trapezoid_kernel() is None
    assert codes(ctx._trap[1]) == ["trapezoid_ineligible"] * 2
    ctx.run_solution(0, 1)
    til = ctx.get_stats().get_tiling()
    assert til["trapezoid"] is False and til["kernel"] == "stream_step"
    off = port_ctx("iso3dfd", 2, 16, "fused", 4)
    off.run_solution(0, 3)
    assert off.get_stats().get_tiling()["trapezoid_request"] == "off"
    assert off.get_stats().get_tiling()["reasons"] == []


def test_r8_flagship_falls_back_in_auto_and_raises_forced():
    """iso3dfd r=8 K=2: no phase-1 tile fits shared memory.  What this
    test pinned before K4 had a workspace (auto fell back to K1, forced
    raised) is gone: the level buffers past shared memory go to the
    workspace, so the gate's choice stands (it engages: the port has no
    skew variant to prefer, ROADMAP.md C7) and a forced request builds
    the same plan, as the reference's forced request runs it.  K1 stays
    the path of ``-no-trapezoid``."""
    ctx = port_ctx("iso3dfd", 8, 48, "fused", 2, "-trapezoid -no-skew")
    trap = ctx._trapezoid_kernel()
    assert trap is not None
    assert codes(ctx._trap[1]) == ["trapezoid_engaged"] * 2 \
        + ["trapezoid_diamond"] * 2
    p1 = trap.spec.trap["passes"][0]
    assert p1["ws_buffers"] > 0 and p1["smem_bytes"] <= cuda_emit.SMEM_LIMIT
    ctx.run_solution(0, 2)
    assert ctx.get_stats().get_tiling()["ws_block_bytes"] > 0
    forced = cuda_emit.resolve_trapezoid(ctx._program, 2, True)
    assert forced.name == trap.spec.name
    off = port_ctx("iso3dfd", 8, 48, "fused", 2, "-no-trapezoid")
    off.run_solution(0, 2)
    assert off.get_stats().get_tiling()["trapezoid"] is False


def test_band_floor_falls_back_and_raises_when_forced():
    """iso3dfd r=2 K=4 (the gate engages): the band floor is 2·cl(4)+1 =
    13 > 8."""
    ctx = port_ctx("iso3dfd", 2, 48, "fused", 4, "-trapezoid")
    reasons = []
    assert cuda_emit.resolve_trapezoid(ctx._program, 4, None,
                                       block={"x": 8, "y": 8},
                                       reasons=reasons) is None
    assert codes(reasons) == ["trapezoid_engaged"] * 2 \
        + ["trapezoid_fallback"]
    assert "band floor" in reasons[-1]["cause"]
    with pytest.raises(YaskException, match="band floor"):
        cuda_emit.resolve_trapezoid(ctx._program, 4, True,
                                    block={"x": 8, "y": 8})
    with pytest.raises(YaskException, match="does not divide"):
        cuda_emit.resolve_trapezoid(ctx._program, 4, True,
                                    block={"x": 36, "y": 24})
    # the -b settings reach the resolution the same way
    ctx = port_ctx("iso3dfd", 2, 48, "fused", 4, "-trapezoid -b 8")
    assert ctx._trapezoid_kernel() is None
    assert "band floor" in ctx._trap[1][-1]["cause"]


def test_fallback_without_pads_and_raise_when_forced():
    """A program prepared without -trapezoid has no diamond-band pads."""
    ctx = port_ctx("iso3dfd", 2, 48, "fused", 4)
    reasons = []
    assert cuda_emit.resolve_trapezoid(ctx._program, 4, None,
                                       reasons=reasons) is None
    assert reasons[-1]["code"] == "trapezoid_fallback"
    assert "pads" in reasons[-1]["cause"]
    with pytest.raises(YaskException, match="pads"):
        cuda_emit.resolve_trapezoid(ctx._program, 4, True)


def test_multi_stage_falls_back_naming_a12():
    """What this test pinned before K4 took several stages (the fallback
    naming ROADMAP.md A12 (multi-stage K4)) is gone: the merged RTM chain
    runs its groups on K4, each level running K6's three stages, and
    matches the K6 path (-no-trapezoid) to the bit; a forced request
    builds the same plan."""
    from yask_tpu_torch.ops.pipeline import SolutionPipeline, rtm_chain
    from test_torch_pipeline import observable, seed_chain
    outs = {}
    for cli in ("-trapezoid", "-no-trapezoid"):
        pipe = SolutionPipeline(yask_tpu_torch.yk_factory().new_env(
            device="cpu"), *rtm_chain(radius=2, accumulate=False))
        pipe.apply_command_line_options(f"-g 16 -mode fused -wf_steps 2 "
                                        f"-no-skew {cli}")
        pipe.prepare(fuse=True)
        ctx = pipe.fused_ctx
        if cli == "-trapezoid":
            force(ctx)
        seed_chain(pipe, (16, 16, 16))
        pipe.run(0, 4)
        outs[cli] = observable(pipe)
        if cli == "-trapezoid":
            spec = ctx._trapezoid_kernel().spec
            assert spec.stages == 3 and spec.trap["sub_stages"] == 3
            assert codes(ctx._trap[1]) == ["trapezoid_forced"] \
                + ["trapezoid_diamond"] * 2
            til = ctx.get_stats().get_tiling()
            assert til["trapezoid"] is True and til["sub_stages"] == 3
            assert cuda_emit.resolve_trapezoid(ctx._program, 2,
                                               True).name == spec.name
        else:
            assert ctx._trapezoid_kernel() is None
    assert mismatches(outs["-trapezoid"], outs["-no-trapezoid"],
                      epsilon=0.0, abs_epsilon=0.0) == 0


def test_batched_k4_raises_naming_a12(tmp_path):
    """What this test pinned before K4 took member batches (the refusal
    naming ROADMAP.md A12 (batched K4)) is gone: an ensemble under
    -trapezoid runs each group on K4's member batch and every member is
    bit-equal to its solo run; a served -trapezoid session batches."""
    from test_torch_ensemble import members_match_solo
    ens = members_match_solo(lambda: force(port_ctx(
        "iso3dfd", 2, 16, "fused", 2, "-trapezoid")), n=3, steps=5)
    assert ens.tiling["kernel"] == "batched_trapezoid_chunk"
    from yask_tpu_torch.serve import StencilServer
    from yask_tpu_torch.serve.scheduler import extract_outputs
    from test_torch_serve import assert_same, seed
    srv = StencilServer(yask_tpu_torch.yk_factory().new_env(device="cpu"),
                        journal_path=str(tmp_path / "SERVE.jsonl"),
                        preflight=False, window_secs=0.05)
    try:
        sids = []
        for i in range(2):
            # iso3dfd r=2 K=4 at 48: the gate engages K4 on its own
            sids.append(srv.open_session(stencil="iso3dfd", radius=2, g=48,
                                         mode="fused", wf=4,
                                         options="-trapezoid", bucket=False))
            with srv.scheduler.session_ctx(sids[-1]) as ctx:
                seed(ctx, i, 48)
        rids = [srv.submit_run(sid, 0, 3) for sid in sids]
        resp = [srv.wait(r) for r in rids]
        assert all(r.status == "ok" and r.batched for r in resp)
        for i, sid in enumerate(sids):
            alone = port_ctx("iso3dfd", 2, 48, "fused", 4, "-trapezoid")
            seed(alone, i, 48)
            alone.run_solution(0, 3)
            with srv.scheduler.session_ctx(sid) as ctx:
                assert ctx._trapezoid_kernel() is not None
                assert_same(extract_outputs(ctx), extract_outputs(alone))
    finally:
        srv.shutdown()


def test_variant_key_carries_the_trapezoid_request():
    a = port_ctx("iso3dfd", 2, 16, "fused", 2)
    b = port_ctx("iso3dfd", 2, 16, "fused", 2, "-trapezoid")
    assert a._fused_variant_key() != b._fused_variant_key()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("stencil,r,g,K", [("iso3dfd", 2, (48, 64, 131), 4),
                                           ("cube", 1, (40, 48, 67), 4)])
def test_k4_bit_equals_k1_on_card(cuda_device, stencil, r, g, K):
    """K4 and the K1 path (-no-trapezoid) agree to the bit on the card,
    remainder group included; each K-step group is 1 + 2 launches."""
    fac = yask_tpu_torch.yk_factory()
    env = fac.new_env()
    sizes = " ".join(f"-g_{d} {n}" for d, n in zip("xyz", g))
    ctxs = {}
    for cli in ("-trapezoid", "-no-trapezoid"):
        ctx = fac.new_solution(env, stencil=stencil, radius=r)
        if cli == "-trapezoid":
            force(ctx)
        ctx.apply_command_line_options(f"{sizes} -mode fused -wf_steps {K} "
                                       f"{cli}")
        ctx.prepare_solution()
        ctxs[cli] = ctx
    state = seeded_interiors(ctxs["-no-trapezoid"], 4)
    for ctx in ctxs.values():
        import_interiors(ctx, state)
    p0 = fused_stencil.trapezoid_chunk.phase1_launches
    d0 = fused_stencil.trapezoid_chunk.diamond_launches
    for ctx in ctxs.values():
        ctx.run_solution(0, 2 * K)
    assert fused_stencil.trapezoid_chunk.phase1_launches - p0 == 2
    assert fused_stencil.trapezoid_chunk.diamond_launches - d0 == 4
    assert ctxs["-trapezoid"].compare_data(
        ctxs["-no-trapezoid"], epsilon=0.0, abs_epsilon=0.0) == 0
