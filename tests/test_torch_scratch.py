"""K6's scratch and rewrite arms (``-mode fused`` on solutions with
scratch vars, and on vars a later stage rewrites): the families they open
against ``yask_tpu``'s pallas, the emitted point functions against the
plain version through g++, the shared-memory ladder, and the paths that
refuse or fall back.

* The plain version (what ``-mode fused`` runs on CPU tensors) against
  ``yask_tpu``'s ``-mode pallas`` in interpret mode, as
  tests/test_pallas.py:115-140 runs it: g = 20, ``init_solution_vars``,
  4 steps, K = 1 and 2.  Tolerance: ``compare_data``'s defaults, plus
  ``field_epsilon=1e-4`` for the awp family (its staggered sums, which
  the Pallas tile contracts into multiply-adds: ``_FP_REASSOC`` there).
* The emitted source built by g++ (K6's host path, ``host_stages``, the
  same ``Spec::stage<K>`` nvcc builds) against the plain version, one
  step at a time from a random state whose read-only inputs carry nonzero
  pads (a scratch var is computed past the domain and reads them there),
  into NaN-filled outputs: bit-equal, except tti by rtol 1e-5 and atol
  1e-6, since g++'s libm ``sinf``/``cosf`` and PyTorch's vectorized CPU
  ``sin``/``cos`` differ by an ulp.
"""

import numpy as np
import pytest

import yask_tpu
import yask_tpu_torch
from yask_tpu.runtime.init_utils import init_solution_vars as tpu_init
from yask_tpu_torch.ops import cuda_emit, fused_stencil
from yask_tpu_torch.runtime.init_utils import init_solution_vars as port_init
from yask_tpu_torch.transfer import export_interiors, import_interiors
from yask_tpu_torch.utils.exceptions import YaskException

from test_torch_ensemble import members_match_solo
from test_torch_fused import host_kernel
from test_torch_lowering import mismatches, seeded_interiors
from test_torch_stencils import tpu_interiors

#: the solutions the scratch arm opens (tti also at its production r=2)
SCRATCH = [("tti", 2), ("test_scratch_1d", None), ("test_scratch_2d", None),
           ("test_scratch_3d", None), ("test_scratch_stages_1d", None),
           ("test_scratch_boundary_1d", None), ("swe2d", None)]
#: the solutions the rewrite arm opens (a var written in a later stage)
REWRITE = [("awp", None), ("awp_abc", None), ("awp_elastic", None),
           ("awp_elastic_abc", None), ("test_boundary_1d", None),
           ("test_boundary_2d", None), ("test_boundary_3d", None)]
AWP = {"awp", "awp_abc", "awp_elastic", "awp_elastic_abc"}


def port_ctx(name, r, cli, device="cpu"):
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(device=device), stencil=name,
                           radius=r)
    ctx.apply_command_line_options(cli)
    ctx.prepare_solution()
    return ctx


def fused_vs_pallas(name, r, K, g=20, steps=4):
    mine = port_ctx(name, r, f"-g {g} -mode fused -wf_steps {K}")
    port_init(mine)
    tfac = yask_tpu.yk_factory()
    theirs = tfac.new_solution(tfac.new_env(), stencil=name, radius=r)
    theirs.apply_command_line_options(f"-g {g}")
    theirs.get_settings().mode = "pallas"
    theirs.get_settings().wf_steps = K
    theirs.prepare_solution()
    tpu_init(theirs)
    mine.run_solution(0, steps - 1)
    theirs.run_solution(0, steps - 1)
    fe = 1e-4 if name in AWP else 0.0
    assert mismatches(export_interiors(mine), tpu_interiors(theirs),
                      field_epsilon=fe) == 0
    til = mine.get_stats().get_tiling()
    assert til["kernel"] == "stages_step" and til["stages"] > 1


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("name,r", SCRATCH)
def test_scratch_families_fused_match_yask_tpu_pallas(name, r, K):
    fused_vs_pallas(name, r, K)


def with_pads(ctx, seed):
    """Random interiors, and random nonzero pads on every read-only
    input (the plain version reads them where a scratch var is computed
    past the domain)."""
    import torch
    import_interiors(ctx, seeded_interiors(ctx, seed))
    gen = torch.Generator().manual_seed(seed)
    for n, ring in ctx._state.items():
        if ctx._program.geoms[n].is_written:
            continue
        for a in ring:
            inner = a[ctx._interior_idx(n)].clone()
            a.copy_(0.05 + 0.01 * torch.rand(a.shape, generator=gen,
                                             dtype=a.dtype))
            a[ctx._interior_idx(n)] = inner


#: ragged sizes: several blocks in every tiled slot, a partial last one
RAGGED = {"tti": "-g_x 5 -g_y 19 -g_z 70", "test_scratch_3d":
          "-g_x 9 -g_y 19 -g_z 70", "awp": "-g_x 5 -g_y 9 -g_z 70",
          "swe2d": "-g_x 19 -g_y 70"}


def ragged(name):
    return RAGGED.get(name, "-g 37" if name.endswith("_1d") else "-g 19")


def k6_launch(fn, ctx, spec, state, t, fill):
    """One sub-step through K6's C entry point (``call_entry``, as
    ``stages_step`` calls it) on CPU tensors into outputs filled with
    ``fill``; returns the outputs."""
    import torch
    prog = ctx._program
    ins = [state[n][s] for n, s in spec.inputs]
    outs = [torch.full(tuple(prog.geoms[n].shape), fill,
                       dtype=torch.float32) for n in spec.outputs]
    assert fused_stencil.call_entry(fn, prog, spec, ins, outs, t, None) == 0
    return outs


@pytest.mark.parametrize("name,r", SCRATCH + REWRITE + [("ssg", 2),
                                                        ("fsg", 2)])
def test_emitted_stages_match_plain_gxx(name, r, tmp_path):
    import torch
    ctx = port_ctx(name, r, f"{ragged(name)} -mode fused")
    with_pads(ctx, 13)
    spec = cuda_emit.emit(ctx._program)
    assert spec.stages > 1
    fn = host_kernel(spec, tmp_path)
    state = ctx._state
    tol = dict(rtol=1e-5, atol=1e-6) if name == "tti" else \
        dict(rtol=0, atol=0)
    for t in (0, 1):
        outs = k6_launch(fn, ctx, spec, state, t, float("nan"))
        want = ctx._program.step(state, t)
        for n, a in zip(spec.outputs, outs):
            idx = ctx._interior_idx(n)
            torch.testing.assert_close(a[idx], want[n][-1][idx], **tol)
            assert torch.isnan(a).sum() == a.numel() - a[idx].numel()
        state = want


def test_scratch_is_computed_past_the_domain_from_the_pads(tmp_path):
    """tti's Hz at x = 0 reads gu at x = -1, which reads theta and phi
    in their pads: other pad contents give another answer, in the plain
    version and in the kernel alike."""
    import torch
    ctx = port_ctx("tti", 2, f"{ragged('tti')} -mode fused")
    with_pads(ctx, 13)
    spec = cuda_emit.emit(ctx._program)
    fn = host_kernel(spec, tmp_path)
    a = k6_launch(fn, ctx, spec, ctx._state, 0, 0.0)
    theta = ctx._state["theta"][0]
    inner = theta[ctx._interior_idx("theta")].clone()
    theta.fill_(0.5)
    theta[ctx._interior_idx("theta")] = inner
    b = k6_launch(fn, ctx, spec, ctx._state, 0, 0.0)
    want = ctx._program.step(ctx._state, 0)
    j = spec.outputs.index("u")
    idx = ctx._interior_idx("u")
    assert not torch.equal(a[j][idx], b[j][idx])
    torch.testing.assert_close(b[j][idx], want["u"][-1][idx], rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# the emitter: sub-stages, tiles, the shared-memory ladder
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r,tile,smem", [(2, (2, 8, 64), 209664),
                                         (4, (1, 1, 32), 188736)])
def test_tti_tiles_fit_the_ladder(r, tile, smem):
    """u and v staged with a halo of 2r, six scratch tiles (ti0-ti3, gu,
    gv) grown by their write halo r, theta and phi read in global memory
    (at the point only)."""
    ctx = port_ctx("tti", r, "-g 16 -mode fused")
    spec = cuda_emit.emit(ctx._program)
    assert spec.tile == tile and spec.smem_bytes == smem
    assert [spec.inputs[a] for a in spec.tiled] == [("u", 1), ("v", 1)]
    assert all(h == ((2 * r, 2 * r),) * 3 for h in spec.halos.values())
    assert spec.computed == ["ti0", "ti1", "ti2", "ti3", "gu", "gv"]
    assert spec.stages == 3 and spec.scratch_stages == 2
    assert spec.outputs == ["u", "v"]
    # ti0-ti3 (one sub-stage), gu and gv, then u and v: grown by r, r, 0
    assert f"sub_lo0(int k) {{ return k == 0 ? {r} : k == 1 ? {r} : " \
        "k == 2 ? 0" in spec.source


def test_ladder_raises_with_a_reason_when_nothing_fits():
    """Where no rung fits shared memory (tti r=8) the emitter no longer
    raises: it takes the workspace arm and gives its reason, and the
    solution runs (tests/test_torch_workspace.py holds the arm's code)."""
    ctx = port_ctx("tti", 8, "-g 12 -mode fused")
    spec = cuda_emit.emit(ctx._program)
    w = spec.workspace
    assert w["code"] == "workspace_engaged"
    assert "no tile of the ladder fits" in w["detail"]
    assert spec.stream_cause[0] == "skew_fallback"
    ctx.run_solution(0, 0)
    assert ctx.get_stats().get_tiling()["workspace"]["code"] == \
        "workspace_engaged"


def test_asymmetric_write_halos_grow_each_side_alone():
    """test_scratch_3d's chains: t1 is computed over x (4, 2), y (2, 4),
    z (3, 4) past the block, and A's tile covers the largest reach."""
    ctx = port_ctx("test_scratch_3d", None, "-g 16 -mode fused")
    spec = cuda_emit.emit(ctx._program)
    for s_, (lo, hi) in enumerate(((4, 2), (2, 4), (3, 4))):
        assert f"sub_lo{s_}(int k) {{ return k == 0 ? {lo} " in spec.source
        assert f"sub_hi{s_}(int k) {{ return k == 0 ? {hi} " in spec.source
    assert spec.halos[spec.tiled[0]] == ((6, 5), (6, 7), (6, 7))


def test_each_rewriting_stage_gets_its_own_tile():
    """awp writes stress_zz in stage 2 (z < last) and rewrites it in
    stage 3 (z == last) on stage 2's tile; the output is stage 3's."""
    ctx = port_ctx("awp", None, "-g 12 -mode fused")
    spec = cuda_emit.emit(ctx._program)
    assert spec.computed.count("stress_zz") == 1   # stage 2's, the base
    zz = spec.computed.index("stress_zz")
    assert f"out[0] = rd.template cmp<{zz}>(0, 0, 0);" in spec.source
    assert spec.outputs.count("stress_zz") == 1
    # the last writer stores it: sub-stage 3, var 0
    j = spec.outputs.index("stress_zz")
    assert f"k == 3 && j == 0 ? {j}" in spec.source


# ---------------------------------------------------------------------------
# the paths without the arms: refusals and fallbacks
# ---------------------------------------------------------------------------


def test_stream_arm_leaves_scratch_to_k6():
    ctx = port_ctx("tti", 2, "-g 12 -mode fused -wf_steps 2")
    import_interiors(ctx, seeded_interiors(ctx, 3))
    ctx.run_solution(0, 1)
    til = ctx.get_stats().get_tiling()
    assert til["kernel"] == "stages_step" and til["skew_dims"] == []
    assert til["scratch_stages"] == 2
    why = {r["code"]: r["detail"] for r in til["skew_reasons"]}
    assert "scratch" in why["skew_ineligible"] \
        and "ROADMAP.md A5" in why["skew_ineligible"]
    with pytest.raises(YaskException, match="scratch.*A5"):
        cuda_emit.skew_engaged_dims(ctx._program, skew=True)


def test_trapezoid_falls_back_to_k6_for_scratch():
    """What this test pinned before K4 took scratch vars (the fallback to
    K6 naming ROADMAP.md A12) is gone: a forced request runs tti's groups
    on K4, its scratch sub-stages inside each level, bit-equal to K6."""
    ctxs = {}
    for cli in ("-trapezoid", "-no-trapezoid"):
        ctx = port_ctx("tti", 2, f"-g 20 -mode fused -wf_steps 2 {cli}")
        if cli == "-trapezoid":
            ctx._trapezoid_arg = lambda: True
        import_interiors(ctx, seeded_interiors(ctx, 3))
        ctx.run_solution(0, 3)
        ctxs[cli] = ctx
    spec = ctxs["-trapezoid"]._trapezoid_kernel().spec
    assert spec.scratch_stages == 2 and spec.trap["scratch_stages"] == 2
    assert ctxs["-no-trapezoid"]._trapezoid_kernel() is None
    assert ctxs["-trapezoid"].compare_data(
        ctxs["-no-trapezoid"], epsilon=0.0, abs_epsilon=0.0) == 0


def test_k5_and_k7_refuse_scratch_naming_their_items():
    """What this test pinned before K5 took scratch sub-stages (the
    refusal "scratch ... ROADMAP.md A11") is gone: shard_pallas runs tti
    (K5 over K6's body; its plain version on the CPU), bit-equal to
    shard_map.  K7 takes the scratch arm too (ROADMAP.md A9 is done)."""
    from test_torch_k5_arms import shard_pallas_matches_shard_map
    from yask_tpu_torch.compiler.solution_base import create_solution
    shard_pallas_matches_shard_map(lambda: create_solution("tti", radius=2),
                                   "-g 16 -nr_x 2")
    members_match_solo(lambda: port_ctx("tti", 2, "-g 12 -mode fused "
                                        "-wf_steps 2 -ensemble 2"))


def test_served_sessions_of_a_scratch_solution_batch_on_the_cpu(tmp_path):
    """As multi-stage sessions: on the CPU a fused batch runs K7's plain
    version over the members (on the card K7 over K6's body,
    ``batched_stages_step``)."""
    from yask_tpu_torch.serve import StencilServer
    env = yask_tpu_torch.yk_factory().new_env(device="cpu")
    srv = StencilServer(env, journal_path=str(tmp_path / "SERVE.jsonl"),
                        preflight=False, window_secs=0.0)
    try:
        sids = [srv.open_session(stencil="tti", radius=2, g=12,
                                 mode="fused", wf=2, bucket=False)
                for _ in range(2)]
        for sid in sids:
            srv.init_vars(sid)
        handles = [srv.submit_run(sid, 0, 3) for sid in sids]
        for h in handles:
            r = srv.wait(h, timeout=120)
            assert r.ok and r.batched
    finally:
        srv.shutdown()


def test_fused_matches_the_oracle_with_a_0_dim_var():
    """awp's dt/h is a var with no dims: compare_data reads it from the
    numpy oracle's state as a scalar."""
    ctxs = {}
    for mode in ("fused", "ref"):
        ctxs[mode] = port_ctx("awp", None, f"-g 12 -mode {mode}")
        port_init(ctxs[mode])
        ctxs[mode].run_solution(0, 1)
    assert ctxs["fused"].compare_data(ctxs["ref"]) == 0


def _a3_ctx(fac, case):
    """A context of ``case``: a registered stencil, or ``<stencil>_bf16``
    at element size 2."""
    from yask_tpu_torch.compiler.solution_base import create_solution
    if case.endswith("_bf16"):
        name = case[:-len("_bf16")]
        sb = create_solution(name, radius=2)
        sb.get_soln().set_element_bytes(2)
        return fac.new_solution(fac.new_env(device="cpu"), sb)
    return fac.new_solution(fac.new_env(device="cpu"), stencil=case)


@pytest.mark.parametrize("case,why", [
    ("test_4d", "4-D.*ROADMAP.md A3 \\(4-D\\)"),
    ("tti_bf16", "element size 2.*ROADMAP.md A3 \\(element size 2 on "
                 "K6\\)")])
def test_remaining_refusals_name_a3(case, why):
    """The last A3 refusals (``why``, the message each case pinned before
    its arm was ported) are gone: ``-mode fused`` runs test_4d on K1 and
    tti in bfloat16 on K6 (the plain version on CPU tensors), bit-equal
    to ``-mode torch``; the A3 arms they take still keep K4 out
    (``a3_arms``; K5 takes them since ROADMAP.md A11's arms were ported)."""
    import re
    fac = yask_tpu_torch.yk_factory()
    ctxs = {}
    for mode in ("fused", "torch"):
        ctx = _a3_ctx(fac, case)
        ctx.apply_command_line_options(
            f"-g {8 if case == 'test_4d' else 16} -mode {mode} -wf_steps 2")
        ctx.prepare_solution()
        import_interiors(ctx, seeded_interiors(ctx, 6))
        ctx.run_solution(0, 2)
        ctxs[mode] = ctx
    ok, reason = cuda_emit.fused_applicable(ctxs["fused"]._program)
    assert ok and not re.search(why, reason)
    assert ctxs["fused"].compare_data(ctxs["torch"], epsilon=0.0,
                                      abs_epsilon=0.0) == 0
    assert ctxs["fused"].get_stats().get_tiling()["kernel"] == (
        "fused_step" if case == "test_4d" else "stages_step")
    assert cuda_emit.a3_arms(ctxs["fused"]._program) == (
        ["4-D"] if case == "test_4d" else ["element size 2"])


@pytest.mark.parametrize("case,kernel", [
    ("test_misc_2d", "fused_step"), ("test_misc_value_2d", "stages_step"),
    ("test_step_cond_1d", "stages_step"), ("box", "stages_step"),
    ("gaussian", "stages_step"), ("iso3dfd_bf16", "stream_step")])
def test_opened_a3_arms_run_fused(case, kernel):
    """The refusals the misc and element-size-2 arms removed: ``-mode
    fused`` (the plain version on CPU tensors) runs each, bit-equal to
    ``-mode torch`` from the same state."""
    fac = yask_tpu_torch.yk_factory()
    ctxs = {}
    for mode in ("fused", "torch"):
        ctx = _a3_ctx(fac, case)
        ctx.apply_command_line_options(f"-g 16 -mode {mode} -wf_steps 2")
        ctx.prepare_solution()
        import_interiors(ctx, seeded_interiors(ctx, 6))
        ctx.run_solution(0, 2)
        ctxs[mode] = ctx
    assert ctxs["fused"].compare_data(ctxs["torch"], epsilon=0.0,
                                      abs_epsilon=0.0) == 0
    assert ctxs["fused"].get_stats().get_tiling()["kernel"] == kernel


# ---------------------------------------------------------------------------
# state across packages: the new families' coefficients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,r,coeffs", [
    ("tti", 2, ("theta", "phi", "m", "damp", "epsilon", "delta")),
    ("awp", None, ("qp", "rho", "lambda_", "mu", "h")),
    ("swe2d", None, ("lam", "grav"))])
def test_transfer_carries_the_new_families(name, r, coeffs):
    """Interiors cross into the port and back unchanged, read-only
    coefficients and 0-dim vars included, with zero pads."""
    ctx = port_ctx(name, r, "-g 12 -mode torch")
    state = {n: [np.asarray(a) for a in ring]
             for n, ring in seeded_interiors(ctx, 9).items()}
    assert set(coeffs) <= set(state)
    import_interiors(ctx, state)
    back = export_interiors(ctx)
    for n in state:
        for a, b in zip(state[n], back[n]):
            np.testing.assert_array_equal(a.astype(np.float32), b)
    for n, ring in ctx._state.items():
        for a in ring:
            outside = a.clone()
            outside[ctx._interior_idx(n)] = 0
            assert not outside.any()
    if name == "awp":
        assert back["h"][0].shape == ()


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
@pytest.mark.parametrize("name,r", [("tti", 2), ("awp", None),
                                    ("swe2d", None)])
def test_k6_arms_match_plain_on_card(cuda_device, name, r):
    """K6's scratch (tti, swe2d) and rewrite (awp, swe2d) arms against the
    plain version on CUDA tensors, from the same seeded interiors: 0
    mismatches at field_epsilon 1e-4 (the build turns FMA contraction
    off, so the bits should agree)."""
    fac = yask_tpu_torch.yk_factory()
    env = fac.new_env()
    ctxs = {}
    for mode in ("torch", "fused"):
        ctx = fac.new_solution(env, stencil=name, radius=r)
        ctx.apply_command_line_options(f"-g 37 -mode {mode} -wf_steps 2")
        ctx.prepare_solution()
        ctxs[mode] = ctx
    written = {eq.lhs.var_name() for eq in ctxs["torch"]._ana.eqs}
    state = {n: [(0.01 if n in written else 1.0) * np.asarray(a)
                 for a in ring]
             for n, ring in seeded_interiors(ctxs["torch"], 6).items()}
    for ctx in ctxs.values():
        import_interiors(ctx, state)
    n0 = fused_stencil.stages_step.launches
    for ctx in ctxs.values():
        ctx.run_solution(0, 4)
    assert fused_stencil.stages_step.launches - n0 == 5
    assert all(bool(a.isfinite().all()) for ring in ctxs["fused"]
               ._state.values() for a in ring)
    assert ctxs["fused"].compare_data(ctxs["torch"], field_epsilon=1e-4) \
        == 0
