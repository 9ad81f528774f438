"""K1's stream arm (``-mode fused -skew``) against yask_tpu's ``-mode
pallas -skew``, and the knob with its reason codes.

The port's answer to the reference's skewed wavefront (K3) and DMA
prefetch (K2) is a second arm of K1, ``stream_step``: each block walks
slot 0 through a ring of staged planes (``csrc/stream_step.cuh``).  It
mirrors ``tests/test_skew.py`` where that applies:

* the knob: ``-skew`` selects the arm, ``-no-skew`` keeps K1
  (``test_skew_off_knob``); 2-D and multi-stage runs keep their kernels
  and say why (``test_skew_engages_*``); ensemble and shard runs take K7
  and K5 over the arm (``_stream_batched``, ``_stream_region``) and keep
  K1's body under ``-no-skew``;
* the port's ``-mode fused -skew`` (on the CPU the wrapper takes its plain
  version, ``plain_chunk``) against yask_tpu's ``-mode pallas -skew`` in
  interpret mode, as ``tests/test_torch_fused.py`` runs it, on the same
  seeded interiors.  Tolerance: ``field_epsilon=1e-4``, the repo's policy
  for a fused kernel against an unfused path (ROADMAP.md C2);
* the stream entry's host path, compiled with g++, against
  ``plain_chunk`` to the bit (``tests/test_torch_kernel_emulation.py``
  runs its device code);
* on the card (``cuda`` marker): the arm against K1 to the bit and
  against its plain version.
"""

import pytest

import yask_tpu
import yask_tpu_torch
from yask_tpu_torch.ops import cuda_emit, fused_stencil, tile_planner
from yask_tpu_torch.transfer import export_interiors, import_interiors
from yask_tpu_torch.utils.exceptions import YaskException

from test_torch_fused import host_kernel
from test_torch_lowering import (mismatches, seeded_interiors, tpu_export,
                                 tpu_import)


def _sizes(g):
    if isinstance(g, int):
        return f"-g {g}"
    return " ".join(f"-g_{d} {n}" for d, n in zip("xyz", g))


def port_ctx(stencil, r, g, K=1, cli="", mode="fused", source=None,
             env=None):
    fac = yask_tpu_torch.yk_factory()
    env = env or fac.new_env(device="cpu")
    ctx = (fac.new_solution(env, source) if source is not None else
           fac.new_solution(env, stencil=stencil, radius=r))
    ctx.apply_command_line_options(
        f"{_sizes(g)} -mode {mode} -wf_steps {K} {cli}")
    ctx.prepare_solution()
    return ctx


def tpu_ctx(stencil, r, g, K):
    """yask_tpu's pallas mode (interpret on the CPU) with ``-skew``, its
    default."""
    fac = yask_tpu.yk_factory()
    ctx = fac.new_solution(fac.new_env(), stencil=stencil, radius=r)
    ctx.apply_command_line_options(f"{_sizes(g)} -wf_steps {K} -skew")
    ctx.get_settings().mode = "pallas"
    ctx.prepare_solution()
    return ctx


def codes(reasons):
    return [r["code"] for r in reasons]


def run_seeded(ctx, steps, seed=5):
    import_interiors(ctx, seeded_interiors(ctx, seed))
    ctx.run_solution(0, steps - 1)
    return ctx


# ---------------------------------------------------------------------------
# the knob
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cli,kernel,dims,code", [
    ("-skew", "stream_step", ["x"], "skew_engaged"),
    ("-no-skew", "fused_step", [], "skew_disabled")])
def test_skew_knob_selects_the_arm(cli, kernel, dims, code):
    """Both arms run K steps per chunk with a remainder and give the
    plain version's bits; the tiling says which arm ran and why."""
    ctx = run_seeded(port_ctx("iso3dfd", 2, (13, 11, 20), 2, cli), 5)
    til = ctx.get_stats().get_tiling()
    assert til["kernel"] == kernel and til["skew_dims"] == dims
    assert til["skew"] is bool(dims) and til["pipeline_dmas"] is bool(dims)
    assert codes(til["skew_reasons"])[0] == code
    if dims:
        assert til["name"].endswith("_stream")
        assert til["plane_tile"] == [16, 64] and til["prefetch"] == 2
        assert til["ring_depths"] == {ctx._fused.spec.tiled[0]: 8}
        assert til["smem_bytes"] == 8 * 20 * 68 * 4
        assert til["register_queue"] == 2 and til["blocks_per_sm"] == 2
        assert codes(til["skew_reasons"]) == ["skew_engaged",
                                              "skew_ineligible"]
    plain = run_seeded(port_ctx("iso3dfd", 2, (13, 11, 20), 2,
                                mode="torch"), 5)
    assert ctx.compare_data(plain, epsilon=0.0, abs_epsilon=0.0) == 0


def test_skew_is_on_by_default_as_in_the_reference():
    ctx = port_ctx("3axis", 1, 12)
    assert ctx.get_settings().skew_wavefront is True
    assert ctx._fused_spec_kernel().skew_dims == ["x"]
    assert "-skew" in ctx.get_command_line_help()


def test_skew_dims_zero_leaves_the_stream_dim_out():
    ctx = run_seeded(port_ctx("iso3dfd", 2, 12, 1, "-skew -skew_dims 0"), 2)
    til = ctx.get_stats().get_tiling()
    assert til["kernel"] == "fused_step" and til["skew_dims"] == []
    assert codes(til["skew_reasons"]) == ["skew_ineligible"] * 2
    assert "-skew_dims 0" in til["skew_reasons"][0]["detail"]


def test_skew_off_knob_matches_yask_tpu():
    """-no-skew against yask_tpu's pallas with its skew off
    (``test_skew_off_knob``): K1's plain version, the uniform tiling."""
    mine = port_ctx("iso3dfd", 8, 24, 2, "-no-skew")
    fac = yask_tpu.yk_factory()
    theirs = fac.new_solution(fac.new_env(), stencil="iso3dfd", radius=8)
    theirs.apply_command_line_options("-g 24 -wf_steps 2 -no-skew")
    theirs.get_settings().mode = "pallas"
    theirs.prepare_solution()
    state = seeded_interiors(mine, 4)
    import_interiors(mine, state)
    tpu_import(theirs, state)
    mine.run_solution(0, 3)
    theirs.run_solution(0, 3)
    assert mismatches(export_interiors(mine), tpu_export(theirs),
                      field_epsilon=1e-4) == 0
    assert theirs.get_stats().get_tiling()["skew_dims"] == []
    assert mine.get_stats().get_tiling()["kernel"] == "fused_step"


# ---------------------------------------------------------------------------
# what keeps its kernel, and why
# ---------------------------------------------------------------------------


def _in_plane():
    """A 3-D solution read at offsets in slots 1 and 2 only: nothing to
    carry from plane to plane."""
    from yask_tpu_torch.compiler.solution import yc_factory
    s = yc_factory().new_solution("in_plane")
    t = s.new_step_index("t")
    x = s.new_domain_index("x")
    y = s.new_domain_index("y")
    z = s.new_domain_index("z")
    u = s.new_var("u", [t, x, y, z])
    u(t + 1, x, y, z).EQUALS(0.5 * (u(t, x, y - 1, z) + u(t, x, y, z + 1)))
    return s


def test_skew_ineligible_2d_keeps_k1():
    ctx = run_seeded(port_ctx("wave2d", 2, 24, 2, "-skew"), 3)
    til = ctx.get_stats().get_tiling()
    assert til["kernel"] == "fused_step" and til["skew"] is False
    assert codes(til["skew_reasons"]) == ["skew_ineligible"]
    assert "2-D solution" in til["skew_reasons"][0]["detail"]
    assert ctx._fused.spec.stream is None
    assert "_stream" not in ctx._fused.spec.source


def test_skew_ineligible_without_slot0_reads_keeps_k1():
    ctx = run_seeded(port_ctx(None, 0, 12, 1, "-skew", source=_in_plane()),
                     2)
    til = ctx.get_stats().get_tiling()
    assert til["kernel"] == "fused_step"
    assert codes(til["skew_reasons"]) == ["skew_ineligible"] * 2
    assert "slot-0 offset" in til["skew_reasons"][0]["detail"]


def test_skew_multi_stage_keeps_k6():
    """A multi-stage chain stays on K6's wrapper: under ``-skew`` it takes
    K6's stream arm (``stages_step`` launching ``<name>_stages_stream``),
    under ``-no-skew`` K6's body."""
    from yask_tpu_torch.ops.pipeline import SolutionPipeline, rtm_chain
    kerns = {}
    for cli in ("-skew", "-no-skew"):
        pipe = SolutionPipeline(
            yask_tpu_torch.yk_factory().new_env(device="cpu"),
            *rtm_chain(radius=2, accumulate=False))
        pipe.apply_command_line_options(f"-g 12 -mode fused -wf_steps 1 "
                                        f"{cli}")
        pipe.prepare(fuse=True)
        kerns[cli] = pipe.fused_ctx._fused_spec_kernel()
    kern = kerns["-skew"]
    assert kern.spec.stages > 1 and kern.skew_dims == ["x"]
    til = kern.tiling(1)
    assert til["kernel"] == "stages_step"
    assert til["name"] == kern.spec.name + "_stages_stream"
    assert codes(til["skew_reasons"]) == ["skew_engaged", "skew_ineligible"]
    assert til["skew_reasons"][0]["kernel"] == "stages_stream"
    kern = kerns["-no-skew"]
    assert kern.spec.stages > 1 and kern.skew_dims == []
    til = kern.tiling(1)
    assert til["kernel"] == "stages_step" and til["name"] == kern.spec.name
    assert codes(til["skew_reasons"]) == ["skew_disabled"]


def test_skew_ensemble_keeps_k7():
    """A member batch runs K7 (its plain version here) over the arm the
    solo run takes: under ``-skew`` K7 over K1's stream arm, its tiling
    naming ``_stream_batched`` and the batch's segments; under
    ``-no-skew`` K7 over K1's body."""
    for cli, skew in (("-skew", True), ("-no-skew", False)):
        ctx = port_ctx("iso3dfd", 2, 12, 2, cli)
        kern = ctx._fused_spec_kernel()
        assert kern.skew_dims == (["x"] if skew else [])
        ens = ctx.new_ensemble(3)
        for i in range(3):
            with ens.member(i):
                import_interiors(ctx, seeded_interiors(ctx, 10 + i))
        ens.run(0, 2)
        til = ens.tiling
        assert til["kernel"] == "batched_step" and til["members"] == 3
        assert til["skew"] is skew
        if skew:
            assert til["skew_dims"] == ["x"]
            assert til["name"] == kern.spec.name + "_stream_batched"
            assert codes(til["skew_reasons"]) == ["skew_engaged",
                                                  "skew_ineligible"]
            assert til["skew_reasons"][0]["kernel"] == "stream_batched"
            assert til["segment_planes"] == \
                kern.batch_segment(3)["segment_planes"]
            assert "plane_tile" in til
        else:
            assert til["skew_dims"] == []
            assert til["name"] == kern.spec.name + "_batched"
            assert codes(til["skew_reasons"]) == ["skew_disabled"]
            assert "plane_tile" not in til


def test_skew_shard_keeps_k5():
    """K5 over a single-stage solution runs over K1's stream arm under
    ``-skew`` (``_stream_region``, each box's segments in the record) and
    over K1's body under ``-no-skew``."""
    fac = yask_tpu_torch.yk_factory()
    for cli, skew in (("-skew", True), ("-no-skew", False)):
        ctx = fac.new_solution(fac.new_env(devices=["cpu"] * 4),
                               stencil="iso3dfd", radius=2)
        ctx.apply_command_line_options(
            f"-g 16 -mode shard_pallas -wf_steps 2 -nr_x 2 -nr_y 2 {cli}")
        ctx.prepare_solution()
        run_seeded(ctx, 2)
        til = ctx.get_stats().get_tiling()
        kern = ctx._shard.kernel
        assert til["kernel"] == "shard_step" and til["skew"] is skew
        if skew:
            assert til["name"] == kern.spec.name + "_stream_region"
            assert codes(til["skew_reasons"])[0] == "skew_engaged"
            assert til["skew_reasons"][0]["kernel"] == "stream_region"
            assert til["stream"]["box_segments"] == [
                kern.region_segment({"x": (-2, 10), "y": (-2, 10),
                                     "z": (0, 16)}),
                kern.region_segment({"x": (0, 8), "y": (0, 8),
                                     "z": (0, 16)})]
        else:
            assert til["name"] == kern.spec.name + "_region"
            assert codes(til["skew_reasons"]) == ["skew_disabled"]


def test_skew_falls_back_where_the_rings_do_not_fit(monkeypatch):
    """Rings past the shared memory: auto keeps K1 (``skew_fallback``),
    forced raises."""
    monkeypatch.setattr(cuda_emit, "SMEM_LIMIT", 57000)
    ctx = port_ctx("iso3dfd", 8, 20, 1, "-skew")
    kern = ctx._fused_spec_kernel()
    assert kern.skew_dims == [] and kern.spec.stream is None
    assert codes(kern.skew_reasons) == ["skew_fallback"] * 2
    assert kern.spec.smem_bytes <= 57000          # K1 still fits
    with pytest.raises(YaskException, match="infeasible"):
        fused_stencil.FusedKernel(ctx._program, skew=True)


def test_forced_skew_raises_where_it_cannot_run():
    ctx = port_ctx("wave2d", 2, 24, 1)
    ctx._skew_arg = lambda: True
    with pytest.raises(YaskException, match="2-D solution"):
        ctx.run_solution(0, 0)


def test_stream_plan_of_the_flagship():
    """iso3dfd r=8 at 512³ (the plan alone, no state): 16×64 plane tiles
    with 20-plane rings (2.5 staged cells per point in the plane, against
    K1's 11.25), one 512-plane segment per column, 256 blocks, one per
    SM, so a register queue of 3."""
    halo = {0: ((8, 8), (8, 8), (8, 8))}
    plan = tile_planner.stream_plan(halo, (512, 512, 512), 4)
    assert plan.tile == (16, 64) and plan.prefetch == 2
    assert plan.depths == {0: 20} and plan.smem_bytes == 204800
    assert (plan.seg, plan.segments, plan.blocks) == (512, 1, 256)
    assert plan.per_sm == 1 and plan.queue == 3
    assert plan.staged_per_point[0] == pytest.approx(2.5 * 528 / 512)
    # the ladder's second plane tile, and fp64 stepping down
    assert 20 * 48 * 48 * 4 == 184320 <= cuda_emit.SMEM_LIMIT
    p64 = tile_planner.stream_plan(halo, (512, 512, 512), 8)
    assert p64.smem_bytes <= cuda_emit.SMEM_LIMIT and p64.tile != (16, 64)
    # a small domain takes more segments to fill the card
    small = tile_planner.stream_plan(halo, (64, 64, 64), 4)
    assert small.segments > 1 and small.seg * small.segments >= 64


# ---------------------------------------------------------------------------
# the port's stream arm against yask_tpu's pallas -skew (interpret)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stencil,r,g,K,steps", [
    ("iso3dfd", 2, 16, 1, 3), ("iso3dfd", 2, 16, 2, 5),
    ("iso3dfd", 8, 24, 1, 3), ("iso3dfd", 8, 24, 2, 4),
    ("iso3dfd_sponge", 2, 16, 2, 4), ("cube", 1, 16, 2, 4),
    ("3axis", 1, 16, 2, 4)])
def test_stream_arm_matches_pallas_skew_interpret(stencil, r, g, K, steps):
    mine = port_ctx(stencil, r, g, K, "-skew")
    theirs = tpu_ctx(stencil, r, g, K)
    state = seeded_interiors(mine, 21)
    import_interiors(mine, state)
    tpu_import(theirs, state)
    mine.run_solution(0, steps - 1)
    theirs.run_solution(0, steps - 1)
    assert mismatches(export_interiors(mine), tpu_export(theirs),
                      field_epsilon=1e-4) == 0
    til = mine.get_stats().get_tiling()
    assert til["kernel"] == "stream_step" and til["skew_dims"] == ["x"]


# ---------------------------------------------------------------------------
# the stream entry's host path, compiled by g++
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stencil,r", [("iso3dfd", 2), ("cube", 1),
                                       ("iso3dfd_sponge", 2)])
def test_stream_entry_host_path_matches_plain_gxx(stencil, r, tmp_path):
    """The stream entry through ``call_stream_entry`` on CPU tensors:
    K1's host loop, then every pad cell of the NaN-filled outputs set to
    0; to the bit against ``plain_chunk``."""
    import torch
    ctx = port_ctx(stencil, r, (9, 11, 70), 1, "-skew")
    import_interiors(ctx, seeded_interiors(ctx, 13))
    prog = ctx._program
    spec = ctx._fused_spec_kernel().spec
    fn = host_kernel(spec, tmp_path, entry=spec.name + "_stream")
    fn.argtypes = fused_stencil.stream_argtypes()
    state = ctx._state
    for t in (0, 1):
        ins = [state[n][s] for n, s in spec.inputs]
        outs = [torch.full(tuple(prog.geoms[n].shape), float("nan"))
                for n in spec.outputs]
        assert fused_stencil.call_stream_entry(fn, prog, spec, ins, outs, t,
                                               None) == 0
        want = fused_stencil.plain_chunk(prog, state, t, 1)
        for n, a in zip(spec.outputs, outs):
            assert torch.equal(a, want[n][-1])
        state = want


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
@pytest.mark.parametrize("name,r,g", [("iso3dfd", 8, 48),
                                      ("3axis", 1, (67, 45, 131))])
def test_stream_step_matches_k1_and_plain_on_card(cuda_device, name, r, g):
    """The stream arm against K1 to the bit (both built with
    --fmad=false, one Spec::point) and against its plain version at
    ``field_epsilon`` (3axis divides: ROADMAP.md C5)."""
    fac = yask_tpu_torch.yk_factory()
    env = fac.new_env()
    ctxs = {arm: port_ctx(name, r, g, 2, cli, mode=mode, env=env)
            for arm, cli, mode in (("stream", "-skew", "fused"),
                                   ("k1", "-no-skew", "fused"),
                                   ("plain", "", "torch"))}
    state = seeded_interiors(ctxs["plain"], 4)
    n_s = fused_stencil.stream_step.launches
    n_k = fused_stencil.fused_step.launches
    for ctx in ctxs.values():
        import_interiors(ctx, state)
        ctx.run_solution(0, 4)
    assert fused_stencil.stream_step.launches - n_s == 5
    assert fused_stencil.fused_step.launches - n_k == 5
    assert ctxs["stream"].compare_data(ctxs["k1"], epsilon=0.0,
                                       abs_epsilon=0.0) == 0
    assert ctxs["stream"].compare_data(ctxs["plain"],
                                       field_epsilon=1e-4) == 0
