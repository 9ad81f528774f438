"""The port's pipeline path (``yask_tpu_torch.ops.pipeline``) and K6's
emission, against yask_tpu's ``yask_tpu.ops.pipeline`` on the CPU.

* The merge, the structural decline codes, push eligibility and the
  traffic model are pure Python over the DSL: they must give the same
  result in both packages (exact equality).
* The port's fused arm on CPU tensors runs K6's plain version (the merged
  program's ``StepProgram.step``); it is held against yask_tpu's fused
  ``-mode pallas -wf_steps 1 -push on`` in interpret mode (as
  tests/test_pipeline.py runs it) on the same seeded ``fwd.pressure``
  and ``fwd.vel``.
  Tolerance: compare_data's defaults plus ``field_epsilon=1e-4``, the
  repo's policy for a Pallas tile against an unfused evaluation (XLA on
  the CPU may contract or reassociate; ROADMAP.md §C2).
* Within the port the fused arm is bit-equal to the host-chained arm
  (torch mode at K=1 and 2, fused mode on the CPU): the merge rebuilds
  every expression node for node.
* The emitted multi-stage source, compiled by g++ through its host path,
  is bit-equal to ``plain_chunk`` (the same operations in the same order,
  no FMA contraction on the host).
"""

import numpy as np
import pytest

import yask_tpu
import yask_tpu_torch
from yask_tpu_torch.ops import cuda_emit, fused_stencil
from yask_tpu_torch.ops.pipeline import (SolutionPipeline, merge_solutions,
                                         pipeline_hbm_model, rtm_chain)
from yask_tpu_torch.transfer import import_interiors
from yask_tpu_torch.utils.exceptions import YaskException

from test_torch_fused import host_kernel, host_launch
from test_torch_lowering import mismatches, seeded_interiors

FEPS = 1e-4


def port_env():
    return yask_tpu_torch.yk_factory().new_env(device="cpu")


def seed_chain(pipe, sizes, seed=7):
    """fwd.pressure in every ring slot from one RandomState, as
    tests/test_pipeline.py and tools/bench_suite.py seed the chain, and
    fwd.vel = 0.05 + 0.01·U from the same generator (with vel 0 the
    Laplacian would never reach the result)."""
    v = pipe.get_var("fwd", "pressure")
    rng = np.random.RandomState(seed)
    arr = (rng.rand(*sizes).astype(np.float32) - 0.5) * 0.1
    last = [n - 1 for n in sizes]
    for t in range(v.get_first_valid_step_index(),
                   v.get_last_valid_step_index() + 1):
        v.set_elements_in_slice(arr, [t, 0, 0, 0], [t] + last)
    vel = (0.05 + 0.01 * rng.rand(*sizes)).astype(np.float32)
    pipe.get_var("fwd", "vel").set_elements_in_slice(vel, [0, 0, 0], last)


def port_pipe(cli, fuse=None, radius=2, g=(12, 12, 12), accumulate=True,
              seed=7):
    pipe = SolutionPipeline(port_env(), *rtm_chain(radius=radius,
                                                   accumulate=accumulate))
    pipe.apply_command_line_options(
        f"-g_x {g[0]} -g_y {g[1]} -g_z {g[2]} -device cpu " + cli)
    pipe.prepare(fuse=fuse)
    seed_chain(pipe, g, seed)
    return pipe


def tpu_pipe(cli, fuse=None, radius=2, g=(12, 12, 12), accumulate=True,
             seed=7):
    from yask_tpu.ops.pipeline import SolutionPipeline as TPipe
    from yask_tpu.ops.pipeline import rtm_chain as t_chain
    pipe = TPipe(yask_tpu.yk_factory().new_env(),
                 *t_chain(radius=radius, accumulate=accumulate))
    pipe.apply_command_line_options(
        f"-g_x {g[0]} -g_y {g[1]} -g_z {g[2]} " + cli)
    pipe.prepare(fuse=fuse)
    seed_chain(pipe, g, seed)
    return pipe


def observable(pipe):
    """Every written var's interior per valid step, pushed vars left out:
    {"stage.var": [array per step]}."""
    out = {}
    for s in pipe.stage_names:
        for vn in pipe.written_vars(s):
            if f"{s}__{vn}" in pipe.pushed_vars():
                continue
            v = pipe.get_var(s, vn)
            out[f"{s}.{vn}"] = [
                pipe._interior(s, vn, t)
                for t in range(v.get_first_valid_step_index(),
                               v.get_last_valid_step_index() + 1)]
    return out


# ---------------------------------------------------------------------------
# the pure-Python layer: the same result in both packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accumulate", [False, True])
def test_merge_matches_yask_tpu(accumulate):
    from yask_tpu.ops.pipeline import SolutionPipeline as TPipe
    from yask_tpu.ops.pipeline import rtm_chain as t_chain
    mine = SolutionPipeline(port_env(), *rtm_chain(radius=2,
                                                   accumulate=accumulate))
    theirs = TPipe(yask_tpu.yk_factory().new_env(),
                   *t_chain(radius=2, accumulate=accumulate))
    a, b = mine._merged, theirs._merged
    assert [(v.get_name(), [d.name for d in v.get_dims()])
            for v in a.get_vars()] == \
        [(v.get_name(), [d.name for d in v.get_dims()])
         for v in b.get_vars()]
    assert [e.skey() for e in a.get_equations()] == \
        [e.skey() for e in b.get_equations()]
    pa, ta = a.analyze(), b.analyze()
    assert len(pa.stages) == len(ta.stages) == 3
    assert pa.stage_read_widths() == ta.stage_read_widths()
    assert pa.fused_step_radius() == ta.fused_step_radius() \
        == {"x": 3, "y": 3, "z": 3}
    assert mine.signature() == theirs.signature()
    # merge_solutions is what the constructor ran
    again = merge_solutions(mine.name, mine.stages, mine.bindings, 1)
    assert [e.skey() for e in again.get_equations()] == \
        [e.skey() for e in a.get_equations()]


MUTATIONS = [
    # producer var not written (vel is read-only)
    (lambda s, b: (s, [("img", "fwd_in", "fwd", "vel")]),
     "binding-producer"),
    # consumer var unknown
    (lambda s, b: (s, [("img", "nope", "fwd", "pressure")]),
     "binding-unknown-var"),
    # producer stage not earlier than consumer
    (lambda s, b: (s, [("fwd", "vel", "img", "img")]), "binding-order"),
    # duplicate consumer binding
    (lambda s, b: (s, [b[0], b[0]] + b[1:]), "binding-duplicate"),
    # single stage
    (lambda s, b: (s[:1], []), "stage-count"),
    # reserved separator in a stage name
    (lambda s, b: ([("a__b", s[0][1])] + s[1:], b), "stage-name"),
]


@pytest.mark.parametrize("mutate,code", MUTATIONS,
                         ids=["producer-unwritten", "unknown-var", "order",
                              "duplicate", "one-stage", "bad-name"])
def test_decline_codes_match_yask_tpu_and_fall_back(mutate, code):
    from yask_tpu.ops.pipeline import SolutionPipeline as TPipe
    from yask_tpu.ops.pipeline import rtm_chain as t_chain
    s2, b2 = mutate(*rtm_chain(radius=2))
    ts2, tb2 = mutate(*t_chain(radius=2))
    mine = SolutionPipeline(port_env(), s2, b2)
    theirs = TPipe(yask_tpu.yk_factory().new_env(), ts2, tb2)
    assert [r["code"] for r in mine._struct_reasons] == \
        [r["code"] for r in theirs._struct_reasons]
    mine.apply_command_line_options("-g 8 -device cpu -mode fused")
    plan = mine.prepare()
    assert not mine.fused
    assert code in {r["code"] for r in plan["reasons"] if not r.get("ok")}
    mine.run(0, 0)                      # the host-chained arm still runs
    again = SolutionPipeline(port_env(), s2, b2)
    again.apply_command_line_options("-g 8 -device cpu -mode fused")
    with pytest.raises(YaskException, match=code):
        again.prepare(fuse=True)


@pytest.mark.parametrize("accumulate", [False, True])
def test_push_eligibility_and_hbm_model_match_yask_tpu(accumulate):
    from yask_tpu.ops.pallas_stencil import push_eligible_vars as t_elig
    from yask_tpu.ops.pipeline import pipeline_hbm_model as t_model
    mine = port_pipe("-mode fused -wf_steps 1", fuse=True,
                     accumulate=accumulate)
    theirs = tpu_pipe("-mode jit -wf_steps 1", fuse=True,
                      accumulate=accumulate)
    elig = cuda_emit.push_eligible_vars(mine.fused_ctx._program)
    assert elig == t_elig(theirs.fused_ctx._program)
    if accumulate:
        assert "ok" not in elig.values()
        assert "step offsets" in elig["img__img"]
    else:
        assert elig["img__img"] == "ok"
        assert "never read" in elig["smooth__smooth"]
    for push in (None, ["img__img"]):
        assert pipeline_hbm_model(mine, push) == t_model(theirs, push)
    # the model counts vars, not ring slots: 44 B/pt chained, 20 fused,
    # 16 with the image pushed (the pure chain); 2x for the accumulating
    model = mine.plan()["hbm_model"]
    if accumulate:
        assert model["ratio"] == pytest.approx(2.0)
    else:
        assert (model["chained_bytes_pp"], model["fused_bytes_pp"],
                model["fused_push_bytes_pp"]) == (44, 20, 16)


# ---------------------------------------------------------------------------
# the fused arm against yask_tpu's, and against the host-chained arm
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("accumulate", [False, True])
def test_fused_plain_matches_yask_tpu_pallas_push(accumulate):
    g, steps = (12, 10, 14), 4
    mine = port_pipe("-mode fused -wf_steps 1", fuse=True, g=g,
                     accumulate=accumulate)
    theirs = tpu_pipe("-mode pallas -wf_steps 1 -push on", fuse=True, g=g,
                      accumulate=accumulate)
    assert mine.pushed_vars() == theirs.pushed_vars() \
        == (set() if accumulate else {"img__img"})
    mine.run(0, steps - 1)
    theirs.run(0, steps - 1)
    a, b = observable(mine), observable(theirs)
    assert set(a) == set(b) and "smooth.smooth" in a
    assert mismatches(a, b, field_epsilon=FEPS) == 0


@pytest.mark.parametrize("mode,wf", [("torch", 1), ("torch", 2),
                                     ("fused", 1)])
@pytest.mark.parametrize("accumulate", [False, True])
def test_fused_arm_bitequal_chained(mode, wf, accumulate):
    fused = port_pipe(f"-mode {mode} -wf_steps {wf}", fuse=True,
                      g=(11, 9, 13), accumulate=accumulate)
    chained = port_pipe(f"-mode {mode} -wf_steps {wf}", fuse=False,
                        g=(11, 9, 13), accumulate=accumulate)
    assert fused.fused and not chained.fused
    fused.run(0, 3)
    chained.run(0, 3)
    assert fused.compare(chained) == 0
    # torch mode never pushes: push is the fused kernel's
    assert fused.pushed_vars() == (set() if mode == "torch" or accumulate
                                   else {"img__img"})


# ---------------------------------------------------------------------------
# K6's emitted source, compiled by g++
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("push", ["auto", "off"])
@pytest.mark.parametrize("accumulate,r", [(False, 2), (False, 3),
                                          (True, 2), (True, 3)])
def test_emitted_stages_match_plain_gxx(accumulate, r, push, tmp_path):
    import torch
    pipe = port_pipe(f"-mode fused -wf_steps 1 -push {push}", fuse=True,
                     radius=r, g=(11, 9, 13), accumulate=accumulate)
    ctx = pipe.fused_ctx
    import_interiors(ctx, seeded_interiors(ctx, 5))
    prog = ctx._program
    spec = ctx._fused_spec_kernel().spec
    assert spec.stages == 3 and spec.name.startswith("fused_stages_")
    pushed = [] if accumulate or push == "off" else ["img__img"]
    assert spec.push_vars == pushed
    assert "img__img" in spec.outputs or pushed
    fn = host_kernel(spec, tmp_path)
    state = ctx._state
    for t in (0, 1):
        got = host_launch(fn, prog, spec, state, t)
        want = fused_stencil.plain_chunk(prog, state, t, 1)
        for n, a in got.items():
            torch.testing.assert_close(a, want[n][-1], rtol=0, atol=0)
        state = want


def test_stage_tiles_and_halos_of_the_rtm_chain():
    pipe = port_pipe("-mode fused -wf_steps 1", fuse=True,
                     accumulate=False)
    spec = pipe.fused_ctx._fused_spec_kernel().spec
    # pressure(t) at r+1, pressure(t-1) and vel over the expanded region
    halos = {spec.inputs[a]: h for a, h in spec.halos.items()}
    assert halos == {("fwd__pressure", 1): ((3, 3),) * 3,
                     ("fwd__pressure", 0): ((1, 1),) * 3,
                     ("fwd__vel", 0): ((1, 1),) * 3}
    assert spec.outputs == ["fwd__pressure", "smooth__smooth"]
    assert spec.computed == ["fwd__pressure", "img__img"]
    assert spec.tile == (8, 8, 64)
    assert spec.smem_bytes == (14 * 14 * 70 + 4 * 10 * 10 * 66) * 4
    assert spec.push_smem_bytes == 10 * 10 * 66 * 4
    fk = pipe.plan()["fused_kernel"]
    assert fk["kernel"] == "stages_step" and fk["stages"] == 3
    assert fk["push_vars"] == ["img__img"] and fk["push"]
    assert fk["smem_bytes"] == spec.smem_bytes <= cuda_emit.SMEM_LIMIT
    codes = {r["code"] for r in pipe.plan()["reasons"]}
    assert {"pipeline-push-engaged", "pipeline-engaged"} <= codes
    tiling = pipe.fused_ctx._fused_spec_kernel().tiling(1)
    assert tiling["kernel"] == "stages_step" and tiling["stages"] == 3
    assert tiling["push_vars"] == ["img__img"]


def test_shared_memory_ladder_steps_down_at_r8():
    pipe = port_pipe("-mode fused -wf_steps 1", fuse=True, radius=8,
                     g=(16, 16, 16), accumulate=False)
    spec = pipe.fused_ctx._fused_spec_kernel().spec
    # the pressure tile alone is 26·26·82·4 = 221,728 B at (8, 8, 64)
    assert spec.tile != (8, 8, 64)
    assert spec.smem_bytes <= cuda_emit.SMEM_LIMIT
    assert spec.push_vars == ["img__img"]


def test_chain_too_wide_for_shared_memory_declines():
    st, b = rtm_chain(radius=40, accumulate=False)
    pipe = SolutionPipeline(port_env(), st, b)
    pipe.apply_command_line_options("-g 8 -device cpu -mode fused")
    plan = pipe.prepare()
    assert not pipe.fused
    bad = {r["code"] for r in plan["reasons"] if not r.get("ok")}
    assert bad == {"pipeline-smem-overflow"}
    with pytest.raises(YaskException, match="pipeline-smem-overflow"):
        again = SolutionPipeline(port_env(), *rtm_chain(radius=40,
                                                        accumulate=False))
        again.apply_command_line_options("-g 8 -device cpu -mode fused")
        again.prepare(fuse=True)


# ---------------------------------------------------------------------------
# push: what the pipeline exposes (tests/test_pipeline.py:241-350)
# ---------------------------------------------------------------------------


def test_pushed_var_is_hidden_and_final_outputs_stay_readable():
    pipe = port_pipe("-mode fused -wf_steps 1 -push on", fuse=True,
                     accumulate=False)
    assert pipe.pushed_vars() == {"img__img"}
    with pytest.raises(YaskException, match="push-fused"):
        pipe.get_var("img", "img")
    with pytest.raises(YaskException, match="bound input"):
        pipe.get_var("smooth", "img_in")
    pipe.run(0, 1)
    assert pipe.get_var("smooth", "smooth") is not None
    # the plain version ran on the CPU: no kernel was built or launched
    assert pipe.fused_ctx._fused.fn is None


def test_push_off_keeps_the_image_observable():
    pipe = port_pipe("-mode fused -wf_steps 1 -push off", fuse=True,
                     accumulate=False)
    assert pipe.pushed_vars() == set()
    codes = {r["code"] for r in pipe.plan()["reasons"]}
    assert "pipeline-push-ineligible" in codes
    pipe.run(0, 1)
    assert pipe.get_var("img", "img") is not None
    assert pipe.plan()["fused_kernel"]["push_smem_bytes"] == 0


def test_push_force_raises_on_the_accumulating_chain():
    with pytest.raises(YaskException, match="push-memory fusion "
                                            "infeasible"):
        port_pipe("-mode fused -wf_steps 1 -push force", fuse=True,
                  accumulate=True)
    # auto declines quietly on it and runs fused without a push
    pipe = port_pipe("-mode fused -wf_steps 1", fuse=True, accumulate=True)
    assert pipe.fused and pipe.pushed_vars() == set()
    codes = {r["code"] for r in pipe.plan()["reasons"]}
    assert "pipeline-push-ineligible" in codes


def test_push_bad_cli_value_raises():
    with pytest.raises(YaskException, match="bad -push value"):
        port_pipe("-mode fused -wf_steps 1 -push banana", fuse=True,
                  accumulate=False)


def test_push_on_a_plain_solution():
    fac = yask_tpu_torch.yk_factory()

    def ctx_with(opts):
        ctx = fac.new_solution(port_env(), stencil="iso3dfd", radius=2)
        ctx.apply_command_line_options(f"-g 8 -mode fused {opts}")
        ctx.prepare_solution()
        return ctx
    # auto and on: nothing of a one-stage solution can be pushed
    for opts in ("", "-push on", "-push off"):
        ctx = ctx_with(opts)
        assert ctx._fused_spec_kernel().spec.push_vars == []
    with pytest.raises(YaskException, match="no eligible vars"):
        ctx_with("-push force")._fused_spec_kernel()


def test_variant_key_carries_push_and_pipeline_signature():
    pipe = port_pipe("-mode fused -wf_steps 1", fuse=True,
                     accumulate=False)
    ctx = pipe.fused_ctx
    key = ctx._fused_variant_key()
    assert key[-1] == pipe.signature() and key[-2] is None
    off = port_pipe("-mode fused -wf_steps 1 -push off", fuse=True,
                    accumulate=False).fused_ctx
    assert off._fused_variant_key()[-2] is False
    assert off._fused_variant_key()[2] != key[2]   # another kernel


def test_kernel_failure_raises_out_of_run_with_no_fallback(monkeypatch):
    pipe = port_pipe("-mode fused -wf_steps 1", fuse=True,
                     accumulate=False)

    def broken(*_a):
        raise YaskException("kernel build failed: nvcc exit 1")
    monkeypatch.setattr(pipe.fused_ctx, "_run_fused_steps", broken)
    with pytest.raises(Exception, match="nvcc exit 1"):
        pipe.run(0, 0)
    # neither the host-chained arm nor another mode took over
    assert pipe._stage_ctxs is None and pipe.fused
    assert pipe.fused_ctx._steps_done == 0


def test_scratch_var_in_a_chain_runs_fused(tmp_path):
    """A two-stage chain whose first stage reads a scratch var at an
    offset: K6 computes the scratch var in a sub-stage over the stage's
    region grown by its write halo, and fused matches torch (the emitted
    sub-stages through g++ too)."""
    import torch
    from yask_tpu_torch.compiler.solution import yc_factory

    def soln():
        s = yc_factory().new_solution("stages_with_scratch")
        t = s.new_step_index("t")
        x = s.new_domain_index("x")
        y = s.new_domain_index("y")
        a = s.new_var("a", [t, x, y])
        b = s.new_var("b", [t, x, y])
        tmp = s.new_scratch_var("tmp", [x, y])
        tmp(x, y).EQUALS(a(t, x - 1, y) + a(t, x + 1, y))
        a(t + 1, x, y).EQUALS(tmp(x, y - 1) * 0.25)
        b(t + 1, x, y).EQUALS(a(t + 1, x, y + 1))
        return s
    fac = yask_tpu_torch.yk_factory()
    ctxs = {}
    for mode in ("fused", "torch"):
        ctx = fac.new_solution(port_env(), soln())
        assert len(ctx._ana.stages) == 2
        ctx.apply_command_line_options(f"-g 19 -mode {mode}")
        ctx.prepare_solution()
        import_interiors(ctx, seeded_interiors(ctx, 4))
        ctxs[mode] = ctx
    prog = ctxs["fused"]._program
    spec = cuda_emit.emit(prog)
    # tmp's sub-stage, a's stage grown by b's read, then b
    assert spec.stages == 3 and spec.scratch_stages == 1
    assert spec.computed == ["tmp", "a"]
    got = host_launch(host_kernel(spec, tmp_path), prog, spec,
                      ctxs["fused"]._state, 0)
    want = prog.step(ctxs["fused"]._state, 0)
    for n in ("a", "b"):
        torch.testing.assert_close(got[n], want[n][-1], rtol=0, atol=0)
    for ctx in ctxs.values():
        ctx.run_solution(0, 2)
    assert ctxs["fused"].compare_data(ctxs["torch"], epsilon=0.0,
                                      abs_epsilon=0.0) == 0


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
@pytest.mark.parametrize("accumulate", [False, True])
def test_k6_matches_plain_and_chained_on_card(cuda_device, accumulate):
    env = yask_tpu_torch.yk_factory().new_env()
    g = (37, 21, 70)

    def pipe(mode, fuse):
        p = SolutionPipeline(env, *rtm_chain(radius=2,
                                             accumulate=accumulate))
        p.apply_command_line_options(
            f"-g_x {g[0]} -g_y {g[1]} -g_z {g[2]} -mode {mode} "
            "-wf_steps 1")
        p.prepare(fuse=fuse)
        seed_chain(p, g)
        return p
    fused, plain, chained = (pipe("fused", True), pipe("torch", True),
                             pipe("fused", False))
    n0 = fused_stencil.stages_step.launches
    for p in (fused, plain, chained):
        p.run(0, 3)
    assert fused_stencil.stages_step.launches - n0 == 4
    # the host-chained arm runs K1 per stage: the same point functions,
    # built alike (--fmad=false), so the bits agree
    assert fused.compare(chained) == 0
    # PyTorch's CUDA `tensor / python_scalar` multiplies by the
    # reciprocal (1 ulp off true division, which the kernel and the
    # numpy oracle do): the smoother's /27 differs by ulps of the field
    # scale, so the plain version on the card gets field_epsilon
    assert mismatches(observable(fused), observable(plain),
                      field_epsilon=FEPS) == 0
