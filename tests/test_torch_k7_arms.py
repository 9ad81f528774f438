"""K7, the member batch, on every arm of the reference's vmapped chunk
(``yask_tpu/runtime/ensemble.py:234-345`` vmaps whatever
``build_pallas_chunk`` returns): several stages, scratch sub-stages,
rewrites, misc dims, partial-dim writes, element size 2 and more than
three domain dims, and a solution without equations.

* ``-mode fused -ensemble 3`` (K7's plain version on CPU tensors,
  ``plain_batched_chunk``) against ``yask_tpu``'s ``EnsembleRun`` in
  ``jit`` mode, members seeded by ``init_solution_vars`` at a seed of
  their own in both packages, 3 steps at ``-wf_steps 2`` (a chunk and a
  remainder): ``compare_data``'s rule with ``field_epsilon=1e-4`` (the
  repo's tolerance for another evaluation order, ROADMAP.md §C2), and at
  element size 2 (3e-2, 3e-2) under C13's rule.  The reference's
  interpreted ``pallas`` batch where it finishes in a few seconds.
* Each member bit-equal to its own solo ``-mode fused`` run.
* Push in a member batch: the batch runs unpushed, as the reference's
  (its ensemble build passes no ``push=``), so a var the solo kernel
  pushes is materialised in the batch (ROADMAP.md §C16).
* An empty solution (ROADMAP.md C14): ``-mode fused`` advances the step
  counters and launches nothing, as ``yask_tpu``'s ``-mode pallas``.

The kernel's own code (K7 over K1's and K6's bodies) is checked by
``tests/test_torch_k7_host.py`` (g++ host path) and
``tests/test_torch_k7_emulation.py`` (the device code emulated).
"""

import importlib

import numpy as np
import pytest

import yask_tpu
import yask_tpu_torch
from yask_tpu.runtime.ensemble import EnsembleRun as TpuEnsembleRun
from yask_tpu.runtime.init_utils import init_solution_vars as tpu_init
from yask_tpu_torch.ops import fused_stencil
from yask_tpu_torch.runtime.init_utils import init_solution_vars as port_init
from yask_tpu_torch.transfer import export_interiors

from test_torch_4d import four_d_stages
from test_torch_ensemble import members_match_solo
from test_torch_lowering import mismatches
from test_torch_partial import partial_written
from test_torch_stencils import tpu_interiors

#: the arms of a member batch: (solution, radius, element bytes, sizes,
#: the K7 wrapper that runs it on the card)
ARMS = {
    "scratch-tti": ("tti", 2, 4, "-g 12", "batched_stages_step"),
    "rewrite-awp": ("awp", None, 4, "-g 12", "batched_stages_step"),
    "stages-ssg": ("ssg", 2, 4, "-g 12", "batched_stages_step"),
    "misc-gaussian": ("gaussian", 2, 4, "-g 16", "batched_stages_step"),
    "misc-test_misc_2d": ("test_misc_2d", None, 4, "-g 16",
                          "batched_step"),
    "partial-partial_written": ("partial_written", None, 4, "-g 12",
                                "batched_stages_step"),
    "bf16-iso3dfd": ("iso3dfd", 2, 2, "-g 12", "batched_step"),
    "4d-test_4d": ("test_4d", None, 4, "-g 6", "batched_step"),
    "4d-four_d_stages": ("four_d_stages", None, 4, "-g 6",
                         "batched_stages_step"),
    "empty-test_empty": ("test_empty", None, 4, "-g 8", None),
}
#: solutions built with the DSL (the reference's tests build them too)
DSL_SOURCES = {"partial_written": partial_written,
            "four_d_stages": four_d_stages}
#: yask_tpu's tests/test_config_matrix.py:66, the element-size-2 rule
BF16_EPS = 3e-2
N, STEPS, K = 3, 3, 2


def source(pkg: str, arm: str):
    """The arm's solution source for ``new_solution`` in ``pkg``."""
    name, r, eb, _sizes, _wrapper = ARMS[arm]
    if name in DSL_SOURCES:
        return DSL_SOURCES[name](pkg)
    src = importlib.import_module(
        pkg + ".compiler.solution_base").create_solution(name, radius=r)
    src.get_soln().set_element_bytes(eb)
    return src


def port_ctx(arm: str, cli: str = "", env=None):
    """A prepared ``-mode fused`` context of the arm's solution on the
    CPU at its small sizes."""
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(env or fac.new_env(device="cpu"),
                           source("yask_tpu_torch", arm))
    ctx.apply_command_line_options(
        f"{ARMS[arm][3]} -mode fused -wf_steps {K} {cli}")
    ctx.prepare_solution()
    return ctx


def tpu_ensemble(arm: str, mode: str):
    """``yask_tpu``'s ``EnsembleRun`` of N members of the arm in ``mode``,
    member i seeded by ``init_solution_vars(seed=member_seed(i))``."""
    tfac = yask_tpu.yk_factory()
    ctx = tfac.new_solution(tfac.new_env(), source("yask_tpu", arm))
    ctx.apply_command_line_options(ARMS[arm][3])
    ctx.get_settings().mode = mode
    ctx.get_settings().wf_steps = K
    ctx.prepare_solution()
    ens = TpuEnsembleRun(ctx, N)
    for i in range(N):
        with ens.member(i) as c:
            tpu_init(c, seed=member_seed(i))
    return ens


def member_seed(i: int) -> float:
    return 0.05 * (1 + 0.5 * i)


def port_ensemble(arm: str):
    ctx = port_ctx(arm, f"-ensemble {N}")
    ens = ctx.new_ensemble()
    for i in range(N):
        with ens.member(i) as c:
            port_init(c, seed=member_seed(i))
    return ctx, ens


def held_against(arm: str, mode: str) -> None:
    """The port's batch against the reference's in ``mode``."""
    ctx, ens = port_ensemble(arm)
    ens.run(0, STEPS - 1)
    theirs = tpu_ensemble(arm, mode)
    theirs.run(0, STEPS - 1)
    eps = ((BF16_EPS, BF16_EPS, 0.0) if ARMS[arm][2] == 2
           else (1e-4, 1e-7, 1e-4))
    for i in range(N):
        with ens.member(i) as mine, theirs.member(i) as tc:
            got, want = export_interiors(mine), tpu_interiors(tc)
            assert set(got) == set(want)
            assert mismatches(got, want, *eps) == 0, (arm, i)
            assert (mine._cur_step, mine._steps_done) == \
                (tc._cur_step, tc._steps_done) == (STEPS, STEPS)
    if ARMS[arm][4] is not None:
        assert ens.tiling["kernel"] == ARMS[arm][4]
        assert ens.tiling["members"] == N


@pytest.mark.parametrize("arm", list(ARMS))
def test_member_batch_matches_yask_tpu_jit_ensemble(arm):
    held_against(arm, "jit")


@pytest.mark.parametrize("arm", ["misc-test_misc_2d",
                                 "partial-partial_written", "4d-test_4d",
                                 "empty-test_empty"])
def test_member_batch_matches_yask_tpu_pallas_ensemble(arm):
    """The reference's vmapped pallas chunk, interpreted on the CPU, where
    that finishes in a few seconds."""
    held_against(arm, "pallas")


@pytest.mark.parametrize("arm", list(ARMS))
def test_each_member_bit_equal_to_its_solo_run(arm):
    members_match_solo(lambda: port_ctx(arm), n=N)


def pushed_chain(pkg: str = "yask_tpu_torch"):
    """Three vars: ``w`` is read only at the step it is written (so a
    solo ``-push on`` kernel keeps it in shared memory), ``u`` and ``v``
    at offsets in space and time."""
    soln = importlib.import_module(
        pkg + ".compiler.solution").yc_factory().new_solution("pushed")
    t = soln.new_step_index("t")
    x, y, z = (soln.new_domain_index(d) for d in "xyz")
    u, v, w = (soln.new_var(n, [t, x, y, z]) for n in "uvw")
    u(t + 1, x, y, z).EQUALS(u(t, x, y, z) * 0.5 + u(t, x + 1, y, z) * 0.25
                             + v(t, x, y - 1, z) * 0.125)
    w(t + 1, x, y, z).EQUALS(u(t + 1, x, y, z + 1) * 0.5
                             + u(t + 1, x - 1, y, z) * 0.25)
    v(t + 1, x, y, z).EQUALS(v(t, x, y, z) * 0.5
                             + w(t + 1, x, y + 1, z) * 0.25)
    return soln


@pytest.mark.parametrize("push", ["on", "force"])
def test_push_with_a_member_batch_runs_the_batch_unpushed(push):
    """``-push on|force -ensemble 2``: the solo kernel pushes ``w``; the
    batch's kernel is a push-off build (``_batched_kernel``), as the
    reference builds its member batch with ``push=False``.  The members'
    other vars are bit-equal to their solo runs; ``w`` is materialised in
    the batch."""
    fac = yask_tpu_torch.yk_factory()

    def make():
        ctx = fac.new_solution(fac.new_env(device="cpu"), pushed_chain())
        ctx.apply_command_line_options(
            f"-g 12 -mode fused -wf_steps 2 -push {push} -ensemble 2")
        ctx.prepare_solution()
        return ctx
    ctx = make()
    assert ctx._fused_spec_kernel().spec.push_vars == ["w"]
    batch = ctx._batched_kernel()
    assert batch is not ctx._fused_spec_kernel()
    assert batch.spec.push_vars == [] and batch.spec.outputs == \
        ["u", "w", "v"]
    ens = members_match_solo(make)
    for i in range(2):
        with ens.member(i) as c:
            assert np.abs(export_interiors(c)["w"][-1]).max() > 0


def test_push_off_batches_share_the_solo_kernel():
    ctx = port_ctx("stages-ssg")
    assert ctx._batched_kernel() is ctx._fused_spec_kernel()


@pytest.mark.parametrize("name", ["test_empty", "test_empty_2d"])
def test_empty_solution_is_a_no_op_step_as_yask_tpu_pallas(name):
    """ROADMAP.md C14: no equations (test_empty_2d has a var nothing
    writes).  ``-mode fused`` launches
    nothing and advances the step counters as ``yask_tpu``'s ``-mode
    pallas`` does."""
    fac = yask_tpu_torch.yk_factory()
    mine = fac.new_solution(fac.new_env(device="cpu"), stencil=name)
    mine.apply_command_line_options("-g 8 -mode fused -wf_steps 2")
    mine.prepare_solution()
    tfac = yask_tpu.yk_factory()
    theirs = tfac.new_solution(tfac.new_env(), stencil=name)
    theirs.apply_command_line_options("-g 8 -wf_steps 2")
    theirs.get_settings().mode = "pallas"
    theirs.prepare_solution()
    k0 = [fused_stencil.fused_step.launches,
          fused_stencil.stages_step.launches,
          fused_stencil.stream_step.launches]
    mine.run_solution(0, 4)
    mine.run_solution(5, 6)
    theirs.run_solution(0, 4)
    theirs.run_solution(5, 6)
    assert k0 == [
        fused_stencil.fused_step.launches,
        fused_stencil.stages_step.launches,
        fused_stencil.stream_step.launches]
    assert (mine._cur_step, mine._steps_done) == \
        (theirs._cur_step, theirs._steps_done) == (7, 7)
    assert mine.get_var_names() == theirs.get_var_names()
    assert mismatches(export_interiors(mine), tpu_interiors(theirs),
                      0.0, 0.0) == 0
    kern = mine._fused_spec_kernel()
    assert kern.spec is None and kern.build() == 0.0
    assert mine.get_stats().get_tiling()["kernel"] is None


def test_a_forced_push_with_nothing_to_push_still_batches():
    """3axis has no var to push: ``-push force`` raises for a solo run,
    while the member batch, built push-off as the reference's, runs."""
    import yask_tpu_torch.utils.exceptions as exc
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(device="cpu"), stencil="3axis",
                           radius=1)
    ctx.apply_command_line_options("-g 8 -mode fused -push force "
                                   "-ensemble 2")
    ctx.prepare_solution()
    with pytest.raises(exc.YaskException, match="no eligible vars"):
        ctx._fused_spec_kernel()
    assert ctx._batched_kernel().spec.push_vars == []
    ens = ctx.new_ensemble()
    ens.run(0, 1)
    assert ens.tiling["kernel"] == "batched_step"


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return torch.device("cuda:0")


@pytest.mark.cuda
@pytest.mark.parametrize("arm", ["scratch-tti", "misc-gaussian",
                                 "bf16-iso3dfd", "4d-four_d_stages"])
def test_member_batch_launches_k7_on_card(cuda_device, arm):
    """On the card the batch launches K7 once per step, and each member
    is bit-equal to its solo ``-mode fused`` run."""
    fac = yask_tpu_torch.yk_factory()
    env = fac.new_env()
    wrapper = getattr(fused_stencil, ARMS[arm][4])
    n0 = wrapper.launches
    members_match_solo(lambda: port_ctx(arm, env=env), n=N)
    assert wrapper.launches - n0 == STEPS


@pytest.mark.parametrize("arm", ["bf16-iso3dfd", "misc-gaussian",
                                 "4d-test_4d"])
def test_rollback_snapshots_round_trip_member_states(arm):
    """The server's rollback target between chunks (``extract_snapshot``,
    ``apply_snapshot``) on a member of a batch: bfloat16, misc and 4-D
    states come back to the bit, with the member's step counters."""
    from yask_tpu_torch.resilience.checkpoint import (apply_snapshot,
                                                      extract_snapshot)
    _ctx, ens = port_ensemble(arm)
    ens.run(0, 1)
    for i in range(N):
        with ens.member(i) as c:
            snap = extract_snapshot(c)
            before = export_interiors(c)
            c.run_solution(2, 3)
            assert apply_snapshot(c, snap)
            after = export_interiors(c)
            assert (c._cur_step, c._steps_done) == (2, 2)
        for name, ring in before.items():
            for a, b in zip(ring, after[name]):
                assert np.array_equal(a, b), (arm, i, name)


@pytest.mark.parametrize("name,r,g", [("gaussian", 2, 16),
                                      ("test_4d", None, 6), ("tti", 2, 12)])
def test_served_fused_batches_of_every_arm_on_the_cpu(name, r, g,
                                                      tmp_path):
    """Misc, 4-D and scratch sessions batch in the server (K7's plain
    version on the CPU; ``batched_step``/``batched_stages_step`` on the
    card), a rollback snapshot taken before each chunk, and each answer
    is bit-identical to a solo ``-mode fused`` run."""
    from yask_tpu_torch.runtime.init_utils import init_solution_vars
    from yask_tpu_torch.serve import StencilServer
    from yask_tpu_torch.serve.scheduler import extract_outputs
    env = yask_tpu_torch.yk_factory().new_env(device="cpu")
    srv = StencilServer(env, journal_path=str(tmp_path / "SERVE.jsonl"),
                        preflight=False, window_secs=0.0)
    try:
        sids = [srv.open_session(stencil=name, radius=r, g=g, mode="fused",
                                 wf=2, bucket=False) for _ in range(2)]
        for sid in sids:
            srv.init_vars(sid)
        resps = [srv.wait(h, timeout=120)
                 for h in [srv.submit_run(sid, 0, 3) for sid in sids]]
    finally:
        srv.shutdown()
    fac = yask_tpu_torch.yk_factory()
    solo = fac.new_solution(fac.new_env(device="cpu"), stencil=name,
                            radius=r)
    solo.apply_command_line_options(f"-g {g} -mode fused -wf_steps 2")
    solo.prepare_solution()
    init_solution_vars(solo)
    solo.run_solution(0, 3)
    want = extract_outputs(solo)
    for resp in resps:
        assert resp.ok and resp.batched and resp.batch == 2, resp.error
        for n, a in want.items():
            assert np.array_equal(resp.outputs[n], a), n
