"""Ensemble batching in the port (``yask_tpu_torch/runtime/ensemble.py``)
and K7, the member-batched fused kernel.

* Port members in ``torch`` and ``fused`` mode are bit-identical to port
  solo runs (fused runs K7's plain version on the CPU: ``plain_chunk`` on
  each member's view of the stacked state).
* Port members agree with ``yask_tpu``'s ``EnsembleRun`` (jit, and pallas
  under interpret, as tests/test_ensemble.py runs them) within
  ``compare_data(field_epsilon=1e-4)``: XLA on the CPU and eager PyTorch
  round at the field scale differently (ROADMAP.md §C2).
* Masked torch-mode sub-domain members are bit-identical to a solo run at
  their own size; fused mode refuses to mask.
* K7's emitted entry point, built for the host with g++, is bit-equal to
  ``plain_chunk`` for each member (iso3dfd has no libm calls, so the
  host build and eager PyTorch round alike).
* A batched launch that fails raises out of ``EnsembleRun.run``; nothing
  reruns the members one after another.
"""

import numpy as np
import pytest

import yask_tpu
import yask_tpu_torch
from yask_tpu.runtime.ensemble import EnsembleRun as TpuEnsembleRun
from yask_tpu_torch.ops import cuda_emit, fused_stencil
from yask_tpu_torch.runtime.ensemble import (BATCHED_MODES, TORCH_SEQUENTIAL,
                                             EnsembleRun, ensemble_feasible)
from yask_tpu_torch.runtime.init_utils import init_solution_vars
from yask_tpu_torch.serve.scheduler import extract_outputs
from yask_tpu_torch.transfer import export_interiors, import_interiors
from yask_tpu_torch.utils.exceptions import YaskException

from test_torch_fused import host_kernel
from test_torch_lowering import mismatches, seeded_interiors, tpu_export

G = 16
STEPS = 4   # two wf=2 chunks
N = 3


def port_ctx(mode, g=G, wf=2, cli=""):
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(device="cpu"), stencil="iso3dfd",
                           radius=2)
    ctx.apply_command_line_options(
        f"-g {g} -mode {mode} -wf_steps {wf} {cli}")
    ctx.prepare_solution()
    return ctx


def seed_member(ctx, i, g=G):
    """Member i's initial condition (as tests/test_ensemble.py seeds
    yask_tpu's members), through the yk_var API of either package."""
    ctx.get_var("vel").set_all_elements_same(0.5)
    rng = np.random.RandomState(100 + i)
    arr = (rng.rand(g, g, g).astype(np.float32) - 0.5) * 0.1
    ctx.get_var("pressure").set_elements_in_slice(
        arr, [0, 0, 0, 0], [0, g - 1, g - 1, g - 1])


def port_ensemble(mode, n=N, cli=""):
    ctx = port_ctx(mode, cli=cli)
    seed_member(ctx, 0)
    ens = ctx.new_ensemble(n)
    for i in range(1, n):
        with ens.member(i) as c:
            seed_member(c, i)
    return ctx, ens


def members_match_solo(make, n=2, steps=3, seed=40):
    """A fused batch of ``n`` members of ``make()`` (a prepared ``-mode
    fused`` context) from numpy-seeded interiors, against a solo run of
    ``make()`` per member from the same interiors: each member's vars
    bit-equal to its solo run's (a var the solo kernel pushes aside: the
    batch materialises it, ROADMAP.md §C16), and its step counters those
    of the solo run.  Returns the ensemble."""
    ctx = make()
    ens = ctx.new_ensemble(n)
    seeds = []
    for i in range(n):
        with ens.member(i) as c:
            seeds.append(seeded_interiors(c, seed + i))
            import_interiors(c, seeds[i])
    ens.run(0, steps - 1)
    for i in range(n):
        solo = make()
        import_interiors(solo, seeds[i])
        solo.run_solution(0, steps - 1)
        spec = solo._fused_spec_kernel().spec
        pushed = set(spec.push_vars) if spec is not None else set()
        want = export_interiors(solo)
        with ens.member(i) as c:
            got = export_interiors(c)
            assert (c._cur_step, c._steps_done) == (solo._cur_step,
                                                     solo._steps_done)
        assert set(got) == set(want)
        for name in set(want) - pushed:
            for a, b in zip(got[name], want[name]):
                assert np.array_equal(a, b), (i, name)
    return ens


def state_of(run_state):
    """A run state's rings as host copies."""
    return {n: [a.numpy().copy() for a in ring]
            for n, ring in run_state.state.items()}


@pytest.mark.parametrize("mode", BATCHED_MODES)
def test_port_members_bit_identical_to_port_solo(mode):
    ctx, ens = port_ensemble(mode)
    k0 = fused_stencil.batched_step.launches
    ens.run(0, STEPS - 1)
    # on the CPU the K7 wrapper takes its plain version: no launch
    assert fused_stencil.batched_step.launches == k0
    assert ens.batched_reason == ("" if mode == "fused"
                                  else TORCH_SEQUENTIAL)
    for i in range(N):
        solo = port_ctx(mode)
        seed_member(solo, i)
        solo.run_solution(0, STEPS - 1)
        with ens.member(i) as c:
            got, want = state_of(c.get_run_state()), state_of(
                solo.get_run_state())
            for name in want:
                for s, (x, y) in enumerate(zip(got[name], want[name])):
                    assert np.array_equal(x, y), (mode, i, name, s)
            assert c._cur_step == STEPS and c._steps_done == STEPS


@pytest.mark.parametrize("port_mode,tpu_mode,cli", [
    ("torch", "jit", ""), ("fused", "pallas", "-skew")],
    ids=["torch-jit", "fused-pallas"])
def test_port_members_agree_with_yask_tpu_ensemble(port_mode, tpu_mode,
                                                   cli):
    """With ``-skew`` the batch runs K7 over K1's stream arm
    (``_stream_batched``; its plain version here)."""
    ctx, ens = port_ensemble(port_mode, cli=cli)
    ens.run(0, STEPS - 1)
    if cli:
        til = ens.tiling
        assert til["kernel"] == "batched_step" and til["skew"] is True
        assert til["name"] == \
            ctx._fused_spec_kernel().spec.name + "_stream_batched"
        assert til["skew_reasons"][0]["kernel"] == "stream_batched"
    fac = yask_tpu.yk_factory()
    tctx = fac.new_solution(fac.new_env(), stencil="iso3dfd", radius=2)
    tctx.apply_command_line_options(f"-g {G} -wf_steps 2")
    tctx.get_settings().mode = tpu_mode
    tctx.prepare_solution()
    seed_member(tctx, 0)
    tens = TpuEnsembleRun(tctx, N)
    for i in range(1, N):
        with tens.member(i) as c:
            seed_member(c, i)
    tens.run(0, STEPS - 1)
    for i in range(N):
        with ens.member(i) as mine, tens.member(i) as theirs:
            assert mismatches(export_interiors(mine), tpu_export(theirs),
                              field_epsilon=1e-4) == 0, i


def test_masked_torch_members_bit_identical_to_solo_at_own_size():
    subs = [{"x": 10, "y": 10, "z": 10}, None, {"x": 12, "y": 12, "z": 12}]
    ctx = port_ctx("torch")
    members = [ctx.new_run_state() for _ in subs]
    ens = EnsembleRun(ctx, members=members, sub_domains=subs)
    assert ens.masked
    for i, sd in enumerate(subs):
        with ens.member(i) as c:
            init_solution_vars(c, sub_sizes=sd)
    ens.run(0, STEPS - 1)
    for i, sd in enumerate(subs):
        g = (sd or {}).get("x", G)
        solo = port_ctx("torch", g=g)
        init_solution_vars(solo)
        solo.run_solution(0, STEPS - 1)
        want = extract_outputs(solo)
        with ens.member(i) as c:
            got = extract_outputs(c, sub_sizes=sd)
        for name, a in want.items():
            assert got[name].shape == a.shape
            assert np.array_equal(got[name], a), (i, name)


def test_fused_mode_refuses_to_mask():
    ctx = port_ctx("fused")
    with pytest.raises(YaskException, match="fuses steps"):
        EnsembleRun(ctx, members=[ctx.new_run_state()],
                    sub_domains=[{"x": 8, "y": 8, "z": 8}])
    # full-domain members (all None) are not masked and batch as usual
    ens = EnsembleRun(ctx, members=[ctx.new_run_state()],
                      sub_domains=[None])
    assert not ens.masked


def test_k7_host_path_bit_equal_to_plain_chunk_per_member(tmp_path):
    """K7's C entry point built with g++ (``host_step`` grows the member
    loop) through the same ``call_batched_entry`` marshalling the CUDA
    path uses, against ``plain_chunk`` on each member's view."""
    import torch
    ctx, ens = port_ensemble("fused")
    prog = ctx._program
    spec = cuda_emit.emit(prog)
    assert f"YT_FUSED_BATCHED_ENTRY({spec.name}_batched, Spec)" \
        in spec.source
    fn = host_kernel(spec, tmp_path, entry=spec.name + "_batched")
    stacked = ens._stack_states()
    for t in (0, 1):
        ins = [stacked[n][s] for n, s in spec.inputs]
        outs = [torch.zeros((N,) + tuple(prog.geoms[n].shape))
                for n in spec.outputs]
        assert fused_stencil.call_batched_entry(
            fn, prog, spec, ins, outs, N, t, None) == 0
        for i in range(N):
            member = {n: [a[i] for a in ring]
                      for n, ring in stacked.items()}
            want = fused_stencil.plain_chunk(prog, member, t, 1)
            for o, name in zip(outs, spec.outputs):
                assert torch.equal(o[i], want[name][-1]), (t, i, name)


def test_failed_batched_launch_raises_not_sequential(monkeypatch):
    ctx, ens = port_ensemble("fused")
    before = [state_of(m) for m in ens._members]

    def broken(*_a, **_k):
        raise RuntimeError("batched_step kernel launch failed: CUDA "
                           "error 700")
    monkeypatch.setattr(fused_stencil.FusedKernel, "batched_chunk", broken)
    monkeypatch.setattr(type(ctx), "run_solution",
                        lambda *_a, **_k: pytest.fail(
                            "members ran one after another"))
    with pytest.raises(RuntimeError, match="launch failed"):
        ens.run(0, STEPS - 1)
    # the members' rings and step counters are as they were
    for b, m in zip(before, ens._members):
        assert m.cur_step == 0 and m.steps_done == 0
        after = state_of(m)
        for name in b:
            for x, y in zip(b[name], after[name]):
                assert np.array_equal(x, y)


def test_k7_wrapper_takes_plain_version_only_for_cpu_tensors():
    ctx, ens = port_ensemble("fused")
    kern = fused_stencil.FusedKernel(ctx._program)
    stacked = ens._stack_states()
    k0 = fused_stencil.batched_step.launches
    kern.batched_chunk(stacked, 0, 2, N)
    assert fused_stencil.batched_step.launches == k0
    assert kern.batched_fn is None          # nothing was built
    meta = {n: [a.to("meta") for a in ring] for n, ring in stacked.items()}
    with pytest.raises(YaskException, match="CUDA or CPU"):
        kern.batched_chunk(meta, 0, 1, N)
    import torch
    kern.dtype = torch.float32
    with pytest.raises(YaskException, match="not a CUDA tensor"):
        fused_stencil.batched_step(kern, stacked, 0, N)
    # 70000 members x 4 slot-0 blocks pass CUDA's z limit: the launch code
    # walks them in chunks (tests/test_torch_k7_emulation.py runs that
    # code), so the wrapper's marshalling refuses nothing before it
    z = fused_stencil.grid_z(ctx._program, kern.spec, members=70000)
    assert z == 70000 * 2 > 65535
    with pytest.raises(YaskException, match="not a CUDA tensor"):
        fused_stencil.batched_step(kern, stacked, 0, 70000)
    assert fused_stencil.batched_step.launches == k0


def test_feasibility_and_member_isolation():
    ctx = port_ctx("torch")
    assert ensemble_feasible(ctx) == (True, "")
    ref = port_ctx("ref")
    ok, why = ensemble_feasible(ref)
    assert not ok and "oracle" in why
    with pytest.raises(YaskException, match="infeasible"):
        ref.new_ensemble(2)
    with pytest.raises(YaskException, match=">= 1"):
        EnsembleRun(ctx, 0)
    seed_member(ctx, 0)
    before = ctx.get_var("pressure").get_element([0, 4, 4, 4])
    ctx.apply_command_line_options("-ensemble 2")
    ens = ctx.new_ensemble()
    assert ens.n == 2
    with ens.member(1) as c:
        assert c.get_var("pressure").get_element([0, 4, 4, 4]) == 0.0
        c.get_var("pressure").set_element(3.25, [0, 4, 4, 4])
    assert ctx.get_var("pressure").get_element([0, 4, 4, 4]) == before
    with ens.member(1) as c:
        assert c.get_var("pressure").get_element([0, 4, 4, 4]) == 3.25


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_k7_members_match_solo_k1_on_card(cuda_device):
    fac = yask_tpu_torch.yk_factory()
    env = fac.new_env()

    def mk():
        c = fac.new_solution(env, stencil="iso3dfd", radius=8)
        c.apply_command_line_options("-g 48 -mode fused -wf_steps 2")
        c.prepare_solution()
        return c
    ctx = mk()
    seed_member(ctx, 0, g=48)
    ens = ctx.new_ensemble(N)
    for i in range(1, N):
        with ens.member(i) as c:
            seed_member(c, i, g=48)
    k0 = fused_stencil.batched_step.launches
    ens.run(0, STEPS - 1)
    assert fused_stencil.batched_step.launches - k0 == STEPS
    for i in range(N):
        solo = mk()
        seed_member(solo, i, g=48)
        solo.run_solution(0, STEPS - 1)
        with ens.member(i) as c:
            for name, ring in solo._state.items():
                for a, b in zip(ring, c._state[name]):
                    assert bool((a == b).all())
