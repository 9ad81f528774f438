"""The port's whole main path on the CPU (``device="cpu"``) against
yask_tpu's: ``yk_factory → new_solution → apply_command_line_options →
prepare_solution → init vars → run_solution → get_var / compare_data /
get_stats``, mode for mode (torch ↔ jit, fused ↔ pallas interpret,
ref ↔ ref).  Both start from the shared ``init_solution_vars`` law
(values by interior coordinate).

Tolerance: compare_data's defaults for ref ↔ ref; the compiled pairs add
``field_epsilon=1e-4`` (the repo's policy for paths with different FP
association: XLA's CPU backend and the Pallas tile contract multiply-adds
into FMAs, eager PyTorch does not, and the seq-init state grows large
enough over 5 steps that a point near cancellation carries ulps of the
field scale)."""

import io

import numpy as np
import pytest

import yask_tpu
import yask_tpu_torch
from yask_tpu.runtime.init_utils import init_solution_vars as tpu_init
from yask_tpu_torch.runtime.init_utils import init_solution_vars as port_init
from yask_tpu_torch.utils.exceptions import YaskException

from test_torch_lowering import mismatches, tpu_export
from yask_tpu_torch.transfer import export_interiors

G, STEPS = 12, 5


def port_main_path(name, r, mode, wf=2):
    fac = yask_tpu_torch.yk_factory()
    env = fac.new_env(device="cpu")
    ctx = fac.new_solution(env, stencil=name, radius=r)
    rest = ctx.apply_command_line_options(f"-g {G} -mode {mode} "
                                          f"-wf_steps {wf}")
    assert rest == []
    ctx.prepare_solution()
    port_init(ctx)
    ctx.run_solution(0, STEPS - 1)
    return ctx


def tpu_main_path(name, r, mode, wf=2):
    fac = yask_tpu.yk_factory()
    ctx = fac.new_solution(fac.new_env(), stencil=name, radius=r)
    ctx.apply_command_line_options(f"-g {G} -wf_steps {wf}")
    ctx.get_settings().mode = mode
    ctx.prepare_solution()
    tpu_init(ctx)
    ctx.run_solution(0, STEPS - 1)
    return ctx


PAIRS = [("torch", "jit", 1e-4), ("fused", "pallas", 1e-4),
         ("ref", "ref", 0.0)]


@pytest.mark.parametrize("mode,tpu_mode,feps", PAIRS)
@pytest.mark.parametrize("name,r", [("iso3dfd", 2), ("3axis", 1)])
def test_main_path_matches_yask_tpu(name, r, mode, tpu_mode, feps):
    mine = port_main_path(name, r, mode)
    theirs = tpu_main_path(name, r, tpu_mode)
    assert mismatches(export_interiors(mine), tpu_export(theirs),
                      field_epsilon=feps) == 0
    # element reads through the yk_var API agree too
    v, w = mine.get_var(mine.get_var_names()[0]), \
        theirs.get_var(theirs.get_var_names()[0])
    idx = [STEPS] + [G // 2] * 3
    assert v.get_element(idx) == pytest.approx(w.get_element(idx),
                                                rel=1e-4, abs=1e-6)
    # stats count the points, steps, reads and FLOPs alike
    a, b = mine.get_stats(), theirs.get_stats()
    assert a.get_num_elements() == G ** 3 == b.get_num_elements()
    assert a.get_num_steps_done() == STEPS == b.get_num_steps_done()
    assert a.get_est_fp_ops_done() == b.get_est_fp_ops_done()
    assert a.get_num_reads_done() == b.get_num_reads_done()
    assert a.get_elapsed_secs() > 0 and a.get_pts_per_sec() > 0


def test_validation_flow_and_run_ref():
    ctx = port_main_path("iso3dfd", 2, "fused")
    fac = yask_tpu_torch.yk_factory()
    twin = fac.new_solution(fac.new_env(device="cpu"), stencil="iso3dfd",
                            radius=2)
    twin.apply_command_line_options(f"-g {G}")
    twin.prepare_solution()
    port_init(twin)
    twin.run_ref(0, STEPS - 1)
    assert ctx.compare_data(twin) == 0
    # a context that ran the oracle goes back to tensors for its next run
    twin.run_solution(STEPS, STEPS)
    assert twin.get_stats().get_num_steps_done() == STEPS + 1


def test_harness_cli_validates_and_times_on_cpu():
    from yask_tpu_torch.main import run_harness
    out = io.StringIO()
    assert run_harness(["-stencil", "3axis", "-g", "12", "-validate",
                        "-device", "cpu", "-mode", "fused"], out=out) == 0
    assert "validation passed" in out.getvalue()
    out = io.StringIO()
    assert run_harness(["-stencil", "iso3dfd", "-radius", "2", "-g", "12",
                        "-device", "cpu", "-mode", "fused", "-wf_steps", "2",
                        "-num_trials", "2", "-trial_steps", "2"],
                       out=out) == 0
    text = out.getvalue()
    assert "mid-throughput (num-points/sec)" in text
    assert "fused-tiling" in text


def test_var_api_round_trip_and_pads():
    ctx = port_main_path("iso3dfd", 2, "torch")
    v = ctx.get_var("pressure")
    t = ctx._cur_step
    v.set_element(3.5, [t, 1, 2, 3])
    assert v.get_element([t, 1, 2, 3]) == 3.5
    v.set_element(7.0, [t, -1, 0, 0])          # a pad: stays zero
    assert v.get_element([t, -1, 0, 0]) == 0.0
    box = v.get_elements_in_slice([t, 0, 0, 0], [t, 1, 1, 1])
    v.set_elements_in_slice(box * 2, [t, 0, 0, 0], [t, 1, 1, 1])
    np.testing.assert_array_equal(
        v.get_elements_in_slice([t, 0, 0, 0], [t, 1, 1, 1]), box * 2)
    with pytest.raises(YaskException):
        v.get_element([t - 5, 0, 0, 0])
    assert v.get_num_storage_elements() == 2 * (G + 4) ** 3


@pytest.mark.parametrize("opts,item", [
    # the shard modes are carried (K5); what stays of A11 for them is the
    # halo calibration of -measure_halo
    pytest.param("-mode sharded -measure_halo", "A11",
                 id="-mode sharded-A11"),
    pytest.param("-mode shard_map -measure_halo", "A11",
                 id="-mode shard_map-A11"),
    pytest.param("-mode shard_pallas -measure_halo", "A11",
                 id="-mode shard_pallas-A11"),
    ("-auto_tune", "A6"),
    ("-ckpt_every 2", "A10"), ("-watchdog_every 2", "A10"),
    ("-run_deadline 5", "A10")])
def test_settings_not_carried_raise_with_their_roadmap_item(opts, item):
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(device="cpu"), stencil="3axis",
                           radius=1)
    ctx.apply_command_line_options(f"-g 8 {opts}")
    with pytest.raises(YaskException, match=f"ROADMAP.md {item}"):
        ctx.prepare_solution()


def test_trapezoid_in_a_member_batch_is_carried():
    """-trapezoid with -ensemble (K4's member batch) prepares and runs, as
    push in a member batch does (the batch runs unpushed, as the
    reference's does; tests/test_torch_k7_arms.py)."""
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(device="cpu"), stencil="3axis",
                           radius=1)
    ctx.apply_command_line_options("-g 8 -trapezoid -mode fused -ensemble 2")
    ctx.prepare_solution()
    ens = ctx.new_ensemble(2)
    ens.run(0, 1)


def test_trace_dir_and_tuner_raise_with_their_roadmap_item():
    ctx = port_main_path("3axis", 1, "torch")
    with pytest.raises(YaskException, match="ROADMAP.md A14"):
        ctx.set_trace_dir("/nonexistent")
    with pytest.raises(YaskException, match="ROADMAP.md A6"):
        ctx.run_auto_tuner_now()
    with pytest.raises(YaskException, match="printers"):
        ctx._soln.output_solution(io.StringIO())


def test_auto_mode_resolves_to_torch_and_quick_run():
    ctx = yask_tpu_torch.quick_run("3axis", g=8, steps=2, radius=1,
                                   device="cpu")
    assert ctx._mode == "torch"
    assert ctx.get_stats().get_num_steps_done() == 2


@pytest.mark.parametrize("name,r", [("wave2d", 2), ("swe2d", None)])
def test_physics2d_runs_in_torch_mode_and_matches_yask_tpu_jit(name, r):
    """Every solution of physics2d (registered by the port) in torch mode
    against yask_tpu's jit from the same seeded interiors.  Tolerance:
    field_epsilon=1e-4, as the other compiled pairs (XLA contracts
    multiply-adds)."""
    from test_torch_lowering import seeded_interiors, tpu_import
    from yask_tpu_torch.compiler.solution_base import \
        get_registered_solutions
    from yask_tpu_torch.transfer import import_interiors
    assert name in get_registered_solutions()
    fac = yask_tpu_torch.yk_factory()
    mine = fac.new_solution(fac.new_env(device="cpu"), stencil=name,
                            radius=r)
    mine.apply_command_line_options("-g 16 -mode torch -wf_steps 2")
    mine.prepare_solution()
    tfac = yask_tpu.yk_factory()
    theirs = tfac.new_solution(tfac.new_env(), stencil=name, radius=r)
    theirs.apply_command_line_options("-g 16 -wf_steps 2")
    theirs.get_settings().mode = "jit"
    theirs.prepare_solution()
    state = seeded_interiors(mine, 17)
    if name == "swe2d":   # depth near 1, small momenta, lam and grav
        state = {n: [0.5 + a if n == "h" else 0.01 * a for a in v]
                 for n, v in state.items()}
        state["lam"], state["grav"] = [np.full((), 0.1)], [np.full((), 9.8)]
    import_interiors(mine, state)
    tpu_import(theirs, state)
    mine.run_solution(0, 3)
    theirs.run_solution(0, 3)
    assert mismatches(export_interiors(mine), tpu_export(theirs),
                      field_epsilon=1e-4) == 0
