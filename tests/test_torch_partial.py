"""The partial-dim arm of the fused kernels: written vars that lack a
domain dim (``partial_written``, ``partial_written_cond``,
``scratch_partial`` of tests/test_pallas.py:382-470, built here with
each package's DSL).

* The plain version (what ``-mode fused`` runs on CPU tensors) against
  ``yask_tpu``'s ``-mode pallas`` in interpret mode, as tests/test_pallas.py
  runs them: g = 16, ``init_solution_vars``, 4 steps.  Tolerance:
  ``compare_data``'s defaults.
* The emitted source built by g++ against the plain version, one step at
  a time from a random state into NaN-filled outputs: bit-equal.  Along a
  missing dim the var's stride is 0 and every block computes the same
  slab (the analysis keeps its RHS constant there); only the points at
  index 0 of each missing slot store it (the ``out_slab`` table).
* The admission rule of ``yask_tpu``'s ``pallas_applicable`` for written
  vars: the minor dim kept, the dims in solution order, at least one
  domain dim.
"""

import importlib

import pytest

import yask_tpu
import yask_tpu_torch
from yask_tpu.runtime.init_utils import init_solution_vars as tpu_init
from yask_tpu_torch.ops import cuda_emit
from yask_tpu_torch.runtime.init_utils import init_solution_vars as port_init
from yask_tpu_torch.transfer import export_interiors, import_interiors
from yask_tpu_torch.utils.exceptions import YaskException

from test_torch_ensemble import members_match_solo
from test_torch_fused import host_kernel
from test_torch_lowering import mismatches, seeded_interiors
from test_torch_misc import host_steps
from test_torch_stencils import tpu_interiors


def _new(pkg, name):
    soln = importlib.import_module(
        pkg + ".compiler.solution").yc_factory().new_solution(name)
    return (soln, soln.new_step_index("t"), soln.new_domain_index("x"),
            soln.new_domain_index("y"))


def partial_written(pkg="yask_tpu_torch"):
    """P lacks x; A reads this step's P (K6: P's computed tile, broadcast
    along x)."""
    soln, t, x, y = _new(pkg, "partial_written")
    z = soln.new_domain_index("z")
    a = soln.new_var("A", [t, x, y, z])
    p = soln.new_var("P", [t, y, z])
    p(t + 1, y, z).EQUALS(p(t, y, z) * 0.7 + p(t, y + 1, z - 1) * 0.2
                          + 0.05)
    a(t + 1, x, y, z).EQUALS(a(t, x, y, z) * 0.6
                             + a(t, x + 1, y - 1, z) * 0.2
                             + p(t + 1, y, z) * 0.1)
    return soln


def partial_written_cond(pkg="yask_tpu_torch"):
    """A conditional write of a partial var: the unselected cells keep the
    evicted slot (K1, one stage)."""
    soln, t, x, y = _new(pkg, "partial_written_cond")
    a = soln.new_var("A", [t, x, y])
    p = soln.new_var("P", [t, y])
    p(t + 1, y).EQUALS(p(t, y) * 0.8 + 0.1).IF_DOMAIN(y >= 4)
    a(t + 1, x, y).EQUALS(a(t, x, y) * 0.5 + p(t, y) * 0.3)
    return soln


def scratch_partial(pkg="yask_tpu_torch"):
    """A partial scratch var, in K6's scratch sub-stage."""
    soln, t, x, y = _new(pkg, "scratch_partial")
    a = soln.new_var("A", [t, x, y])
    s = soln.new_scratch_var("s", [y])
    s(y).EQUALS(3.0)
    a(t + 1, x, y).EQUALS(a(t, x, y) * 0.5 + s(y + 1) * 0.1)
    return soln


SOLUTIONS = {"partial_written": partial_written,
            "partial_written_cond": partial_written_cond,
            "scratch_partial": scratch_partial}
#: (solution, K, the kernel that runs it)
CASES = [("partial_written", 1, "stages_step"),
         ("partial_written", 2, "stages_step"),
         ("partial_written", 3, "stages_step"),
         ("partial_written_cond", 2, "fused_step"),
         ("scratch_partial", 2, "stages_step")]


def port_ctx(name, cli):
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(device="cpu"), SOLUTIONS[name]())
    ctx.apply_command_line_options(cli)
    ctx.prepare_solution()
    return ctx


@pytest.mark.parametrize("name,K,kernel", CASES)
def test_partial_written_fused_matches_yask_tpu_pallas(name, K, kernel):
    g, steps = 16, 4
    mine = port_ctx(name, f"-g {g} -mode fused -wf_steps {K}")
    port_init(mine, seed=0.03)
    tfac = yask_tpu.yk_factory()
    theirs = tfac.new_solution(tfac.new_env(), SOLUTIONS[name]("yask_tpu"))
    theirs.apply_command_line_options(f"-g {g}")
    theirs.get_settings().mode = "pallas"
    theirs.get_settings().wf_steps = K
    theirs.prepare_solution()
    tpu_init(theirs, seed=0.03)
    mine.run_solution(0, steps - 1)
    theirs.run_solution(0, steps - 1)
    assert mismatches(export_interiors(mine), tpu_interiors(theirs)) == 0
    assert mine.get_stats().get_tiling()["kernel"] == kernel


@pytest.mark.parametrize("name", sorted(SOLUTIONS))
def test_emitted_partial_kernels_match_plain_gxx(name, tmp_path):
    ctx = port_ctx(name, "-g_x 19 -g_y 21 -g_z 70 -mode fused"
                   if name == "partial_written" else "-g 19 -mode fused")
    import_interiors(ctx, seeded_interiors(ctx, 13))
    spec = cuda_emit.emit(ctx._program)
    host_steps(ctx, spec, host_kernel(spec, tmp_path))


def test_the_slab_is_stored_at_index_0_of_the_missing_slot():
    """P[y, z] of a 3-D solution lacks slot 0 (bit 1), P[y] of a 2-D one
    lacks slot 1 (bit 2); a full var has no entry, and a solution without
    partial outputs prints no table (its source does not change)."""
    spec = cuda_emit.emit(port_ctx("partial_written",
                                   "-g 16 -mode fused")._program)
    assert spec.outputs == ["P", "A"]
    assert "out_slab(int k) { return k == 0 ? 1 : k == 1 ? 0 : 0; }" \
        in spec.source
    spec = cuda_emit.emit(port_ctx("partial_written_cond",
                                   "-g 16 -mode fused")._program)
    assert spec.stages == 1 and spec.outputs == ["P", "A"]
    assert "out_slab(int k) { return k == 0 ? 2 : k == 1 ? 0 : 0; }" \
        in spec.source
    spec = cuda_emit.emit(port_ctx("scratch_partial",
                                   "-g 16 -mode fused")._program)
    assert "out_slab" not in spec.source and spec.scratch_stages == 1


def test_same_step_reads_of_a_partial_var_ride_its_tile():
    """partial_written's A reads P(t+1): K6 computes P in its first
    sub-stage over the block (every x) and A reads that tile."""
    spec = cuda_emit.emit(port_ctx("partial_written",
                                   "-g 16 -mode fused")._program)
    assert spec.stages == 2 and spec.computed == ["P"]
    assert "rd.template cmp<0>(0, 0, 0)" in spec.source


def test_partial_written_takes_no_stream_arm_and_no_k4():
    """partial_written_cond writes a var lacking a domain dim, which the
    reference's trapezoid does not take (``skew_eligible_dims``): K4
    records every dim ineligible and runs K1, a forced request raises the
    reference's message; the stream arm is 3-D only."""
    ctx = port_ctx("partial_written_cond",
                   "-g 24 -mode fused -wf_steps 2 -trapezoid")
    import_interiors(ctx, seeded_interiors(ctx, 3))
    ctx.run_solution(0, 1)
    assert ctx._trapezoid_kernel() is None
    assert {r["code"] for r in ctx._trap[1]} == {"trapezoid_ineligible"}
    assert "partial-dim written vars" in ctx._trap[1][0]["detail"]
    with pytest.raises(YaskException, match="all written vars spanning"):
        cuda_emit.resolve_trapezoid(ctx._program, 2, True)
    why = {r["code"] for r in ctx._fused_spec_kernel().skew_reasons}
    assert why == {"skew_ineligible"}


def test_partial_written_refuses_k5_and_k7():
    """What this test pinned before K5 took the A3 arms (the refusal
    "partial-dim written vars ... ROADMAP.md A11 (A3 arms on K5)") is
    gone: shard_pallas runs the partial-dim solutions with x, the dim the
    partial var lacks, sharded (every shard of the row computes the same
    slab), bit-equal to shard_map."""
    from test_torch_k5_arms import shard_pallas_matches_shard_map
    for name in ("partial_written_cond", "partial_written"):
        shard_pallas_matches_shard_map(SOLUTIONS[name], "-g 16 -nr_x 2")
    # K7 takes the partial-dim arm (ROADMAP.md A9 is done)
    for name in ("partial_written_cond", "partial_written"):
        members_match_solo(lambda: port_ctx(name, "-g 16 -mode fused "
                                            "-wf_steps 2 -ensemble 2"))


def _written(name, dims):
    """A solution writing ``W`` over ``dims`` (of x, y, z) from a full
    var."""
    from yask_tpu_torch.compiler.solution import yc_factory
    soln = yc_factory().new_solution(name)
    t = soln.new_step_index("t")
    idx = {d: soln.new_domain_index(d) for d in "xyz"}
    a = soln.new_var("A", [t, idx["x"], idx["y"], idx["z"]])
    w = soln.new_var("W", [t] + [idx[d] for d in dims])
    w(t + 1, *[idx[d] for d in dims]).EQUALS(
        w(t, *[idx[d] for d in dims]) * 0.5)
    a(t + 1, idx["x"], idx["y"], idx["z"]).EQUALS(
        a(t, idx["x"], idx["y"], idx["z"]) * 0.5)
    return soln


@pytest.mark.parametrize("dims,why", [
    ("yz", None), ("xz", None), ("z", None),
    ("xy", "lacks the minor dim 'z'"),
    ("zy", "lacks the minor dim"),
    ("", "has no domain dims")])
def test_admission_follows_pallas_applicable(dims, why):
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(device="cpu"),
                           _written(f"w_{dims or 'none'}", dims))
    ctx.apply_command_line_options("-g 8 -mode torch")
    ctx.prepare_solution()
    ok, msg = cuda_emit.fused_applicable(ctx._program)
    assert ok == (why is None) and (why is None or why in msg)
