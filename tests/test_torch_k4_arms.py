"""K4's multi-stage, scratch, rewrite, misc and element-size-2 arms
(``-mode fused -wf_steps K -trapezoid``) against ``yask_tpu``'s trapezoid.

* End to end on the CPU, the port's forced trapezoid (its plain versions
  on CPU tensors, routed through K4's groups) against ``yask_tpu``'s
  ``-mode pallas`` trapezoid forced in interpret mode, as
  tests/test_trapezoid.py runs it (``build_pallas_chunk(trapezoid=True)``
  through the monkeypatch of test_torch_trapezoid): ssg r=4 and tti r=2
  (the reference's own multi-stage and scratch cases, its line 92) and
  gaussian r=2 (misc), each with a remainder step,
  tolerance ``field_epsilon=1e-4`` (awp and the RTM chain:
  tests/test_torch_k4_chains.py); iso3dfd r=2 in bfloat16 against the
  reference at element size
  2 with the tolerance of tests/test_torch_bf16.py (3e-2, the two packages
  round bfloat16 at other places, ROADMAP.md C13).
* The plan of each arm: K6's sub-stages inside each level, a buffer per
  scratch var and per rewriting sub-stage, rings of S or S+1 buffers, the
  misc slices, the workspace past shared memory; the 4-D fallback naming
  "A12 (4-D K4)"; the reference's own refusals (partial-dim writes).
* A member batch under ``-trapezoid`` (``EnsembleRun``): each member
  bit-equal to its solo run, the tiling K4's member batch.
"""

import numpy as np
import pytest

import yask_tpu
import yask_tpu_torch
from yask_tpu_torch.compiler.solution_base import create_solution
from yask_tpu_torch.ops import cuda_emit
from yask_tpu_torch.transfer import export_interiors, import_interiors
from yask_tpu_torch.utils.exceptions import YaskException

from yask_tpu.runtime.init_utils import init_solution_vars as tpu_init
from yask_tpu_torch.runtime.init_utils import init_solution_vars as port_init

from test_torch_ensemble import members_match_solo
from test_torch_lowering import (mismatches, seeded_interiors, tpu_export,
                                 tpu_import)
from test_torch_stencils import tpu_interiors
from test_torch_trapezoid import (codes, port_ctx, tpu_ctx,  # noqa: F401
                                  tpu_forced_trapezoid)

FEPS = 1e-4
#: tests/test_config_matrix.py:66, as tests/test_torch_bf16.py uses it
BF16_EPS = 3e-2


def seeded_physical(ctx, seed):
    """Numpy-seeded interiors small enough that the elastic families
    stay finite over a few steps: written vars in [0, 0.1), read-only
    coefficients in [0.5, 0.6) (awp's ``qp`` in [0.1, 0.2))."""
    out = seeded_interiors(ctx, seed)
    written = {eq.lhs.var_name() for eq in ctx._soln.get_equations()}
    for name, slots in out.items():
        for i, a in enumerate(slots):
            a = np.asarray(a)
            if name in written:
                slots[i] = a * 0.1
            else:
                slots[i] = (0.1 if name == "qp" else 0.5) + 0.1 * a
    return out


@pytest.mark.parametrize("stencil,r,g,K,steps", [
    ("ssg", 4, 24, 2, 5), ("tti", 2, 32, 2, 3), ("gaussian", 2, 48, 2, 5)])
def test_k4_arms_match_yask_tpu_interpret(tpu_forced_trapezoid, stencil, r,
                                          g, K, steps):
    """Each with a remainder step on K6 or K1 (ssg r=4's K6 on the tile
    ladder's 1×1×16 rung, ROADMAP.md C17)."""
    mine = port_ctx(stencil, r, g, "fused", K, "-trapezoid -no-skew",
                    forced=True)
    theirs = tpu_ctx(stencil, r, g, "pallas", K)
    if mine._program.geoms and any(
            kind == "misc" for gm in mine._program.geoms.values()
            for _d, kind in gm.axes):
        # misc axes: both packages' own initialisation (the reference's
        # yk_var API does not take misc slices through tpu_import)
        port_init(mine)
        tpu_init(theirs)
    else:
        state = seeded_physical(mine, 3)
        import_interiors(mine, state)
        tpu_import(theirs, state)
    mine.run_solution(0, steps - 1)
    theirs.run_solution(0, steps - 1)
    a, b = export_interiors(mine), tpu_interiors(theirs)
    assert all(np.isfinite(x).all() for s in a.values() for x in s)
    assert mismatches(a, b, field_epsilon=FEPS) == 0
    til, ttil = mine.get_stats().get_tiling(), theirs.get_stats().get_tiling()
    assert til["trapezoid"] is ttil["trapezoid"] is True
    assert til["trap_dims"] == ttil["trap_dims"]
    assert til["trapezoid_request"] == "forced"
    assert til["sub_stages"] == mine._trapezoid_kernel().spec.stages
    assert til["stage_widths"] == [
        {d: w for d, w in sw.items()} for sw in
        mine._trapezoid_kernel().spec.trap["stage_widths"]]


def test_bf16_k4_matches_yask_tpu_interpret(tpu_forced_trapezoid):
    def src(pkg):
        import importlib
        sb = importlib.import_module(
            pkg + ".compiler.solution_base").create_solution("iso3dfd",
                                                             radius=2)
        sb.get_soln().set_element_bytes(2)
        return sb
    fac = yask_tpu_torch.yk_factory()
    mine = fac.new_solution(fac.new_env(device="cpu"),
                            src("yask_tpu_torch"))
    mine._trapezoid_arg = lambda: True
    mine.apply_command_line_options("-g 48 -mode fused -wf_steps 2 "
                                    "-trapezoid")
    mine.prepare_solution()
    tfac = yask_tpu.yk_factory()
    theirs = tfac.new_solution(tfac.new_env(), src("yask_tpu"))
    theirs.apply_command_line_options("-g 48 -wf_steps 2")
    theirs.get_settings().mode = "pallas"
    theirs.get_settings().trapezoid_tiling = True
    theirs.prepare_solution()
    state = seeded_interiors(mine, 5)
    import_interiors(mine, state)
    tpu_import(theirs, state)
    mine.run_solution(0, 4)
    theirs.run_solution(0, 4)
    assert mine._trapezoid_kernel() is not None
    assert "typedef yt::bf16_t real_t;" in mine._trapezoid_kernel().spec.source
    assert mismatches(export_interiors(mine), tpu_export(theirs),
                      BF16_EPS, BF16_EPS) == 0
    assert theirs.get_stats().get_tiling()["trapezoid"] is True


# ---------------------------------------------------------------------------
# the plan of each arm
# ---------------------------------------------------------------------------


def test_tti_plan_holds_scratch_buffers_and_a_workspace():
    ctx = port_ctx("tti", 2, 48, "fused", 2, "-trapezoid -no-skew",
                   forced=True)
    spec = ctx._trapezoid_kernel().spec
    assert spec.scratch_stages == 2 and spec.stages == 3
    tr = spec.trap
    # 2 written vars, ring 2 read at offsets (S + 1 = 3 each), 6 scratch
    # tiles, 0 staged read-only vars past the rings
    assert tr["buffers"] >= 6 + 4
    for p in tr["passes"]:
        assert p["smem_bytes"] <= cuda_emit.SMEM_LIMIT
        assert p["smem_buffers"] + p["ws_buffers"] == tr["buffers"]
    assert tr["ws_block_bytes"] > 0
    # forced into the workspace entirely: no buffer in shared memory
    all_ws = cuda_emit.resolve_trapezoid(ctx._program, 2, True, smem_limit=0)
    assert all(p["smem_buffers"] == 0 and p["smem_bytes"] == 0
               for p in all_ws.trap["passes"])


def test_awp_rewrites_get_a_buffer_per_writing_sub_stage():
    ctx = port_ctx("awp", None, 48, "fused", 2, "-trapezoid", forced=True)
    spec = ctx._trapezoid_kernel().spec
    assert spec.stages == len(ctx._ana.stages) == 4
    # a var a later stage rewrites reads the earlier writer's buffer
    assert "rd.template cmp<" in spec.source


def test_misc_slices_are_entries_of_their_own():
    ctx = port_ctx("gaussian", 2, 48, "fused", 2, "-trapezoid", forced=True)
    spec = ctx._trapezoid_kernel().spec
    assert any(m for m in spec.in_misc)
    # gaussian writes 3 channels of img: 3 entries per output tensor, one
    # tensor per level of the group's newest min(K, S)
    assert len(spec.out_slices) == 3 * len(spec.outputs)
    S = ctx._program.geoms["img"].num_slots
    assert spec.trap["out_levels"] == list(range(2 - min(2, S) + 1, 3))


def test_unwritten_misc_slices_start_from_the_evicted_slots():
    """test_misc_2d writes some of its var's misc slices: the group's
    outputs of that var start from a copy of ring slot (L-1) mod S."""
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(device="cpu"),
                           create_solution("test_misc_2d"))
    ctx._trapezoid_arg = lambda: True
    ctx.apply_command_line_options("-g_x 28 -g_y 12 -mode fused "
                                   "-wf_steps 2 -trapezoid")
    ctx.prepare_solution()
    spec = ctx._trapezoid_kernel().spec
    assert spec.base_outputs
    import_interiors(ctx, seeded_interiors(ctx, 4))
    twin = fac.new_solution(fac.new_env(device="cpu"),
                            create_solution("test_misc_2d"))
    twin.apply_command_line_options("-g_x 28 -g_y 12 -mode torch")
    twin.prepare_solution()
    import_interiors(twin, seeded_interiors(ctx, 4))
    ctx.run_solution(0, 4)
    twin.run_solution(0, 4)
    assert ctx.compare_data(twin, epsilon=0.0, abs_epsilon=0.0) == 0


def test_4d_falls_back_and_raises_forced_naming_a12_4d_k4():
    """4-D K4 is ported: no fallback and no refusal names it.  Auto
    records the gate's codes (its decision, not a fallback); forced
    resolves K4 with w a uniform window dim (tests/test_torch_k4_4d.py
    holds its code)."""
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(device="cpu"), stencil="test_4d")
    ctx.apply_command_line_options("-g 24 -mode fused -wf_steps 2 "
                                   "-trapezoid")
    ctx.prepare_solution()
    ctx._trapezoid_kernel()
    assert set(codes(ctx._trap[1])) <= {"trapezoid_engaged",
                                        "trapezoid_gate_rejected",
                                        "trapezoid_diamond"}
    spec = cuda_emit.resolve_trapezoid(ctx._program, 2, True)
    assert spec.trap["trap_dims"] == ["x", "y"] and spec.outer == 1
    assert "NOUTER = 1" in spec.source


@pytest.mark.parametrize("name", ["partial_written_cond"])
def test_partial_dim_writes_stay_the_references_refusal(name):
    from test_torch_partial import port_ctx as partial_ctx
    ctx = partial_ctx(name, "-g 24 -mode fused -wf_steps 2 -trapezoid")
    assert ctx._trapezoid_kernel() is None
    assert set(codes(ctx._trap[1])) == {"trapezoid_ineligible"}
    with pytest.raises(YaskException, match="all written vars spanning"):
        cuda_emit.resolve_trapezoid(ctx._program, 2, True)


def test_removed_refusals_are_gone():
    import pathlib
    root = pathlib.Path(cuda_emit.__file__).parents[1]
    text = "".join(p.read_text() for p in root.rglob("*.py"))
    text += "".join(p.read_text() for p in root.rglob("*.cuh"))
    for item in ("A12 (multi-stage K4)", "A12 (scratch K4)",
                 "A12 (batched K4)", "A12 (A3 arms on K4)", "A12 (4-D K4)"):
        assert item not in text


# ---------------------------------------------------------------------------
# member batches under -trapezoid
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("stencil,r,g", [("iso3dfd", 2, 32), ("tti", 2, 20)])
def test_member_batch_under_trapezoid_matches_solo(stencil, r, g):
    def make():
        ctx = port_ctx(stencil, r, g, "fused", 2, "-trapezoid -no-skew",
                       forced=True)
        assert ctx._trapezoid_kernel() is not None
        return ctx
    ens = members_match_solo(make, n=2, steps=5)
    til = ens.tiling
    assert til["kernel"] == "batched_trapezoid_chunk" and til["members"] == 2
    assert til["name"].endswith("_trap_batched")
