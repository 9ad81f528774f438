"""K6's flat arm end to end on the CPU, and what it reports.

* gaussian, box and swe2d through ``-mode fused`` (the plain version on
  CPU tensors, the flat arm's kernel on the card) against ``yask_tpu``:
  jit, and for gaussian also pallas in interpret mode, from
  ``init_solution_vars``, 4 steps at K = 2, ``field_epsilon=1e-4`` (the
  repo's tolerance for a fused kernel against its unfused path).
* ``get_tiling()``'s ``flat`` record: the reason code, tile, threads,
  points per thread, staged cells per point, shared-memory bytes (both
  buffers) and resident blocks (per launch kind, after a launch on the
  card: none on the CPU), for a solo run and a member batch; none on a
  3-D solution; ``flat_fallback`` where no rung fits.
* Two mutations of the flat arm's device code that the emulation
  (tests/test_torch_flat_emulation.py) must catch: a walk without the
  wait for its copies, and a walk that copies the next tile into the
  buffer the current one reads.
* A 2-D solution with a partial-dim written var on the flat arm: the
  wrapper hands the kernel ``torch.empty`` outputs but a zeroed one for
  the partial-dim var (the kernel stores its slab, not its pads), and
  the g++ host path gives the plain version's bits over whole tensors.
"""

import pytest

import yask_tpu
import yask_tpu_torch
from yask_tpu.runtime.init_utils import init_solution_vars as tpu_init
from yask_tpu_torch.ops import cuda_emit, fused_stencil
from yask_tpu_torch.runtime.init_utils import init_solution_vars as port_init
from yask_tpu_torch.transfer import export_interiors, import_interiors

from test_torch_flat_emulation import SIZES
from test_torch_flat_host import flat_ctx, fresh_outputs
from test_torch_fused import host_kernel
from test_torch_kernel_emulation import emulated_kernel
from test_torch_lowering import mismatches, seeded_interiors
from test_torch_scratch import with_pads
from test_torch_stencils import tpu_interiors


def port_ctx(name, r, cli):
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(device="cpu"), stencil=name,
                           radius=r)
    ctx.apply_command_line_options(cli)
    ctx.prepare_solution()
    return ctx


@pytest.mark.parametrize("name,r,tpu_mode", [
    ("gaussian", 2, "jit"), ("gaussian", 2, "pallas"), ("box", 2, "jit"),
    ("swe2d", None, "jit")])
def test_flat_solutions_fused_match_yask_tpu(name, r, tpu_mode):
    g, K, steps = 40, 2, 4
    mine = port_ctx(name, r, f"-g {g} -mode fused -wf_steps {K}")
    port_init(mine)
    tfac = yask_tpu.yk_factory()
    theirs = tfac.new_solution(tfac.new_env(), stencil=name, radius=r)
    theirs.apply_command_line_options(f"-g {g}")
    theirs.get_settings().mode = tpu_mode
    theirs.get_settings().wf_steps = K
    theirs.prepare_solution()
    tpu_init(theirs)
    mine.run_solution(0, steps - 1)
    theirs.run_solution(0, steps - 1)
    assert mismatches(export_interiors(mine), tpu_interiors(theirs),
                      field_epsilon=1e-4) == 0
    til = mine.get_stats().get_tiling()
    assert til["kernel"] == "stages_step"
    assert til["flat"]["code"] == "flat_engaged"


def test_get_tiling_reports_the_flat_arm():
    ctx = port_ctx("gaussian", 2, "-g 64 -mode fused")
    ctx.run_solution(0, 0)
    flat = ctx.get_stats().get_tiling()["flat"]
    # 64x64 points by 512 threads; three channels, each staged with its
    # r=2 halo: 68 x 68 cells, twice
    assert flat["code"] == "flat_engaged" and "two staged" in flat["detail"]
    assert flat["tile"] == [1, 64, 64] and flat["threads"] == 512
    assert flat["points_per_thread"] == 8
    assert flat["staged_cells_per_point"] == pytest.approx(68 * 68 / 4096)
    assert flat["min_blocks"] == 2
    assert flat["buffer_bytes"] == 3 * 68 * 68 * 4
    assert flat["smem_bytes"] == 2 * flat["buffer_bytes"]
    assert flat["resident_blocks"] == {}       # no launch on the card
    ens = ctx.new_ensemble(2)
    ens.run(0, 0)
    assert ens.tiling["kernel"] == "batched_stages_step"
    assert ens.tiling["flat"]["tile"] == [1, 64, 64]
    # a 1-D solution: 4096 points along its dim
    one = port_ctx("test_step_cond_1d", None, "-g 64 -mode fused")
    one.run_solution(0, 0)
    assert one.get_stats().get_tiling()["flat"]["tile"] == [1, 1, 4096]
    # 3-D K6: no flat arm
    tti = port_ctx("tti", 2, "-g 16 -mode fused")
    tti.run_solution(0, 0)
    assert "flat" not in tti.get_stats().get_tiling()


def test_flat_arm_falls_back_where_no_rung_fits():
    ctx = port_ctx("swe2d", None, "-g 64 -mode fused")
    spec = cuda_emit.emit(ctx._program, flat_ladder=((128, 512, 512),))
    assert not spec.flat and spec.flat_cause[0] == "flat_fallback"
    assert spec.tile == (1, 8, 64) and "FLAT_NT" not in spec.source
    kern = fused_stencil.FusedKernel(ctx._program)
    kern.spec = spec
    assert kern.tiling(1)["flat"]["code"] == "flat_fallback"


def partial_2d():
    """A 2-D solution on K6 with a written var lacking x: ``A`` reads this
    step's ``P``, so two stages."""
    from yask_tpu_torch.compiler.solution import yc_factory
    soln = yc_factory().new_solution("partial_flat")
    t = soln.new_step_index("t")
    x = soln.new_domain_index("x")
    y = soln.new_domain_index("y")
    a = soln.new_var("A", [t, x, y])
    p = soln.new_var("P", [t, y])
    p(t + 1, y).EQUALS(p(t, y) * 0.7 + p(t, y + 1) * 0.2 + 0.05)
    a(t + 1, x, y).EQUALS(a(t, x, y) * 0.6 + a(t, x + 1, y - 1) * 0.2
                          + p(t + 1, y) * 0.1)
    return soln


def test_flat_arm_with_a_partial_dim_output(tmp_path):
    import torch
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(device="cpu"), partial_2d())
    ctx.apply_command_line_options("-g_x 150 -g_y 150 -mode fused")
    ctx.prepare_solution()
    import_interiors(ctx, seeded_interiors(ctx, 3))
    prog = ctx._program
    kern = fused_stencil.FusedKernel(prog)
    spec = kern.spec
    assert spec.flat["code"] == "flat_engaged" and spec.outputs == ["P", "A"]
    outs = fused_stencil.copy_base(kern, ctx._state, torch.device("cpu"),
                                   empty=True)
    assert not outs[0].any() and outs[1].shape == ctx._state["A"][0].shape
    fn = host_kernel(spec, tmp_path)
    state = ctx._state
    for t in range(2):
        outs = fresh_outputs(prog, spec, state)
        assert fused_stencil.call_entry(
            fn, prog, spec, [state[n][s] for n, s in spec.inputs], outs, t,
            None) == 0
        state = fused_stencil.plain_chunk(prog, state, t, 1)
        for n, a in zip(spec.outputs, outs):
            torch.testing.assert_close(a, state[n][-1], rtol=0, atol=0)


@pytest.mark.parametrize("mutation", ["no wait", "one buffer"])
def test_flat_arm_emulation_fails_when_a_copy_races(mutation, tmp_path):
    """Mutation checks: without the wait, a tile reads its copies before
    they land; with one buffer for both tiles, the next tile's copies
    overwrite the cells the current one still reads (the shim leaves
    both NaN).  One block walks gaussian's four tiles."""
    import torch
    ctx = flat_ctx("gaussian", sizes=SIZES)
    with_pads(ctx, 29)
    prog = ctx._program
    spec = cuda_emit.emit(prog)
    old = {"no wait": ("    cp_async_wait<0>();\n    __syncthreads();\n"
                       "    if (i + gridDim.x < tiles)",
                       "    __syncthreads();\n"
                       "    if (i + gridDim.x < tiles)"),
           "one buffer": ("smem + (ib ^ S::BUF_ELEMS),", "smem + ib,")}
    before, after = old[mutation]

    def edit(fn, text):
        if fn == "fused_step.cuh":
            assert text.count(before) == 1
            text = text.replace(before, after)
        return text
    fn = emulated_kernel(spec, tmp_path, edit=edit)
    state = ctx._state
    outs = fresh_outputs(prog, spec, state)
    assert fused_stencil.call_entry(
        fn, prog, spec, [state[n][s] for n, s in spec.inputs], outs, 0,
        None, nres=1) == 0
    want = fused_stencil.plain_chunk(prog, state, 0, 1)
    assert not all(torch.equal(a, want[n][-1])
                   for n, a in zip(spec.outputs, outs))
