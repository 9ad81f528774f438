"""The misc arm of the fused kernels (``-mode fused`` on solutions with
misc dims: box, gaussian, test_misc_2d, test_misc_value_2d,
test_step_cond_1d).

* The plain version (what ``-mode fused`` runs on CPU tensors) against
  ``yask_tpu``'s ``-mode pallas`` in interpret mode, as
  tests/test_pallas.py:141-163 runs it: g = 20, ``init_solution_vars``,
  4 steps, K = 1 and 2.  Tolerance: ``compare_data``'s defaults (none of
  these reassociates a long sum, so no ``field_epsilon``).
* The emitted source built by g++ (K1's ``host_step``, K6's
  ``host_stages``) against the plain version, one step at a time from a
  random state into NaN-filled outputs: bit-equal, every interior cell
  written and no pad cell.  A var whose misc slices are not all written
  starts from a copy of its evicted slot, as the wrapper's ``copy_base``
  makes it.
* What the arm changes in the emitted source and the wrapper's tables:
  each misc slice an input or output of its own, misc indices as
  per-equation constants, a tile per (var, misc slice) and writer.
* The paths that do not take the arm yet: the stream arm
  (``skew_ineligible``), K4 (``trapezoid_fallback``, A12) and K5 (A11);
  a member batch (K7) takes it.
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

#: the solutions the misc arm opens, and the kernel that runs each
MISC = [("box", 1, "stages_step"), ("gaussian", 2, "stages_step"),
        ("test_misc_2d", None, "fused_step"),
        ("test_misc_value_2d", None, "stages_step"),
        ("test_step_cond_1d", None, "stages_step")]


def port_ctx(name, r, cli):
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(device="cpu"), stencil=name,
                           radius=r)
    ctx.apply_command_line_options(cli)
    ctx.prepare_solution()
    return ctx


@pytest.mark.parametrize("K", [1, 2])
@pytest.mark.parametrize("name,r,kernel", MISC)
def test_misc_solutions_fused_match_yask_tpu_pallas(name, r, kernel, K):
    g, steps = 20, 4
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
    assert mismatches(export_interiors(mine), tpu_interiors(theirs)) == 0
    assert mine.get_stats().get_tiling()["kernel"] == kernel


def host_outputs(ctx, spec, state, fill=float("nan")):
    """One sub-step's outputs as the wrapper allocates them, filled with
    ``fill``: a var in ``spec.base_outputs`` starts from its evicted
    slot."""
    import torch
    prog = ctx._program
    return [state[n][0].clone() if n in spec.base_outputs else
            torch.full(tuple(prog.geoms[n].shape), fill,
                       dtype=state[n][0].dtype) for n in spec.outputs]


def host_steps(ctx, spec, fn, steps=3):
    """``steps`` sub-steps through the g++ build of the emitted entry
    (``call_entry``, as ``fused_step``/``stages_step`` call it), each held
    against the plain version's step to the bit: interiors equal, pads
    untouched (NaN, or the evicted slot's zeros; K6's flat arm writes
    them: zeros)."""
    import torch
    prog = ctx._program
    state = ctx._state
    for t in range(steps):
        ins = [state[n][s] for n, s in spec.inputs]
        outs = host_outputs(ctx, spec, state)
        assert fused_stencil.call_entry(fn, prog, spec, ins, outs, t,
                                        None) == 0
        want = fused_stencil.plain_chunk(prog, state, t, 1)
        for n, a in zip(spec.outputs, outs):
            idx = ctx._interior_idx(n)
            torch.testing.assert_close(a[idx], want[n][-1][idx], rtol=0,
                                       atol=0)
            if n in spec.base_outputs:
                torch.testing.assert_close(a, want[n][-1], rtol=0, atol=0)
            elif spec.flat:
                assert int((a != 0).sum()) == int((a[idx] != 0).sum())
            else:
                assert torch.isnan(a).sum() == a.numel() - a[idx].numel()
        state = want
    return state


@pytest.mark.parametrize("name,r,kernel", MISC)
def test_emitted_misc_kernels_match_plain_gxx(name, r, kernel, tmp_path):
    ctx = port_ctx(name, r, "-g 19 -mode fused")
    import_interiors(ctx, seeded_interiors(ctx, 13))
    spec = cuda_emit.emit(ctx._program)
    assert (spec.stages == 1) == (kernel == "fused_step")
    host_steps(ctx, spec, host_kernel(spec, tmp_path))


def test_misc_slices_are_inputs_and_outputs_of_their_own():
    """test_misc_2d: misc axes interleaved with the domain dims in the
    DSL (the port's layout puts them first), negative misc indices, and
    the misc-only vars B[c, b] and C[t, b, a]; one written slice
    A[., 1, ., 2, 3] of 7x3x4, so A starts from its evicted slot."""
    ctx = port_ctx("test_misc_2d", None, "-g 16 -mode fused")
    spec = cuda_emit.emit(ctx._program)
    assert spec.outputs == ["A"] and spec.base_outputs == ["A"]
    assert spec.out_slices == [(0, (("a", 1), ("b", 2), ("c", 3)))]
    got = dict(zip(spec.in_misc, spec.inputs))
    assert got[(("a", -2), ("b", 2), ("c", 2))] == ("A", 1)
    assert got[(("b", 3), ("c", -2))] == ("B", 0)
    assert got[(("a", 2), ("b", 1))] == ("C", 0)
    assert len(spec.inputs) == 8 and len(spec.tiled) == 4
    # a misc-only var has stride 0 in every slot: read at (0, 0, 0)
    b = spec.inputs.index(("B", 0))
    assert b not in spec.tiled and spec.reach[b] == ((0, 0),) * 3


def test_unwritten_misc_slices_keep_the_evicted_slot(tmp_path):
    """The plain version's new ring slot is the evicted slot with the
    written slices replaced: from a zero-filled output the 83 unwritten
    slices of test_misc_2d's A would read 0."""
    import torch
    ctx = port_ctx("test_misc_2d", None, "-g 16 -mode fused")
    import_interiors(ctx, seeded_interiors(ctx, 3))
    spec = cuda_emit.emit(ctx._program)
    fn = host_kernel(spec, tmp_path)
    state = ctx._state
    ins = [state[n][s] for n, s in spec.inputs]
    want = fused_stencil.plain_chunk(ctx._program, state, 0, 1)["A"][-1]
    for base in (True, False):
        outs = host_outputs(ctx, spec, state, fill=0.0) if base else \
            [torch.zeros_like(state["A"][0])]
        assert fused_stencil.call_entry(fn, ctx._program, spec, ins, outs, 0,
                                        None) == 0
        assert torch.equal(outs[0], want) == base
    # the written slice alone agrees either way
    sl = (1 + 2, 2, 3)     # misc_lo a = -2, b = 0, c = 0
    assert torch.equal(outs[0][sl], want[sl])


def test_copy_base_counts_only_launches_on_the_card():
    """On CPU tensors the wrapper takes the plain version: no kernel, no
    copy of the evicted slot."""
    ctx = port_ctx("test_misc_2d", None, "-g 16 -mode fused -wf_steps 2")
    import_interiors(ctx, seeded_interiors(ctx, 3))
    n0 = (fused_stencil.copy_base.launches, fused_stencil.fused_step.launches)
    ctx.run_solution(0, 2)
    assert (fused_stencil.copy_base.launches,
            fused_stencil.fused_step.launches) == n0


def test_misc_values_bind_per_equation():
    """test_misc_value_2d's three equations read the misc index they pin
    (``im * 0.25``, ``im + 1.0``): each sub-stage prints its own binding,
    so no CSE carries channel 0's value into channel 1."""
    ctx = port_ctx("test_misc_value_2d", None, "-g 16 -mode fused")
    spec = cuda_emit.emit(ctx._program)
    assert spec.stages == 3
    body = spec.source[spec.source.index("stage(const RD"):]
    parts = body.split("if constexpr (K == ")[1:]
    for i, part in enumerate(parts):
        assert f"(double)({i}) * (0x1.0000000000000p-2)" in part
        assert f"(double)({i}) + (0x1.0000000000000p+0)" in part
    assert spec.out_slices == [(0, (("i", i),)) for i in range(3)]


def test_each_channel_writes_its_own_slice():
    """gaussian's three stages each write one channel of img: three output
    slices of one output tensor, each stored by its own stage, none a
    base of another (the rewrite arm's rule applies per slice)."""
    ctx = port_ctx("gaussian", 2, "-g 16 -mode fused")
    spec = cuda_emit.emit(ctx._program)
    assert spec.stages == 3 and spec.outputs == ["img"]
    assert spec.out_slices == [(0, (("c", c),)) for c in range(3)]
    assert spec.computed == [] and spec.base_outputs == []
    assert ("stage_out(int k, int j) { return k == 0 && j == 0 ? 0 : "
            "k == 1 && j == 0 ? 1 : k == 2 && j == 0 ? 2 : -1; }") \
        in spec.source
    # each channel's input is staged with the r=2 halo in x and y
    assert [spec.in_misc[a] for a in spec.tiled] == \
        [(("c", c),) for c in range(3)]
    assert all(spec.halos[a] == ((0, 0), (2, 2), (2, 2))
               for a in spec.tiled)


def test_misc_index_outside_its_equation_raises():
    from yask_tpu_torch.compiler.expr import IndexExpr, IndexType
    ctx = port_ctx("test_misc_value_2d", None, "-g 8 -mode fused")
    pr = cuda_emit._Printer(ctx._program, {"x": 1, "y": 2})
    with pytest.raises(YaskException, match="pins it on the LHS"):
        pr.ev(IndexExpr("i", IndexType.MISC))


def test_misc_solutions_take_no_stream_arm_and_no_k4():
    """The stream arm still leaves misc dims to K1 (A5).  What this test
    pinned of K4 before it took the misc arm (the fallback naming
    ROADMAP.md A12 (A3 arms on K4)) is gone: a forced request runs the
    groups on K4, each misc slice an entry of its own, bit-equal to the
    K1 path."""
    ctx = port_ctx("test_misc_2d", None,
                   "-g 24 -mode fused -wf_steps 2 -no-trapezoid")
    import_interiors(ctx, seeded_interiors(ctx, 3))
    ctx.run_solution(0, 1)
    til = ctx.get_stats().get_tiling()
    assert til["kernel"] == "fused_step" and til["skew_dims"] == []
    assert {r["code"] for r in til["skew_reasons"]} == {"skew_ineligible"}
    k4 = port_ctx("test_misc_2d", None,
                  "-g 24 -mode fused -wf_steps 2 -trapezoid")
    k4._trapezoid_arg = lambda: True
    import_interiors(k4, seeded_interiors(k4, 3))
    k4.run_solution(0, 1)
    spec = k4._trapezoid_kernel().spec
    assert any(spec.in_misc) and spec.base_outputs == ["A"]
    assert k4.get_stats().get_tiling()["trapezoid"] is True
    assert k4.compare_data(ctx, epsilon=0.0, abs_epsilon=0.0) == 0


def test_k5_and_k7_refuse_the_misc_arm():
    """What this test pinned before K5 took the A3 arms (the refusal
    "misc-dim vars ... ROADMAP.md A11 (A3 arms on K5)") is gone:
    shard_pallas runs gaussian (K6's body) and test_misc_2d (K1's, its
    unwritten slices from a copy of the evicted slot), bit-equal to
    shard_map."""
    from test_torch_k5_arms import shard_pallas_matches_shard_map
    from yask_tpu_torch.compiler.solution_base import create_solution
    for name, r in (("gaussian", 2), ("test_misc_2d", None)):
        shard_pallas_matches_shard_map(
            lambda: create_solution(name, radius=r), "-g 24 -nr_x 2")
    # K7 takes the misc arm (ROADMAP.md A9 is done): K6's (gaussian) and
    # K1's (test_misc_2d, whose unwritten slices start from a copy of the
    # evicted slot of each member) batches give each member its solo bits
    for name, r in (("gaussian", 2), ("test_misc_2d", None)):
        members_match_solo(lambda: port_ctx(name, r, "-g 16 -mode fused "
                                            "-wf_steps 2 -ensemble 2"))


@pytest.mark.parametrize("name,r", [("test_misc_2d", None),
                                    ("gaussian", 2)])
def test_transfer_carries_misc_interiors_both_ways(name, r):
    """Misc axes cross at their full extent: the port's interiors into
    yask_tpu and back, and yask_tpu's (cut from its state) into the
    port."""
    mine = port_ctx(name, r, "-g 12 -mode torch")
    state = seeded_interiors(mine, 4)
    import_interiors(mine, state)
    out = export_interiors(mine)
    for n, slots in state.items():
        for a, b in zip(slots, out[n]):
            np.testing.assert_array_equal(a.astype(np.float32), b)
    tfac = yask_tpu.yk_factory()
    theirs = tfac.new_solution(tfac.new_env(), stencil=name, radius=r)
    theirs.apply_command_line_options("-g 12")
    theirs.get_settings().mode = "jit"
    theirs.prepare_solution()
    tpu_init(theirs)
    back = port_ctx(name, r, "-g 12 -mode torch")
    import_interiors(back, tpu_interiors(theirs))
    got = export_interiors(back)
    for n, slots in tpu_interiors(theirs).items():
        for a, b in zip(slots, got[n]):
            np.testing.assert_array_equal(np.asarray(a), b)
