"""K4 on more than three domain dims: the outer dims as uniform window
dims of the trapezoid/diamond geometry.

The trapezoid dims stay ``lead[-2:]`` (x and y of test_4d's w, x, y, z);
``w`` is blocked uniformly with K·r margins, as the reference blocks it,
each sub-stage is computed once over its region in every slot (no outer
copies), and a read at an outer offset reads the level buffer there.

* test_4d and ``four_d_stages`` (tests/test_torch_4d.py: a scratch var
  and a second stage read at outer offsets), forced: the g++ host path
  (NaN-filled buffers and outputs) and the device code emulated with
  the CUDA shim of tests/test_torch_kernel_emulation.py (NaN-filled
  shared memory and workspace; a block per tile, then two blocks walking
  every tile), with the buffers placed as on the card and all in the
  workspace: one group against ``plain_chunk``, to the bit.
* The same group against two steps of the ``-no-trapezoid`` path's own
  code (K1's or K6's g++ host path): to the bit.
* test_4d at element size 2, and a member batch of two
  (``<name>_trap_batched``) against each member's solo group: to the
  bit.
* Auto ``-trapezoid`` records the gate's codes, against ``yask_tpu``'s
  gate on test_4d at 12⁴, 16⁴ and 24⁴ (the same decision but at 12⁴,
  where the reference's TPU band floor rejects), and a forced run on the
  CPU against ``yask_tpu``'s forced trapezoid (interpret mode) on
  test_4d: ``compare_data``'s rule with ``field_epsilon=1e-4``.
"""

import math

import numpy as np
import pytest

import yask_tpu
import yask_tpu_torch
from yask_tpu_torch.ops import cuda_emit, fused_stencil
from yask_tpu_torch.transfer import export_interiors, import_interiors

from test_torch_4d import source
from test_torch_fused import host_kernel
from test_torch_k4_arms import seeded_physical
from test_torch_k4_emulation import emulated_group
from test_torch_k4_host import assert_states, build, host_group
from test_torch_kernel_emulation import emulated_kernel
from test_torch_lowering import mismatches, tpu_import
from test_torch_stencils import tpu_interiors
from test_torch_trapezoid import codes, tpu_forced_trapezoid  # noqa: F401

K = 2
#: (w, x, y, z): several tiles in every trapezoid dim and in w, ragged
SIZES = {"test_4d": (6, 16, 16, 4), "four_d_stages": (7, 16, 16, 9)}
#: three w tiles, the last ragged; two in x and y (the band floor's 8)
BLOCK = {"w": 3, "x": 8, "y": 8}


def k4d_ctx(case, sizes=None, eb=4, forced=True, seed=13):
    fac = yask_tpu_torch.yk_factory()
    src, kw = source("yask_tpu_torch", case)
    if src is None:
        from yask_tpu_torch.compiler.solution_base import create_solution
        src, kw = create_solution(case), {}
        src.get_soln().set_element_bytes(eb)
    else:
        src.set_element_bytes(eb)
    ctx = fac.new_solution(fac.new_env(device="cpu"), src, **kw)
    if forced:
        ctx._trapezoid_arg = lambda: True
    dims = " ".join(f"-g_{d} {n}" for d, n in
                    zip("wxyz", sizes or SIZES[case]))
    ctx.apply_command_line_options(f"{dims} -mode fused -wf_steps {K} "
                                   "-trapezoid")
    ctx.prepare_solution()
    import_interiors(ctx, seeded_physical(ctx, seed))
    return ctx


def tiles(spec):
    return max(math.prod(p["grid"]) for p in spec.trap["passes"])


@pytest.mark.parametrize("lim", [cuda_emit.SMEM_LIMIT, 0])
@pytest.mark.parametrize("case", ["test_4d", "four_d_stages"])
def test_k4_4d_host_and_emulated_match_plain(case, lim, tmp_path):
    ctx = k4d_ctx(case)
    prog = ctx._program
    spec = cuda_emit.resolve_trapezoid(prog, K, True, block=BLOCK,
                                       smem_limit=lim)
    assert spec.outer == 1 and spec.trap["trap_dims"] == ["x", "y"]
    p1 = spec.trap["passes"][0]
    assert len(p1["tile"]) == 4 and p1["grid"][3] >= 2
    assert (p1["smem_buffers"] > 0) == (lim > 0)
    want = fused_stencil.plain_chunk(prog, ctx._state, 0, K)
    fn, _bfn = build(spec, tmp_path)
    assert_states(host_group(fn, prog, spec, ctx._state, 0), want)
    efn = emulated_kernel(spec, tmp_path)
    for nres in (tiles(spec), 2):
        assert_states(emulated_group(efn, prog, spec, ctx._state, nres),
                      want)


@pytest.mark.parametrize("case", ["test_4d", "four_d_stages"])
def test_k4_4d_bit_equals_the_no_trapezoid_path(case, tmp_path):
    """One group of K4's host path against two sub-steps of the K1/K6
    kernel the ``-no-trapezoid`` run takes, through its own host path."""
    import torch
    ctx = k4d_ctx(case)
    prog = ctx._program
    trap = cuda_emit.resolve_trapezoid(prog, K, True)
    fn, _bfn = build(trap, tmp_path)
    got = host_group(fn, prog, trap, ctx._state, 0)
    spec = cuda_emit.emit(prog)
    assert (spec.stages > 1) == (case == "four_d_stages")
    (tmp_path / "k16").mkdir()
    kfn = host_kernel(spec, tmp_path / "k16")
    state = ctx._state
    for t in range(K):
        ins = [state[n][s] for n, s in spec.inputs]
        outs = [torch.zeros(tuple(prog.geoms[n].shape)) for n in
                spec.outputs]
        assert fused_stencil.call_entry(kfn, prog, spec, ins, outs, t,
                                        None) == 0
        state = fused_stencil._rotated(prog, spec, state, outs)
    for n in spec.outputs:
        for a, b in zip(got[n], state[n]):
            assert torch.equal(a, b), n


def test_k4_4d_bf16_matches_plain(tmp_path):
    import torch
    ctx = k4d_ctx("test_4d", eb=2)
    prog = ctx._program
    spec = ctx._trapezoid_kernel().spec
    assert "typedef yt::bf16_t real_t;" in spec.source
    assert ctx._state["u"][0].dtype == torch.bfloat16
    want = fused_stencil.plain_chunk(prog, ctx._state, 0, K)
    fn, _bfn = build(spec, tmp_path)
    assert_states(host_group(fn, prog, spec, ctx._state, 0), want)
    efn = emulated_kernel(spec, tmp_path)
    assert_states(emulated_group(efn, prog, spec, ctx._state, 2), want)


def test_k4_4d_member_batch_matches_solo(tmp_path):
    import torch
    nm = 2
    ctxs = [k4d_ctx("test_4d", seed=30 + i) for i in range(nm)]
    prog = ctxs[0]._program
    spec = ctxs[0]._trapezoid_kernel().spec
    fn, bfn = build(spec, tmp_path)
    stacked = {n: [torch.stack([c._state[n][s] for c in ctxs])
                   for s in range(len(ring))]
               for n, ring in ctxs[0]._state.items()}
    got = host_group(bfn, prog, spec, stacked, 0, nm=nm)
    for i, c in enumerate(ctxs):
        solo = host_group(fn, prog, spec, c._state, 0)
        assert_states({n: [a[i] for a in ring] for n, ring in got.items()},
                      solo)


@pytest.mark.parametrize("case", ["test_4d", "four_d_stages"])
def test_k4_4d_auto_gate_records_its_codes(case):
    ctx = k4d_ctx(case, (12, 12, 12, 12), forced=False)
    ctx._trapezoid_kernel()
    got = set(codes(ctx._trap[1]))
    assert got & {"trapezoid_engaged", "trapezoid_gate_rejected"}
    assert not got & {"trapezoid_fallback", "trapezoid_ineligible"}
    gate = [r for r in ctx._trap[1] if r["code"].startswith(
        ("trapezoid_engaged", "trapezoid_gate"))]
    assert {r["dim"] for r in gate} == {"x", "y"}
    assert all("trap " in r["detail"] and " vs uniform " in r["detail"]
               for r in gate)
    want = fused_stencil.plain_chunk(ctx._program, ctx._state, 0, K)
    ctx.run_solution(0, K - 1)
    assert_states(ctx._state, want)
    til = ctx.get_stats().get_tiling()
    assert til["trapezoid_request"] == "auto"


def tpu_gate(g):
    """``yask_tpu``'s auto trapezoid gate on test_4d at ``g``⁴, K = 2
    (``build_pallas_chunk(trapezoid=None, plan_only=True)``): its gate
    records and its trapezoid plan."""
    from yask_tpu.ops.pallas_stencil import build_pallas_chunk
    from yask_tpu.ops.tile_planner import TilePlan
    tfac = yask_tpu.yk_factory()
    theirs = tfac.new_solution(tfac.new_env(), stencil="test_4d")
    theirs.apply_command_line_options(f"-g {g} -wf_steps {K}")
    theirs.get_settings().mode = "pallas"
    theirs.prepare_solution()
    reasons = []
    build_pallas_chunk(theirs._program, fuse_steps=K, trapezoid=None,
                       interpret=True, plan_only=True, reasons=reasons)
    gate = [r for r in reasons if r["code"] in ("trapezoid_engaged",
                                                "trapezoid_gate_rejected")]
    return gate, TilePlan(theirs._program, K, trap_dims=["x", "y"])


@pytest.mark.parametrize("g", [12, 16, 24])
def test_k4_4d_auto_gate_against_yask_tpu(g):
    """The port's auto gate on test_4d against the reference's: both
    reject at 16⁴ and 24⁴.  At 12⁴ the reference's trapezoid cost is inf
    and the port's is not: the reference rounds the half-band of y
    (``lead[-1]``, the TPU's sublane axis) up to its 8-row tile, so its
    band floor there is 2·8 + 8 = 24 > 12, where the card has no such
    tile and the port's floor is 2·3 + 1 = 7 (ROADMAP.md C19).  The same
    rounding stands apart in 3-D (tests/test_torch_trapezoid.py)."""
    from yask_tpu_torch.ops.tile_planner import TilePlan
    theirs, tplan = tpu_gate(g)
    mine = k4d_ctx("test_4d", (g,) * 4, forced=False)
    mine._trapezoid_kernel()
    gate = [r for r in mine._trap[1] if r["code"] in (
        "trapezoid_engaged", "trapezoid_gate_rejected")]
    assert [(r["code"], r["dim"]) for r in theirs] == [
        ("trapezoid_gate_rejected", "x"), ("trapezoid_gate_rejected", "y")]
    assert [r["dim"] for r in gate] == ["x", "y"]
    assert len({r["code"] for r in gate}) == 1
    assert tplan.min_block() == {"x": 7, "y": 24}
    assert TilePlan(mine._program, K,
                    trap_dims=["x", "y"]).min_block() == {"x": 7, "y": 7}
    if g == 12:
        assert theirs[0]["detail"].startswith("trap inf vs uniform 6.19")
        assert gate[0]["code"] == "trapezoid_engaged"
        assert gate[0]["detail"].startswith("trap 10.62 vs uniform 18.00")
    else:
        assert gate[0]["code"] == "trapezoid_gate_rejected"


def test_k4_4d_matches_yask_tpu_forced_trapezoid(tpu_forced_trapezoid):
    steps = 3       # one group and a remainder step on K1
    mine = k4d_ctx("test_4d", (24, 24, 24, 24))
    tfac = yask_tpu.yk_factory()
    theirs = tfac.new_solution(tfac.new_env(), stencil="test_4d")
    theirs.apply_command_line_options(f"-g 24 -wf_steps {K}")
    theirs.get_settings().mode = "pallas"
    theirs.get_settings().trapezoid_tiling = True
    theirs.prepare_solution()
    tpu_import(theirs, export_interiors(mine))
    mine.run_solution(0, steps - 1)
    theirs.run_solution(0, steps - 1)
    a, b = export_interiors(mine), tpu_interiors(theirs)
    assert all(np.isfinite(x).all() for s in a.values() for x in s)
    assert mismatches(a, b, field_epsilon=1e-4) == 0
    til, ttil = mine.get_stats().get_tiling(), theirs.get_stats().get_tiling()
    assert til["trapezoid"] is ttil["trapezoid"] is True
    assert til["trap_dims"] == ttil["trap_dims"] == ["x", "y"]
    assert til["block"]["w"] == mine._trapezoid_kernel().spec.trap[
        "passes"][0]["tile"][3]
