"""The stream arm past three domain dims on the host: its plans, its
reason records and its g++ host path, on the CPU.

* The plans by hand: K4's stream arm on test_4d at K = 2 (level 1 lagged
  3 planes and grown by what level 2 reads of it, w − 2 … w + 3 in the
  outer dim; the input ring's reach and outer halo; the level ring's
  depth; the outer window, the rung and where each ring lies) and K6's
  on four_d_stages (the sub-stages' lags and outer regions, one ring per
  var and ring slot serving its reads at every outer offset).
* The reason records: ``-mode fused`` runs four_d_stages and five_d on
  K6's stream arm (``stages_stream`` with its outer window in
  ``get_tiling()``), solo and in member batches; K5 over a 4-D box keeps
  its body (tests/test_torch_stream_stages_host.py).
* The emitted entries built by g++ for the host (``host_stages_outer``:
  each sub-stage once over its plain region in every slot, then the pads
  of every slot) against ``plain_chunk``, solo and for two stacked
  members, into NaN-filled outputs: to the bit."""

import ctypes
import shutil
import subprocess

import pytest

from yask_tpu_torch.ops import cuda_emit, fused_stencil

from test_torch_fused import CSRC
from test_torch_k4_host import assert_states
from test_torch_stream_4d_emulation import (SEG, ctx_of, k4_spec, k6_spec,
                                            launch)


def test_test_4d_k2_plan_by_hand():
    ctx = ctx_of("test_4d", 2)
    prog = ctx._program
    lead = prog.ana.domain_dims[:-1]
    spec, cause = cuda_emit.emit_trap_stream(prog, 2, ["x", "y"],
                                             {d: 8 for d in lead})
    assert cause is None
    tr, plan = spec.trap, spec.stages_stream
    # test_4d reads u at the centre and the corners w - 2 / w + 3, x - 1 /
    # x + 3, y - 3 / y + 2, z - 2 / z + 1: level 1 (slots x, y, z, w) is
    # grown by those reads of level 2, and lags 3 planes of x
    assert tr["level_lags"] == [[3], [0]]
    assert tr["level_growth"][0] == ([1, 3, 2, 2], [3, 2, 1, 3])
    assert tr["level_growth"][1] == ([0] * 4, [0] * 4)
    # one input ring (u's slot 1) serves the reads at w, w - 2 and w + 3
    assert spec.inputs == [("u", 1)] * 3
    assert spec.in_outer == [(0,), (-2,), (3,)] and spec.tiled == [0]
    assert plan.in_ohalos == {0: [(4, 6)]}
    assert spec.halos[0] == ((2, 6), (6, 4), (4, 2))
    assert plan.in_reach[0] == (-2, 6) and plan.in_depths[0] == 8
    assert plan.cmp_depths == [5]
    # the widest window of the ladder (the fewest computed cells), its
    # rings past shared memory
    assert plan.outer_tile == (7,) and plan.tile == (16, 32)
    assert plan.in_place == {0: "global"}
    assert plan.record()["outer_window"] == [7]


def test_four_d_stages_k6_plan_by_hand():
    """s (scratch, read at w ± 1 by a), a (read at w ± 1 by b) and b: the
    stream arm's sub-stages once each, s and a lagged 1 plane of x (b
    reads a at x + 1), a grown by 1 in w and s by 2; two rings, a's slot
    1 (read at w and w - 1) and a's slot 0 (the base of its conditional
    write)."""
    ctx = ctx_of("four_d_stages")
    spec = cuda_emit.emit(ctx._program)
    ss = spec.stream_spec
    plan = ss.stages_stream
    assert spec.stages == 9 and ss.stages == 3
    assert plan.lags == [1, 1, 0]
    assert [(lo[3], hi[3]) for lo, hi in ss.sub_regions] == [(2, 2), (1, 1),
                                                             (0, 0)]
    assert ss.in_outer == [(0,), (0,), (-1,), (0,), (0,)]
    assert [ss.inputs[a] for a in ss.tiled] == [("a", 1), ("a", 0)]
    assert plan.in_ohalos[0] == [(3, 2)]
    assert plan.outer_tile == (7,)
    rec = spec.stages_stream.record()
    assert rec["outer_window"] == [7]
    assert "YT_STAGES_STREAM_OUTER_ENTRIES" in spec.source
    assert "struct StreamSpec {" in spec.source


@pytest.mark.parametrize("case", ["four_d_stages", "five_d"])
def test_fused_4d_runs_the_stream_arm_and_reports_it(case):
    """``-mode fused`` (the default ``-skew``) routes the sub-steps to
    K6's stream arm, solo and in member batches; the tiling names the
    outer window and the walk's dim."""
    ctx = ctx_of(case)
    kern = ctx._fused_spec_kernel()
    assert kern.skew_dims == ["x"]
    ctx.run_solution(0, 0)
    til = ctx.get_stats().get_tiling()
    assert til["skew"] and til["skew_dims"] == ["x"]
    assert til["stages_stream"]["outer_window"] == list(
        kern.spec.stages_stream.outer_tile)
    eng = [r for r in til["skew_reasons"] if r["code"] == "skew_engaged"]
    assert eng and "outer window" in eng[0]["detail"]
    batch = kern.tiling(1, 3)
    assert batch["skew"] and batch["members"] == 3


def host_lib(spec, tmp_path):
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to test the host path"
    src = tmp_path / f"{spec.name}.cpp"
    so = tmp_path / f"{spec.name}.so"
    src.write_text(spec.source)
    subprocess.run([gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                    CSRC, "-o", str(so), str(src)], check=True,
                   capture_output=True, timeout=300)
    return ctypes.CDLL(str(so))


def bind(lib, name, batched):
    fn = getattr(lib, name)
    fn.argtypes = (fused_stencil.batched_stages_stream_argtypes() if batched
                   else fused_stencil.stages_stream_argtypes())
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.parametrize("case,K", [("four_d_stages", 1), ("five_d", 1),
                                    ("test_4d", 2), ("four_d_stages", 2)])
def test_4d_stream_entries_match_plain_on_the_host(case, K, tmp_path):
    import torch
    ctxs = [ctx_of(case, K, seed=50 + i) for i in range(2)]
    prog = ctxs[0]._program
    if K > 1:
        spec = src = k4_spec(ctxs[0], case, K)
        stem = spec.name + "_trap_stream"
    else:
        src, spec = k6_spec(ctxs[0], case)
        stem = src.name + "_stages_stream"
    lib = host_lib(src, tmp_path)
    got = launch(bind(lib, stem, False), ctxs[0], spec, ctxs[0]._state, 0)
    assert_states(got, fused_stencil.plain_chunk(prog, ctxs[0]._state, 0,
                                                 K))
    ins = [torch.stack([c._state[n][s] for c in ctxs])
           for n, s in spec.inputs]
    outs = [torch.full((2,) + tuple(prog.geoms[n].shape), float("nan"))
            for n in spec.outputs]
    assert fused_stencil.call_batched_stages_stream_entry(
        bind(lib, stem + "_batched", True), prog, spec, ins, outs, 2, 0,
        None, seg=SEG) == 0
    for i, c in enumerate(ctxs):
        assert_states(fused_stencil._rotated(prog, spec, c._state,
                                             [o[i] for o in outs]),
                      fused_stencil.plain_chunk(prog, c._state, 0, K))
