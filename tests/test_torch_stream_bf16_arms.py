"""The arms over K6's stream arm at element size 2: K5 over one shard's
box, K4's K-level groups in 3-D and past three dims, K6's 4-D
``StreamSpec``, and ``-mode fused`` against ``yask_tpu``.

* K5 (``_stages_stream_region``) over a shard of tti r=2 on 2x2 shards:
  the sub-steps of a group of 2 over their full boxes and a ragged box,
  each walked in two segments, into NaN-filled outputs that must stay
  NaN outside the box, bit-equal to ``plain_shard_step`` inside it, no
  input read past its allocation (margins of the emulation shim's
  ``YT_STRAY`` words); and the g++ host path (K6's host loop over the
  box) into zeroed outputs, as tests/test_torch_k5_host.py runs K5's
  body.
* K4's stream arm (``_trap_stream``): iso3dfd r=2 and tti r=2 at K = 2,
  one group against ``plain_chunk`` to the bit; test_4d at K = 2 on its
  4-D arm, and K6's 4-D arm on four_d_stages, two windows of w, the last
  partial; host path and device code; NaN-filled outputs, read-only
  inputs with nonzero pads, two plane tiles per slot and two segments,
  the last of each partial.
* ``-mode fused`` at element size 2 (the plain version on CPU tensors)
  against ``yask_tpu`` jit at element size 2 on tti r=2, ssg and awp
  (tests/test_torch_bf16_k6.py's protocol and tolerance, (3e-2, 3e-2),
  and 0 cells whose bits differ), ``get_tiling()`` naming the stream arm.
* The wrappers' stride checks: odd member and outer strides raise.
"""

import sys

import numpy as np
import pytest

import yask_tpu
import yask_tpu_torch
from yask_tpu.runtime.init_utils import init_solution_vars as tpu_init
from yask_tpu_torch.ops import cuda_emit, fused_stencil
from yask_tpu_torch.parallel.shard_step import _full_box, shard_pallas_plan
from yask_tpu_torch.runtime.init_utils import init_solution_vars as port_init
from yask_tpu_torch.transfer import export_interiors
from yask_tpu_torch.utils.exceptions import YaskException

from test_torch_4d import BUILDERS
from test_torch_bf16 import BF16_EPS, bf16_source, port_ctx
from test_torch_k4_host import assert_states
from test_torch_k5_host import random_state, ragged
from test_torch_k5_stream_emulation import box_mask
from test_torch_kernel_emulation import emulated_kernel
from test_torch_lowering import mismatches
from test_torch_scratch import with_pads
from test_torch_stencils import tpu_interiors
from test_torch_stream_stages_host import host_entry

SEG = 8
#: 4x8 plane tiles by 32 threads (K4 and the 4-D arms), 8x32 by 256 (K5)
SMALL = (4, 8, 32)
RUNG = (8, 32, 256)
#: margin cells per side of each K5 input
MARGIN = 24


# ---------------------------------------------------------------------------
# K5 over the arm
# ---------------------------------------------------------------------------


def margined(a):
    """bfloat16 ``a`` as a view into a tensor whose margins of
    :data:`MARGIN` cells hold the shim's ``YT_STRAY`` word in every
    aligned 4-byte pair (0xDBAD, 0x7FBA)."""
    import torch
    shape = tuple(n + 2 * MARGIN for n in a.shape)
    big = torch.empty(shape, dtype=torch.int16)
    flat = big.view(-1)
    flat[0::2] = 0xDBAD - 0x10000
    flat[1::2] = 0x7FBA
    big = big.view(torch.bfloat16)
    view = big[tuple(slice(MARGIN, MARGIN + n) for n in a.shape)]
    view.copy_(a)
    return view


def tti_shard():
    """tti r=2 in bfloat16 on 2x2 CPU shards: K5's kernel, shard (1, 0)'s
    global origin, the group's full boxes and a ragged one, and the arm's
    spec at :data:`RUNG`."""
    fac = yask_tpu_torch.yk_factory()
    ctx = fac.new_solution(fac.new_env(devices=["cpu"] * 4),
                           bf16_source("yask_tpu_torch", "tti", 2))
    ctx.apply_command_line_options("-g_x 28 -g_y 18 -g_z 40 -mode "
                                   "shard_pallas -wf_steps 2 -nr_x 2 "
                                   "-nr_y 2")
    ctx.prepare_solution()
    sp = shard_pallas_plan(ctx)
    kern = sp.kernel
    assert kern.skew_dims == ["x"]
    prog = kern.program
    at = {d: {"x": 1}.get(d, 0) for d in prog.ana.domain_dims}
    off = sp.layout.offsets[sp.layout.mesh.index(at)]
    boxes = [_full_box(sp, 2, s) for s in range(2)]
    boxes.append(ragged(boxes[0], prog.sizes))
    spec = cuda_emit.emit(prog, stream_tiles=(RUNG,))
    assert spec.stages_stream.tile == RUNG[:2]
    return kern, spec, off, boxes


def region_entry(spec, tmp_path, device):
    """The ``_stages_stream_region`` entry: the g++ host path, or the
    emulated device code with the shim's stray-read counter."""
    import ctypes
    if not device:
        fn = host_entry(spec, tmp_path, "_stages_stream_region")
        fn.argtypes = fused_stencil.region_stages_stream_argtypes()
        fn._yt_strays = lambda: 0
        return fn
    fn = emulated_kernel(spec, tmp_path,
                         entry=spec.name + "_stages_stream_region")
    lib = ctypes.CDLL(str(tmp_path / f"{spec.name}.so"))
    lib.yt_stray_reads.restype = ctypes.c_longlong
    fn._yt_strays = lib.yt_stray_reads
    return fn


@pytest.mark.parametrize("device", [False, True],
                         ids=["host_path", "device_code"])
def test_k5_over_tti_matches_plain_shard_step(device, tmp_path):
    import torch
    kern, spec, off, boxes = tti_shard()
    prog = kern.program
    assert min(b["x"][1] - b["x"][0] for b in boxes) >= 14
    fn = region_entry(spec, tmp_path, device)
    state = random_state(kern, off, 5)
    for t, box in enumerate(boxes):
        fused_stencil.check_box(prog, spec, box)
        ins = [margined(state[n][k]) for n, k in spec.inputs]
        fused_stencil.check_pair_strides(prog, spec, ins)
        # the host path (K6's host loop over the box) stores the box's
        # cells inside the global domain, as K5's body does into zeroed
        # outputs; the device code every cell of the box
        outs = [torch.full(tuple(prog.geoms[n].shape),
                           float("nan") if device else 0.0,
                           dtype=torch.bfloat16) for n in spec.outputs]
        n0 = box["x"]
        seg = -(-(n0[1] - n0[0]) // 2)
        fn._yt_strays()
        assert fused_stencil.call_region_stages_stream_entry(
            fn, prog, spec, ins, outs, box, off, t, None, seg, 3,
            None) == 0
        assert fn._yt_strays() == 0, "an input was read past its allocation"
        want = fused_stencil.plain_shard_step(kern, state, t, box, off)
        for name, got in zip(spec.outputs, outs):
            inside = box_mask(prog, name, box)
            assert got[~inside].isnan().all() if device \
                else not got[~inside].any(), name
            assert torch.equal(got[inside], want[name][-1][inside]), name
            assert got[inside].float().abs().max() > 0, name
        state = want


# ---------------------------------------------------------------------------
# K4's stream arm, 3-D and 4-D, and K6's 4-D arm
# ---------------------------------------------------------------------------


def k4_bf16(name, r, K, sizes):
    """A seeded bfloat16 context under ``-mode fused -wf_steps K
    -trapezoid`` (``sizes`` per domain dim), read-only pads nonzero."""
    fac = yask_tpu_torch.yk_factory()
    if name in BUILDERS:
        src = BUILDERS[name]("yask_tpu_torch")
        src.set_element_bytes(2)
    else:
        src = bf16_source("yask_tpu_torch", name, r)
    ctx = fac.new_solution(fac.new_env(device="cpu"), src)
    dims = ctx.get_domain_dim_names()
    trap = f" -wf_steps {K} -trapezoid" if K > 1 else ""
    ctx.apply_command_line_options(
        " ".join(f"-g_{d} {n}" for d, n in zip(dims, sizes))
        + f" -mode fused{trap}")
    ctx.prepare_solution()
    with_pads(ctx, 27)
    return ctx


def launch(fn, ctx, spec, state, t0):
    """One launch through a stream entry into NaN-filled bfloat16 outputs
    (a NaN-filled workspace where rings lie past shared memory); rings
    rotated."""
    import torch
    prog = ctx._program
    plan = spec.stages_stream
    ins = [state[n][s] for n, s in spec.inputs]
    fused_stencil.check_pair_strides(prog, spec, ins)
    outs = [torch.full(tuple(prog.geoms[n].shape), float("nan"),
                       dtype=torch.bfloat16) for n in spec.outputs]
    ws = (torch.full((3 * plan.ws_elems,), float("nan"),
                     dtype=torch.bfloat16) if plan.ws_elems else None)
    assert fused_stencil.call_stages_stream_entry(
        fn, prog, spec, ins, outs, t0, None, seg=SEG, nres=3, ws=ws) == 0
    return fused_stencil._rotated(prog, spec, state, outs)


#: (solution, radius, K, sizes per domain dim, outer windows)
K4_CASES = {"iso3dfd": ("iso3dfd", 2, 2, (14, 6, 12), ()),
            "tti": ("tti", 2, 2, (14, 6, 12), ()),
            "test_4d": ("test_4d", None, 2, (7, 14, 6, 12), (4,))}


@pytest.mark.parametrize("case", list(K4_CASES))
def test_k4_stream_arm_group_matches_plain(case, tmp_path):
    """One K-step group of K4's stream arm at element size 2 (the group's
    levels in bfloat16 computed rings), host path and device code."""
    name, r, K, sizes, wo = K4_CASES[case]
    ctx = k4_bf16(name, r, K, sizes)
    prog = ctx._program
    lead = prog.ana.domain_dims[:-1]
    spec, cause = cuda_emit.emit_trap_stream(
        prog, K, ["x", "y"], {d: 8 for d in lead}, cuda_emit.SMEM_LIMIT,
        (SMALL + ((wo,) if wo else ()),))
    assert cause is None, cause
    assert spec.trap["arm"] == "stream" and spec.stages_stream.esize == 2
    assert "typedef yt::bf16_t real_t;" in spec.source
    want = fused_stencil.plain_chunk(prog, ctx._state, 0, K)
    for fn in (host_entry(spec, tmp_path, "_trap_stream"),
               emulated_kernel(spec, tmp_path,
                               entry=spec.name + "_trap_stream")):
        fn.argtypes = fused_stencil.stages_stream_argtypes()
        assert_states(launch(fn, ctx, spec, ctx._state, 0), want)


def test_k6_4d_stream_arm_matches_plain(tmp_path):
    """K6's 4-D arm (the ``StreamSpec`` beside the body) on four_d_stages
    in bfloat16, two sub-steps, host path and device code."""
    ctx = k4_bf16("four_d_stages", None, 1, (7, 14, 6, 12))
    prog = ctx._program
    assert ctx._fused_spec_kernel().skew_dims == ["x"]
    spec = cuda_emit.emit(prog, stream_tiles=(SMALL + ((4,),),))
    ss = spec.stream_spec
    assert ss.stages_stream.esize == 2 and ss.stages_stream.outer_tile == (4,)
    for fn in (host_entry(spec, tmp_path, "_stages_stream"),
               emulated_kernel(spec, tmp_path,
                               entry=spec.name + "_stages_stream")):
        state = ctx._state
        for t in range(2):
            got = launch(fn, ctx, ss, state, t)
            want = fused_stencil.plain_chunk(prog, state, t, 1)
            assert_states(got, want)
            state = want


def test_pair_checks_raise_on_odd_member_and_outer_strides():
    """The stream arms' wrappers raise at element size 2 where a member
    batch's or an outer dim's stride is odd (the pair copies would
    misalign from one member or window to the next)."""
    import torch
    ctx = k4_bf16("four_d_stages", None, 1, (7, 14, 6, 12))
    spec = ctx._fused_spec_kernel().spec.stream_spec
    ins = [ctx._state[n][s] for n, s in spec.inputs]
    fused_stencil.check_pair_strides(ctx._program, spec, ins,
                                     what="stages_step")
    a = spec.tiled[0]
    w = ins[a].shape[0]
    # the outer dim w strided by an odd count of cells
    odd = torch.zeros((w * ins[a][0].numel() + w,), dtype=torch.bfloat16)
    ins_o = list(ins)
    ins_o[a] = odd.as_strided(ins[a].shape, (ins[a][0].numel() + 1,)
                              + ins[a].stride()[1:])
    with pytest.raises(YaskException, match="outer and member strides"):
        fused_stencil.check_pair_strides(ctx._program, spec, ins_o,
                                         what="stages_step")
    # three members, each an odd count of cells past the last
    n = ins[a].numel() + 1
    stack = torch.zeros((3 * n,), dtype=torch.bfloat16).as_strided(
        (3,) + tuple(ins[a].shape), (n,) + ins[a].stride())
    ins_m = [torch.stack([x] * 3) for x in ins]
    ins_m[a] = stack
    with pytest.raises(YaskException, match="member stride"):
        fused_stencil.check_pair_strides(ctx._program, spec, ins_m, 1,
                                         what="stages_step")


# ---------------------------------------------------------------------------
# against yask_tpu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["tti", "ssg", "awp"])
def test_fused_bf16_matches_yask_tpu_jit_on_the_arm(name, monkeypatch):
    """``-mode fused`` at element size 2 against ``yask_tpu`` jit at
    element size 2 (g = 24, ``init_solution_vars``, 2 steps, K = 2):
    within (3e-2, 3e-2) and with no cell's bits differing; the tiling
    names K6's stream arm and gives no element-size reason."""
    r = {"tti": 2, "ssg": 2}.get(name)
    tfac = yask_tpu.yk_factory()
    theirs = tfac.new_solution(tfac.new_env(),
                               bf16_source("yask_tpu", name, r))
    theirs.apply_command_line_options("-g 24")
    theirs.get_settings().mode = "jit"
    theirs.prepare_solution()
    tpu_init(theirs)
    theirs.run_solution(0, 1)
    want = tpu_interiors(theirs)
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    mine = port_ctx(name, r, "-g 24 -mode fused -wf_steps 2")
    port_init(mine)
    n0 = fused_stencil.stages_step.stream_launches
    mine.run_solution(0, 1)
    assert fused_stencil.stages_step.stream_launches == n0
    til = mine.get_stats().get_tiling()
    assert til["kernel"] == "stages_step" and til["skew"] is True
    assert til["name"].endswith("_stages_stream")
    assert til["skew_reasons"][0]["code"] == "skew_engaged"
    assert not any("element size 2" in x.get("detail", "")
                   for x in til["skew_reasons"])
    got = export_interiors(mine)
    assert mismatches(got, want, BF16_EPS, BF16_EPS) == 0
    assert sum(int(np.sum(a != b)) for n in got
               for a, b in zip(got[n], want[n])) == 0
