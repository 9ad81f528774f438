"""K5 over K6's stream arm (``stream_stages_kernel<S, false, true>``, the
``_stages_stream_region`` entry) as device code on the CPU: the g++ shim
of tests/test_torch_kernel_emulation.py (one thread per CUDA thread, a
fixed order between barriers, NaN-filled shared memory, each
``cp.async`` leaving its destination NaN until the issuing thread's
wait), launched through the wrapper's own marshalling
(``call_region_stages_stream_entry``) on CPU tensors.

The shards are tests/test_torch_k5_host.py's kind: a shard with an inner
face and the global edge in each sharded dim, from a random state whose
pads hold nonzero ghost values past the inner faces (zero past the
global edge), the sub-steps of one group of 2 over their full boxes
(reaching into the pads), then a ragged box.  Slot 0 holds at least 14
planes and every box is walked in two segments, the last one partial
(a shorter walk hides ring faults).  The cases: tti r=2 and
test_scratch_3d (scratch computed past the global domain), awp (a
rewrite), test_boundary_3d, and ssg at a lowered shared-memory limit
(staged inputs read from their allocations, a computed ring in the
workspace).

Each box is held against ``plain_shard_step`` inside the box, bit-equal
(tti by rtol 1e-5 and atol 1e-6: g++'s libm ``sinf``/``cosf`` against
PyTorch's, as in tests/test_torch_k5_host.py); the outputs come in
NaN-filled and every cell outside the box must stay NaN; and no input is
read past its allocation (each input sits in margins of the shim's
``YT_STRAY`` words, whose reads the shim counts).  Three deliberately
broken copies fail those checks: the ring copies' zero bound taken at
the box instead of the shard's allocation, the scratch clip at the
shard's interior instead of the global domain, and the pads' pass of the
single-domain arm left in the region arm.
"""

import re

import numpy as np
import pytest

import yask_tpu_torch
from yask_tpu_torch.ops import cuda_emit, fused_stencil
from yask_tpu_torch.parallel.shard_step import _full_box, shard_pallas_plan

from test_torch_k5_host import random_state, ragged
from test_torch_kernel_emulation import emulated_kernel
from test_torch_stream_placement import LIMITS
from test_torch_stream_stages_emulation import RUNG

X2 = [("x", 2)]
X2Y2 = [("x", 2), ("y", 2)]
#: id -> (solution, radius, sizes, ranks, the shard's mesh position); a
#: group of 2 steps.  Slot 0 (x) holds 14 planes a shard; slot 1 (y) two
#: or three plane tiles of the 8x32 rung, slot 2 (z) two, the last
#: partial
CASES = {"tti": ("tti", 2, "-g_x 28 -g_y 18 -g_z 40", X2Y2,
                 {"x": 1, "y": 0}),
         "test_scratch_3d": ("test_scratch_3d", None,
                             "-g_x 28 -g_y 18 -g_z 40", X2Y2,
                             {"x": 0, "y": 1}),
         "awp": ("awp", None, "-g_x 28 -g_y 9 -g_z 40", X2, {"x": 1}),
         "test_boundary_3d": ("test_boundary_3d", None,
                              "-g_x 28 -g_y 18 -g_z 40", X2Y2,
                              {"x": 1, "y": 1}),
         "ssg-placed": ("ssg", 2, "-g_x 28 -g_y 18 -g_z 40", X2Y2,
                        {"x": 0, "y": 0})}
#: (rtol, atol) against the plain version: 0 but for tti's libm calls
PLAIN_TOL = {"tti": (1e-5, 1e-6)}
#: the margins (cells per side in every dim) of each input
MARGIN = 24


def shard_case(case):
    """The case's K5 kernel, the shard's global origin, the group's full
    boxes and a ragged box, and the spec emulated: the arm at the 8x32
    rung (ssg's under the lowered limit of
    tests/test_torch_stream_placement.py, its rings past shared
    memory)."""
    name, r, sizes, ranks, pos = CASES[case]
    fac = yask_tpu_torch.yk_factory()
    n = int(np.prod([k for _d, k in ranks]))
    ctx = fac.new_solution(fac.new_env(devices=["cpu"] * n), stencil=name,
                           radius=r)
    nr = " ".join(f"-nr_{d} {k}" for d, k in ranks)
    ctx.apply_command_line_options(
        f"{sizes} -mode shard_pallas -wf_steps 2 {nr}")
    ctx.prepare_solution()
    sp = shard_pallas_plan(ctx)
    kern = sp.kernel
    assert kern.skew_dims == ["x"]
    prog = kern.program
    at = {d: pos.get(d, 0) for d in prog.ana.domain_dims}
    off = sp.layout.offsets[sp.layout.mesh.index(at)]
    boxes = [_full_box(sp, 2, s) for s in range(2)]
    boxes.append(ragged(boxes[0], prog.sizes))
    limit = LIMITS["ssg"] if case == "ssg-placed" else cuda_emit.SMEM_LIMIT
    orig = cuda_emit.SMEM_LIMIT
    cuda_emit.SMEM_LIMIT = limit
    try:
        spec = cuda_emit.emit(prog, stream_tiles=(RUNG,))
    finally:
        cuda_emit.SMEM_LIMIT = orig
    assert spec.stages_stream.tile == RUNG[:2]
    assert spec.stages_stream.placed is (case == "ssg-placed")
    return kern, spec, off, boxes


def margined(a):
    """``a`` as a view into a tensor whose margins of :data:`MARGIN`
    cells hold the shim's ``YT_STRAY`` words."""
    import torch
    big = torch.full(tuple(n + 2 * MARGIN for n in a.shape), 0x7FBADBAD,
                     dtype=torch.int32).view(torch.float32)
    view = big[tuple(slice(MARGIN, MARGIN + n) for n in a.shape)]
    view.copy_(a)
    return view


def box_mask(prog, name, box):
    import torch
    g = prog.geoms[name]
    m = torch.zeros(tuple(g.shape), dtype=torch.bool)
    m[fused_stencil._box_idx(g, box)] = True
    return m


def region_steps(fn, kern, spec, off, boxes, tol=(0.0, 0.0), nres=3):
    """The boxes in turn as sub-steps 0, 1, ... through the emulated
    entry, each into NaN-filled outputs, walked in two segments on
    ``nres`` blocks: inside the box the plain version's values (within
    ``tol``), outside it NaN, and no read past an input's allocation."""
    import torch
    prog = kern.program
    lib_strays = fn._yt_strays
    state = random_state(kern, off, 5)
    for t, box in enumerate(boxes):
        fused_stencil.check_box(prog, spec, box)
        ins = [margined(state[n][k]) for n, k in spec.inputs]
        outs = [torch.full(tuple(prog.geoms[n].shape), float("nan"))
                for n in spec.outputs]
        n0 = box[prog.ana.domain_dims[0]]
        seg = -(-(n0[1] - n0[0]) // 2)
        ws = torch.full((nres * max(spec.stages_stream.ws_elems, 1),),
                        float("nan"))
        lib_strays()
        assert fused_stencil.call_region_stages_stream_entry(
            fn, prog, spec, ins, outs, box, off, t, None, seg, nres,
            ws) == 0
        assert lib_strays() == 0, "an input was read past its allocation"
        want = fused_stencil.plain_shard_step(kern, state, t, box, off)
        for name, got in zip(spec.outputs, outs):
            inside = box_mask(prog, name, box)
            assert got[~inside].isnan().all(), \
                f"{name}: a cell outside the box was written"
            torch.testing.assert_close(got[inside], want[name][-1][inside],
                                       rtol=tol[0], atol=tol[1])
            assert got[inside].abs().max() > 0, f"{name}: the box is 0"
        state = want


def region_kernel(spec, tmp_path, edit=None):
    """The emulated ``_stages_stream_region`` entry, with the shim's
    stray-read counter beside it."""
    import ctypes
    fn = emulated_kernel(spec, tmp_path,
                         entry=spec.name + "_stages_stream_region", edit=edit)
    lib = ctypes.CDLL(str(tmp_path / f"{spec.name}.so"))
    lib.yt_stray_reads.restype = ctypes.c_longlong
    fn._yt_strays = lib.yt_stray_reads
    return fn


@pytest.mark.parametrize("case", list(CASES))
def test_k5_stream_arm_matches_plain_shard_step_when_emulated(case,
                                                              tmp_path):
    kern, spec, off, boxes = shard_case(case)
    assert min(b["x"][1] - b["x"][0] for b in boxes) >= 14
    fn = region_kernel(spec, tmp_path)
    region_steps(fn, kern, spec, off, boxes, tol=PLAIN_TOL.get(case,
                                                               (0.0, 0.0)))


def _edit(pattern, repl, header):
    def edit(fn, text):
        if fn != header:
            return text
        text, n = re.subn(pattern, repl, text)
        assert n >= 1, pattern
        return text
    return edit


#: the deliberately broken copies: (header edit, case, boxes)
MUTATIONS = {
    # the single-domain bound: the box taken for the shard's interior
    "zero_bound_at_the_box": (
        lambda fn, text: text if fn != "stream_stages.cuh" else
        _edit(r"box_lo<S, REGION>\(p, \d\)", "0", fn)(
            fn, _edit(r"alloc_n<S, REGION>\(p, (\d)\)", r"p.n[\1]", fn)(
                fn, text)), "tti", slice(0, 1)),
    # tests/test_torch_k5_emulation.py's edit: the shard-relative clip
    "shard_relative_scratch_clip": (
        _edit(r"    lo -= p\.go\[s\];\n    hi = p\.gn\[s\] \+ "
              r"clip_hi_of<S, K>\(s\) - p\.go\[s\];\n",
              "    lo -= p.lo[s];\n    hi = p.sn[s] + clip_hi_of<S, K>(s) "
              "- p.lo[s];\n", "fused_step.cuh"), "tti", slice(0, 1)),
    # the pads' pass of the single-domain arm left in
    "flat_pads_in_the_region_arm": (
        _edit(r"  if constexpr \(!REGION\)\n    flat_pads<S>", "  flat_pads<S>",
              "stream_stages.cuh"), "awp", slice(1, 2))}


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_k5_stream_emulation_fails_when_broken(mutation, tmp_path):
    edit, case, which = MUTATIONS[mutation]
    kern, spec, off, boxes = shard_case(case)
    fn = region_kernel(spec, tmp_path, edit=edit)
    with pytest.raises(AssertionError):
        region_steps(fn, kern, spec, off, boxes[which],
                     tol=PLAIN_TOL.get(case, (0.0, 0.0)))
