"""K6's flat arm as device code, run on the CPU: the g++ shim of
tests/test_torch_kernel_emulation.py (one thread per CUDA thread, a fixed
order between barriers, NaN-filled shared memory, and ``cp.async``
leaving its destination NaN from its issue until the issuing thread's
wait), through the wrapper's own marshalling on CPU tensors.  The host
path reads global memory only, so it cannot see what the flat arm adds:
the tile walk of the resident blocks, the two staged buffers, the copies
of the next tile under the current one's compute and the zeroed pads.

Every 1-D and 2-D solution K6 carries: the first four 2-D ones at
element size 4 here, the other three in
tests/test_torch_flat_emulation_2d.py, both at element size 2 in
tests/test_torch_flat_emulation_bf16.py and
tests/test_torch_flat_emulation_2d_bf16.py, the 1-D ones in
tests/test_torch_flat_emulation_1d.py (4) and
tests/test_torch_flat_emulation_1d_bf16.py (2).  Each on a grid of two
tiles per tiled slot (the last partial), from random interiors with
nonzero pads on the read-only inputs, into NaN-filled outputs, whole
tensors against the plain version:

* K6 solo at 1 resident block (one block walks
  every tile), 2 and the tile count (a block per tile, no prefetch);
* K5 over a box of the domain (at global origin 0; into the pads as far
  as its reads allow, short of the interior's end), 2 blocks, against
  ``plain_shard_chunk``;
* K7 over 3 members whose stacks sit a padded stride apart, 2 blocks;

Tolerance: none, but test_func_1d's math functions (libm against
PyTorch's; tests/test_torch_flat_host.py says why).  The mutation checks
are in tests/test_torch_flat_arms.py."""

import ctypes
import math

import pytest

from yask_tpu_torch.ops import cuda_emit, fused_stencil

from test_torch_flat_host import (FLAT_2D, flat_ctx, fresh_outputs,
                                  inner_box, stacked, tol)
from test_torch_k7_host import padded
from test_torch_kernel_emulation import emulated_kernel
from test_torch_scratch import with_pads

#: two tiles or more per tiled slot, the last partial (64x64 in 2-D,
#: 32x64 on swe2d, 4096 in 1-D)
SIZES = ("-g 5000", "-g_x 70 -g_y 100")


def tiles(prog, spec, nm=1, box=None):
    """The tiles of one launch (over ``box``'s extents for K5)."""
    slot = cuda_emit.slot_map(prog.ana.domain_dims)
    return nm * math.prod(
        -(-((box[d][1] - box[d][0]) if box else prog.sizes[d])
          // spec.tile[s_]) for d, s_ in slot.items())


def bind(spec, tmp_path, entry, argtypes):
    fn = getattr(ctypes.CDLL(str(tmp_path / f"{spec.name}.so")),
                 spec.name + entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check_flat_arm(name, eb, tmp_path):
    import torch
    ctx = flat_ctx(name, eb, sizes=SIZES)
    with_pads(ctx, 29)
    prog = ctx._program
    spec = cuda_emit.emit(prog)
    assert spec.flat["code"] == "flat_engaged"
    fn = emulated_kernel(spec, tmp_path)
    state = ctx._state
    ins = [state[n][s] for n, s in spec.inputs]
    want = fused_stencil.plain_chunk(prog, state, 0, 1)
    assert tiles(prog, spec) >= 2 ** len(prog.ana.domain_dims)
    for nres in (1, 2, tiles(prog, spec)):
        outs = fresh_outputs(prog, spec, state)
        assert fused_stencil.call_entry(fn, prog, spec, ins, outs, 0,
                                        None, nres=nres) == 0
        for n, a in zip(spec.outputs, outs):
            torch.testing.assert_close(a, want[n][-1], **tol(name, eb))
    # K5: a box inside the domain, outputs zeroed as its wrapper makes them
    box = inner_box(prog, spec)
    fused_stencil.check_box(prog, spec, box)
    rfn = bind(spec, tmp_path, "_region", fused_stencil.region_argtypes(True))
    outs = [state[n][0].clone() if n in spec.base_outputs
            else torch.zeros_like(state[n][0]) for n in spec.outputs]
    assert fused_stencil.call_region_entry(rfn, prog, spec, ins, outs, box,
                                           {}, 0, None, nres=2) == 0
    want = fused_stencil.plain_shard_chunk(
        fused_stencil._with_offset(prog, {}, torch.device("cpu")), state,
        0, box, spec.base_outputs)
    for n, a in zip(spec.outputs, outs):
        torch.testing.assert_close(a, want[n][-1], **tol(name, eb))
    # K7: 3 members, a padded stride apart
    nm = 3
    stack = stacked(ctx, nm, 31)
    bfn = bind(spec, tmp_path, "_batched",
               fused_stencil.batched_argtypes(True))
    outs = [padded(o, 3) for o in fresh_outputs(prog, spec, stack, (nm,))]
    assert fused_stencil.call_batched_entry(
        bfn, prog, spec, [padded(stack[n][s], 5) for n, s in spec.inputs],
        outs, nm, 0, None, nres=2) == 0
    want = fused_stencil.plain_batched_chunk(prog, stack, 0, 1, nm)
    for n, a in zip(spec.outputs, outs):
        torch.testing.assert_close(a, want[n][-1], **tol(name, eb))


@pytest.mark.parametrize("name", FLAT_2D[:4])
def test_flat_arm_emulated_matches_plain(name, tmp_path):
    check_flat_arm(name, 4, tmp_path)
