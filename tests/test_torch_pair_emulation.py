"""The device code of K1's stream arm at element size 2 run on the CPU: two
minor-dim points a thread in packed bfloat16x2 arithmetic, the rings
filled with 16-byte ``cp.async`` units from the unit holding each row's
first cell.

The shim of tests/test_torch_kernel_emulation.py runs each block with one
thread per CUDA thread in a fixed order between barriers, over NaN-filled
shared memory, each ``cp.async`` leaving its destination NaN until the
issuing thread's wait and a misaligned one never completing; inputs sit
in margins of ``YT_STRAY`` words, whose reads it counts.  The plane tile
is 4x16 (32 threads of lane pairs), slot 0 walks in two segments, the
minor extent is odd and the last tile of each plane slot partial.
Tolerance: none, whole tensors (pads included) against the plain
versions.

* Every input placed at each of the 8 cells of a 16-byte unit, so the
  rows start at each of the 8 row shifts: solo, K7 x3 and K5 boxes
  (those of a 2x2 shard layout, and boxes at an odd minor origin with an
  odd minor extent).
* Three deliberately broken copies of the header fail: lane 1 stored
  unmasked (a box's odd minor edge writes outside the box), the row
  shift dropped from the reader (wrong cells at every nonzero shift),
  and a 16-byte unit across the read reach copied whole (it reads past
  an input's allocation).
"""

import ctypes

import pytest

import yask_tpu_torch
from yask_tpu_torch.ops import fused_stencil

from test_torch_k5_host import ragged
from test_torch_kernel_emulation import emulated_kernel
from test_torch_pair_host import odd_boxes
from test_torch_stream_k1_4d_host import batch_steps, solo_steps
from test_torch_stream_k5k7_host import emitted, new_ctx, region_steps

#: the pair tile of the emulation (32 threads)
TILE = ((4, 16),)
#: margin cells around each input, beside its shift
MARGIN = 40

_LIBS = {}


def margined(a, shift: int):
    """bfloat16 ``a`` as a view into a buffer whose margins hold the
    shim's ``YT_STRAY`` word in every aligned 4-byte pair, its first
    element ``MARGIN + shift`` cells past a 16-byte boundary, its strides
    ``a``'s (contiguous)."""
    import torch
    n = a.numel()
    big = torch.empty(n + 2 * MARGIN + 16, dtype=torch.int16)
    big[0::2] = 0xDBAD - 0x10000
    big[1::2] = 0x7FBA
    base = big.view(torch.bfloat16)
    assert base.data_ptr() % 16 == 0
    view = base.as_strided(a.shape, a.stride(), MARGIN + shift)
    view.copy_(a)
    return view


def device_entry(spec, tmp_path, entry, edit=None, key=""):
    """The emulated entry with the shim's stray-read counter
    (``fn._yt_strays``), built once per source and edit."""
    k = (spec.name, entry, key)
    if k not in _LIBS:
        fn = emulated_kernel(spec, tmp_path, entry=spec.name + entry,
                             edit=edit)
        fn.argtypes = {"_stream": fused_stencil.stream_argtypes,
                       "_stream_batched":
                       fused_stencil.batched_stream_argtypes,
                       "_stream_region":
                       fused_stencil.region_stream_argtypes}[entry]()
        lib = ctypes.CDLL(str(tmp_path / f"{spec.name}.so"))
        lib.yt_stray_reads.restype = ctypes.c_longlong
        fn._yt_strays = lib.yt_stray_reads
        _LIBS[k] = fn
    return _LIBS[k]


def solo_ctx():
    return new_ctx(yask_tpu_torch.yk_factory().new_env(device="cpu"),
                   "iso3dfd", 2, 2, "-g_x 14 -g_y 9 -g_z 37 -mode fused")


def row_shift(prog, spec, ins) -> int:
    """The row shift of the ring input's rows in this launch."""
    a = spec.tiled[0]
    h2 = spec.halos[a][2][0]
    ptr = fused_stencil._interior_ptr(ins[a], prog.geoms[spec.inputs[a][0]])
    return ((ptr >> 1) - h2) & 7


@pytest.mark.parametrize("shift", range(8))
@pytest.mark.parametrize("entry", ["_stream", "_stream_batched"])
def test_pairs_match_plain_at_every_row_shift(entry, shift, tmp_path):
    ctx = solo_ctx()
    prog = ctx._program
    spec = emitted(prog, TILE)
    fn = device_entry(spec, tmp_path, entry)
    (batch_steps if entry.endswith("_batched") else solo_steps)(
        fn, prog, spec, wrap=lambda a: margined(a, shift),
        strays=fn._yt_strays)
    # the placement moves the rows' shift through all 8
    ins = [margined(ctx._state[n][k], shift) for n, k in spec.inputs]
    assert row_shift(prog, spec, ins) == (row_shift(
        prog, spec, [ctx._state[n][k] for n, k in spec.inputs]) + shift) % 8


def shard():
    from yask_tpu_torch.parallel.shard_step import _full_box, \
        shard_pallas_plan
    ctx = new_ctx(yask_tpu_torch.yk_factory().new_env(devices=["cpu"] * 4),
                  "3axis", 1, 2, "-g_x 24 -g_y 18 -g_z 37 -nr_x 2 -nr_y 2 "
                  "-mode shard_pallas -wf_steps 2")
    sp = shard_pallas_plan(ctx)
    kern = sp.kernel
    prog = kern.program
    off = sp.layout.offsets[sp.layout.mesh.index(
        {d: 0 for d in prog.ana.domain_dims})]
    boxes = [_full_box(sp, 2, s) for s in range(2)]
    boxes.append(ragged(boxes[0], prog.sizes))
    boxes += odd_boxes(boxes[:1], prog.sizes, prog.ana.domain_dims[-1])
    return kern, emitted(prog, TILE), off, boxes


@pytest.mark.parametrize("shift", [0, 3, 6])
def test_region_pairs_match_plain_shard_step(shift, tmp_path):
    kern, spec, off, boxes = shard()
    fn = device_entry(spec, tmp_path, "_stream_region")
    region_steps(fn, kern, spec, off, boxes,
                 wrap=lambda a: margined(a, shift), strays=fn._yt_strays)


# ---------------------------------------------------------------------------
# deliberately broken copies
# ---------------------------------------------------------------------------


def edit_of(old: str, new: str):
    def edit(name, text):
        if name != "stream_step.cuh":
            return text
        assert old in text, old
        return text.replace(old, new)
    return edit


UNMASKED_LANE1 = edit_of("      if (s1) d[s2] = out[o].y;",
                         "      d[s2] = out[o].y;")
NO_READER_SHIFT = edit_of(
    "        const int b = l2 + S::halo_lo2(k)\n"
    "                      + unit_shift<S>(p, S::tiled_input(k), lo2);",
    "        const int b = l2 + S::halo_lo2(k);")
WHOLE_EDGE_UNITS = edit_of(
    "      } else if (c2 >= lo2 && c2 + V <= lim2) {",
    "      } else if (true) {")


def test_fails_with_lane_1_stored_unmasked(tmp_path):
    """Lane 1 past a box's odd minor edge stores outside the box."""
    kern, spec, off, boxes = shard()
    fn = device_entry(spec, tmp_path, "_stream_region", UNMASKED_LANE1,
                      "unmasked")
    with pytest.raises(AssertionError, match="outside the box"):
        region_steps(fn, kern, spec, off, boxes)


def test_fails_with_the_row_shift_dropped_from_the_reader(tmp_path):
    ctx = solo_ctx()
    prog = ctx._program
    spec = emitted(prog, TILE)
    fn = device_entry(spec, tmp_path, "_stream", NO_READER_SHIFT, "noshift")
    solo_steps(fn, prog, spec, wrap=lambda a: margined(a, 0))
    with pytest.raises(AssertionError):
        solo_steps(fn, prog, spec, wrap=lambda a: margined(a, 3))


def test_fails_with_edge_units_copied_whole(tmp_path):
    ctx = solo_ctx()
    prog = ctx._program
    spec = emitted(prog, TILE)
    fn = device_entry(spec, tmp_path, "_stream", WHOLE_EDGE_UNITS, "whole")
    with pytest.raises(AssertionError, match="past its allocation"):
        solo_steps(fn, prog, spec, wrap=lambda a: margined(a, 5),
                   strays=fn._yt_strays)
