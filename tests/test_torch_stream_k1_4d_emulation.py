"""K1's stream arm past three domain dims as device code on the CPU: the
solo and K7 entries of test_4d (``stream_step_kernel<S, false, false>``
and ``<S, true, false>`` with ``NOUTER = 1``) through the g++ shim of
tests/test_torch_kernel_emulation.py (one thread per CUDA thread, a fixed
order between barriers, NaN-filled shared memory, each ``cp.async``
leaving its destination NaN until the issuing thread's wait), launched
through the wrappers' own marshalling on CPU tensors.

The cases are tests/test_torch_stream_k1_4d_host.py's: test_4d at
element sizes 4, 8 and 2 (bfloat16 with an odd minor pad, so each ring
row starts at the second element of a pair), 3 outer cells (the reads at
w - 2 reach the interior from the last one), slot 0 of 12 planes walked
in two segments (7 and 5: each ring of 8 planes wraps), plane tiles of
4x32 (128 threads a block: the emulation's cost is its threads) with
partial blocks in both plane slots; solo for 2 steps, and 2 members of
different states for one.  Each output is bit-equal to ``plain_chunk``'s or
``plain_batched_chunk``'s, pads included (so every cell was written),
and no input is read past its allocation (the inputs sit in margins of
the shim's ``YT_STRAY`` words).  Three deliberately broken copies fail
those checks: the outer cell's offset dropped from the ring copies' base
(every outer cell reads outer cell 0's planes), the outer cell dropped
from the store (every outer cell stores into outer cell 0) and the pad
pass stopping before the outer slots' pads.
"""

import ctypes
import re

import pytest

from test_torch_kernel_emulation import emulated_kernel
from test_torch_stream_bf16_arms import margined as margined_bf16
from test_torch_k5_stream_emulation import margined as margined_fp32
from test_torch_stream_k1_4d_host import (batch_steps, bind, ctx_4d,
                                          emitted, solo_steps)

#: the plane tile the arm is emitted at here
TILES = ((4, 32),)
#: element bytes -> sizes: 3 outer cells, 12 planes of slot 0, partial
#: plane blocks in y and z
SIZES = {4: "-g_w 3 -g_x 12 -g_y 6 -g_z 40",
         8: "-g_w 3 -g_x 12 -g_y 6 -g_z 40",
         2: "-g_w 3 -g_x 12 -g_y 6 -g_z 40 -mp_z 1"}

#: built libraries of the module: (source name, tag) -> the .so's path
_BUILT = {}


def margined(a):
    """``a`` as a view into a tensor whose margins hold the shim's
    ``YT_STRAY`` words (float64: two words a cell)."""
    import torch
    if a.dtype == torch.bfloat16:
        return margined_bf16(a)
    if a.dtype == torch.float32:
        return margined_fp32(a)
    m = 4
    big = torch.full(tuple(n + 2 * m for n in a.shape) + (2,), 0x7FBADBAD,
                     dtype=torch.int32).view(torch.float64)[..., 0]
    view = big[tuple(slice(m, m + n) for n in a.shape)]
    view.copy_(a)
    return view


def case(eb):
    ctx = ctx_4d(eb, f"{SIZES[eb]} -mode fused")
    prog = ctx._program
    spec = emitted(prog, TILES)
    assert spec.stream.tile == TILES[0]
    return prog, spec


def entry(spec, tmp_path_factory, which, edit=None, tag=""):
    """Entry ``which`` of the emulated library of ``spec`` (its headers
    edited by ``edit``, under ``tag``), built once for the module, with
    the shim's stray-read counter beside it."""
    key = (spec.name, tag)
    if key not in _BUILT:
        tmp = tmp_path_factory.mktemp(f"emu{len(_BUILT)}")
        emulated_kernel(spec, tmp, edit=edit)
        _BUILT[key] = tmp / f"{spec.name}.so"
    lib = ctypes.CDLL(str(_BUILT[key]))
    fn = bind(lib, spec, which)
    lib.yt_stray_reads.restype = ctypes.c_longlong
    fn._yt_strays = lib.yt_stray_reads
    return fn


def run(eb, which, so_of):
    prog, spec = case(eb)
    fn = so_of(spec, which)
    if which.endswith("_batched"):
        batch_steps(fn, prog, spec, wrap=margined, strays=fn._yt_strays,
                    nm=2, steps=1)
    else:
        solo_steps(fn, prog, spec, wrap=margined, strays=fn._yt_strays)


@pytest.mark.parametrize("eb", [4, 8, 2])
@pytest.mark.parametrize("which", ["_stream", "_stream_batched"])
def test_the_4d_stream_arm_matches_plain_when_emulated(which, eb,
                                                       tmp_path_factory):
    run(eb, which, lambda spec, w: entry(spec, tmp_path_factory, w))


def _edit(header, pattern, repl, count):
    def edit(fn, text):
        if fn != header:
            return text
        text, n = re.subn(pattern, repl, text)
        if n != count:      # not an AssertionError: the edit itself failed
            raise RuntimeError(f"{pattern}: {n} matches, not {count}")
        return text
    return edit


#: the deliberately broken copies: (header edit, the entry it breaks)
MUTATIONS = {
    # the ring copies read outer cell 0's planes in every outer cell
    "outer_offset_dropped_from_the_ring_base": (
        _edit("stream_step.cuh",
              r"\n\s+\+ cell_base<S>\(p\.n, 0, oc, 0, p\.in_s\[a\]\)", "",
              1), "_stream"),
    # every outer cell stores into outer cell 0
    "outer_cell_dropped_from_the_store": (
        _edit("stream_step.cuh",
              r"store<S, REGION>\(p, m, oc, z, g1, g2, out\);",
              "store<S, REGION>(p, m, 0, z, g1, g2, out);", 1), "_stream"),
    # the pad pass stops at the three plane slots' slabs
    "pad_pass_skips_the_outer_pads": (
        _edit("fused_step.cuh", r"j < 2 \* NS;", "j < 6;", 1), "_stream")}


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_4d_stream_emulation_fails_when_broken(mutation, tmp_path_factory):
    edit, which = MUTATIONS[mutation]
    with pytest.raises(AssertionError):
        run(4, which, lambda spec, w: entry(spec, tmp_path_factory, w,
                                            edit=edit, tag=mutation))
