"""K5 and K7 over K1's stream arm (``stream_step_kernel<S, false, true>``
and ``<S, true, false>``, the ``_stream_region`` and ``_stream_batched``
entries) as device code on the CPU: the g++ shim of
tests/test_torch_kernel_emulation.py (one thread per CUDA thread, a fixed
order between barriers, NaN-filled shared memory, each ``cp.async``
leaving its destination NaN until the issuing thread's wait), launched
through the wrappers' own marshalling on CPU tensors.

The cases are tests/test_torch_stream_k5k7_host.py's: iso3dfd at r=2 and
r=8, fp32 and bf16, on shard (0, 0) of 2x2 shards (r=8: 2 in x; an inner
face and the global edge in each sharded dim, nonzero ghosts past the
inner faces),
the sub-steps of one group of 2 over their full boxes and a ragged box,
each walked in two segments, the last one partial; and member batches of
3 different states.  The arm is emitted at 4x32 plane tiles (128
threads a block: the emulation's cost is its threads), each source built
once for the module and shared by its box and batch cases.  Each box is
bit-equal to ``plain_shard_step`` inside it, every cell outside it stays
NaN, and no input is read past its allocation (the inputs sit in margins
of the shim's ``YT_STRAY`` words); every member is bit-equal to
``plain_batched_chunk``'s.  Three deliberately broken copies fail those
checks: the ring copies' zero bound taken at the box itself (as if zero
pads lay past it, which holds for the single domain but not past a
box's edge), the single-domain arm's pad pass left in the region arm,
and the ring copies' member stride dropped.
"""

import ctypes
import re

import pytest

from test_torch_kernel_emulation import emulated_kernel
from test_torch_stream_bf16_arms import margined as margined_bf16
from test_torch_k5_stream_emulation import margined as margined_fp32
from test_torch_stream_k5k7_host import (BATCH, REGION, batch_case,
                                         batch_steps, region_steps,
                                         shard_case)
from yask_tpu_torch.ops import fused_stencil

#: the plane tile the arm is emitted at here
TILES = ((4, 32),)

#: built libraries of the module: (source name, edit) -> the .so's path
_BUILT = {}


def library(spec, tmp_path_factory, edit=None, tag=""):
    """The emulated library of ``spec`` (its header text edited by
    ``edit``, under ``tag``), built once for the module."""
    key = (spec.name, tag)
    if key not in _BUILT:
        tmp = tmp_path_factory.mktemp(f"emu{len(_BUILT)}")
        emulated_kernel(spec, tmp, edit=edit)
        _BUILT[key] = tmp / f"{spec.name}.so"
    return _BUILT[key]


def entry(so, spec, which):
    """Entry ``_stream_region`` or ``_stream_batched`` of the library, with
    the shim's stray-read counter beside it."""
    lib = ctypes.CDLL(str(so))
    fn = getattr(lib, spec.name + which)
    fn.argtypes = (fused_stencil.region_stream_argtypes()
                   if which == "_stream_region"
                   else fused_stencil.batched_stream_argtypes())
    fn.restype = ctypes.c_int
    lib.yt_stray_reads.restype = ctypes.c_longlong
    fn._yt_strays = lib.yt_stray_reads
    return fn


def run_region(case, so_of, which=slice(None)):
    kern, spec, off, boxes = shard_case(case, TILES)
    assert kern.skew_dims == ["x"]
    assert min(b["x"][1] - b["x"][0] for b in boxes) >= 12
    fn = entry(so_of(spec), spec, "_stream_region")
    wrap = margined_bf16 if REGION[case][1] == 2 else margined_fp32
    region_steps(fn, kern, spec, off, boxes[which], wrap=wrap,
                 strays=fn._yt_strays)


def run_batch(case, so_of):
    ctx, spec = batch_case(case, TILES)
    fn = entry(so_of(spec), spec, "_stream_batched")
    batch_steps(fn, ctx._program, spec)


@pytest.mark.parametrize("case", list(REGION))
def test_k5_over_the_stream_arm_matches_plain_when_emulated(
        case, tmp_path_factory):
    run_region(case, lambda spec: library(spec, tmp_path_factory))


@pytest.mark.parametrize("case", ["r2_fp32", "r8_bf16"])
def test_k7_over_the_stream_arm_matches_plain_when_emulated(
        case, tmp_path_factory):
    assert case in BATCH
    run_batch(case, lambda spec: library(spec, tmp_path_factory))


def _edit(pattern, repl, count):
    def edit(fn, text):
        if fn != "stream_step.cuh":
            return text
        text, n = re.subn(pattern, repl, text)
        if n != count:      # not an AssertionError: the edit itself failed
            raise RuntimeError(f"{pattern}: {n} matches, not {count}")
        return text
    return edit


#: the deliberately broken copies: (header edit, a runner)
MUTATIONS = {
    # the ring copies' zero bound at the box itself: past it the grown
    # box reads the ghosts exchanged from its neighbours
    "zero_bound_at_the_box": (
        _edit(r"(p\.n\[\d\]) \+ S::halo_hi\d\(k\)", r"\1", 3),
        lambda so_of: run_region("r2_fp32", so_of, slice(0, 1))),
    # the single-domain arm's pad pass left in the region arm
    "pad_pass_in_the_region_arm": (
        _edit(r"if constexpr \(!REGION\) \{\n(\s+const long long nb)",
              r"if constexpr (true) {\n\1", 1),
        lambda so_of: run_region("r2_fp32", so_of, slice(1, 2))),
    # one input's member stride dropped: every member reads member 0's
    # rings
    "member_stride_dropped": (
        _edit(r"\(BATCH \? idx_t\(m\) \* p\.in_ms\[a\] : 0\)", "0", 1),
        lambda so_of: run_batch("r2_fp32", so_of))}


@pytest.mark.parametrize("mutation", list(MUTATIONS))
def test_k5_k7_stream_emulation_fails_when_broken(mutation,
                                                  tmp_path_factory):
    edit, run = MUTATIONS[mutation]
    with pytest.raises(AssertionError):
        run(lambda spec: library(spec, tmp_path_factory, edit=edit,
                                 tag=mutation))
