"""K1 on Hopper: the fused stencil chunk as a hand-written CUDA kernel.

Replaces ``build_pallas_chunk``'s Pallas kernel
(``yask_tpu/ops/pallas_stencil.py:565``, its one ``pl.pallas_call`` at
:2312): K fused steps of a whole solution per tile, with a global-domain
mask, rotating rings and fresh padded outputs.  Its DMA pipelines (K2) and
skewed-wavefront carry (K3) change only the TPU's schedule, so this
function is what all three compute; K1's arm (``fused_step``) records
``pipeline_dmas: False`` and ``skew_dims: []``.

What bounds it on an H100: bytes.  iso3dfd r=8 does about 61 FLOP per
point and must move 16 B per point per step at fp32 (pressure t and t-1
and vel read once, pressure t+1 written once): 0.64 ms per step at 512³
against 3.35 TB/s, while the FLOPs take 0.12 ms at 67 TFLOP/s.  The
design's answer in this first cut: each block stages the halo tile of
every var read at a spatial offset in shared memory once (184 KB for
8×8×64 points of r=8 pressure; 16 loads in flight per thread), so the 49
reads of a point hit shared memory and the halo re-reads of neighbouring
tiles go to the 50 MB L2; the other inputs go through the read-only path.
One block per SM then alternates staging and compute, which is what keeps
it far from the bound (PERF.md has the measured times).  A chunk of
K steps is K launches of the one-sub-step kernel with the rings rotated
between launches, so the K-fold temporal saving Pallas gets is not taken
yet: at r=8 a 3-D tile with a 2·r·K margin does not fit 227 KB of shared
memory.  In-launch temporal fusion is the first redesign on the roadmap.
Each launch also zero-fills a fresh output (4 B per point), which keeps
pads zero and never lets a launch write what it reads.

Beside the kernel: :func:`plain_chunk`, the plain PyTorch version (K
calls of ``StepProgram.step`` on tensors plus the pad re-zeroing), which
the wrapper takes for CPU tensors only, and :func:`fused_step`'s plain
integer launch counter ``fused_step.launches``.

K7 on Hopper, the member-batched kernel: replaces the ``jax.vmap`` of
``build_pallas_chunk`` in ``EnsembleRun._batched_chunk_fn``
(``yask_tpu/runtime/ensemble.py:234-345``), which vmaps whatever
``build_pallas_chunk`` returns.  Every emitted source (K1's and K6's) carries a C
entry point ``<name>_batched`` that runs the same tile machinery over N
members of one contiguous (N, *shape) stack per ring slot: one launch per
step for all members, the member folded into the grid's z cells beside
the outer cells and the slot-0 blocks.  So K7 takes every arm K1 and K6
take: several stages, scratch sub-stages, rewrites, misc slices,
partial-dim writes, element size 2 and outer dims.  Bound by bytes like
its body (N × 16 B/pt per iso3dfd r=8 step, N × 48 on tti r=2).
:func:`batched_step` (K1's body) and :func:`batched_stages_step` (K6's)
are its wrappers, each with its own counter; :func:`plain_batched_chunk`
(``plain_chunk`` on each member's view) is their plain version.  A
member batch never pushes, as the reference's vmapped chunk is built
with ``push=False``: the context gives it a push-off kernel.

K1's and K6's workspace arm: where the tiles fit no rung of the
emitter's shared-memory ladder (tti, ssg and the fsg family at r=8), the
emitted source is K6's body (one sub-stage or several) with the tiles
past shared memory in a device-memory workspace, one slice of
``spec.workspace["ws_elems"]`` elements per block the card holds at once
(:meth:`FusedKernel.workspace`, the count from the ``<name>_resident``
entry); a launch runs that many blocks, each walking tiles.  The same
wrappers launch it (its entries take the workspace before the stream),
and K7 and K5 take it as they take K6's body.

K6's flat arm: on a solution that leaves slot 0 unused (the 1-D and 2-D
solutions K6 carries: gaussian, box, the SWE, ...), the emitted source is
K6's body with wide tiles served by fewer threads, the card's resident
blocks walking the tiles and the next tile's staged inputs copied with
``cp.async`` while the current one computes.  Its solo and batch
launches write every cell of their outputs (the pads with 0), so
:func:`copy_base` hands them ``torch.empty`` outputs (a partial-dim
output, whose slab the kernel stores, stays zeroed; K5 keeps its
allocation rules).  The same wrappers launch it through the workspace
arm's entries, with no workspace: :meth:`FusedKernel.workspace` asks the
``<name>_resident`` entry once per launch kind and passes the count,
which :meth:`FusedKernel.tiling` reports, to every launch.

K6 on Hopper, the multi-stage push-memory kernel: replaces the ``push=``
arm of ``build_pallas_chunk`` and its stage loop (pallas_stencil.py:495-563,
:995-1058, :1859-1871, :2058-2188), with its scratch arm (``_TileEval``'s
scratch chains, :175-179, :2003, :2105-2147) and its rewrite arm
(:2155-2187).  A solution with several stages (the merged RTM chain of
:mod:`yask_tpu_torch.ops.pipeline`, AWP, the SWE) or with scratch vars
(TTI) gets one launch per step that computes every stage of a block,
each over the block expanded by what the later stages read, a scratch
var over the block grown by its write halo, keeping the intermediates in
shared memory; a pushed var has no output, and its ring keeps its stale
input tensors (pallas_stencil.py:2335-2371).  Bound by bytes: the pure RTM
chain moves 20 B per point per step with the image pushed.
:func:`stages_step` is its wrapper with its own counter
``stages_step.launches``; the plain version is :func:`plain_chunk`, which
evaluates every stage.

K5 on Hopper, the per-shard region kernel of the ``shard_pallas`` path
(``yask_tpu_torch/parallel/shard_step.py``): replaces the ``region=`` and
``distributed=True`` arms of ``build_pallas_chunk`` (pallas_stencil.py:
736-811, :1948-1953), which the reference builds with every arm of the
single-domain chunk.  Every emitted source (K1's and K6's) carries a C
entry point ``<name>_region`` that computes one sub-step over a compute
box of one shard, in its local coordinates, on the source's body: K1's
for a single-stage solution, K6's (every stage, scratch sub-stage and
rewrite, push off as the reference's distributed chunk) otherwise, with
misc slices, partial-dim outputs, element size 2 and outer dims alike.
The point function sees global coordinates (the shard's origin added)
and the global extents, a cell outside the global domain is 0, and a
scratch sub-stage clips at the global domain grown by its write halo.
:func:`shard_step` is its wrapper with its own counter
``shard_step.launches``; :func:`plain_shard_chunk` (the shard's
``StepProgram`` evaluated stage by stage, each stage over the box grown
by the later stages' ghost widths, :func:`stage_boxes`, masked to the
global domain; per sub-step :func:`plain_shard_step`) is its plain
version.  Bound by bytes as its body: each input read once over the box
grown by its reach and clipped to the global domain, each output written
once over the box.

K1's stream arm (``-skew``), the port's design for K2 and K3: the same
emitted source carries a fourth C entry point (``<name>_stream``,
``csrc/stream_step.cuh``) that computes K1's sub-step with each block
walking slot 0 through a ring of staged planes: the planes already staged
are carried to the next output plane (K3's carry, one level), and
``cp.async`` fetches the plane ``P`` ahead under the current plane's
compute (K2's prefetch).  It writes every cell of its outputs, pads
included, so they come from ``torch.empty``.  At element size 2 a
thread computes two adjacent minor-dim points in packed bfloat16x2
arithmetic over rings of 16-byte rows, so the staged inputs' strides
must be multiples of 8 cells (:func:`check_pair_strides` with
:data:`PAIR_UNIT`; the context pads the minor extent to match).
:func:`stream_step` is its wrapper with its own counter
``stream_step.launches``; the plain version is :func:`plain_chunk`.
:func:`cuda_emit.skew_engaged_dims` selects the arm and says why; ``-no-skew`` keeps K1.  K7 and K5 over it: the source's
``<name>_stream_batched`` (the member a coordinate of the grid beside the
segments, :func:`call_batched_stream_entry`) and ``<name>_stream_region``
(the walk over a shard's box, :func:`call_region_stream_entry`), which
:func:`batched_step` and :func:`shard_step` launch where the arm engages
(the batch at its members' segment length,
:meth:`FusedKernel.batch_segment`; each box at its own,
:meth:`FusedKernel.region_segment`), counted in their
``stream_launches``.  The batch's outputs come from ``torch.empty`` (its
pad pass zeroes every member's pads); the box's keep what
:func:`copy_base` or the caller gave them outside the box.  Their plain
versions are :func:`plain_batched_chunk` and :func:`plain_shard_step`.
Past three domain dims the arm and K7 over it take a single-stage
solution too: each outer cell is a coordinate of the work items, each
input read at an outer offset its own table entry (as on K1's body), and
the pad pass covers every slot's pads; K5 keeps its body there.

K6's stream arm (``-skew``, on a 3-D solution of K6's body without misc
or partial-dim outputs, at element size 2, 4 or 8, scratch vars
included; at 2 its rings are filled with 4-byte pairs, so its wrappers
check the strides as :func:`stream_step` does, :func:`check_pair_strides`):
the source carries ``<name>_stages_stream`` and
``_stages_stream_batched`` (``csrc/stream_stages.cuh``), which compute
K6's and K7's sub-step with each block walking slot 0 of a plane tile,
every sub-stage at its lag, through rings of staged input planes fed by
``cp.async`` and of computed planes.  :func:`stages_step` and
:func:`batched_stages_step` launch them where
:func:`cuda_emit.skew_engaged_dims` engages the arm, counted in their
``stream_launches``; the outputs come from ``torch.empty``, and the
card's resident blocks walk the work items
(:meth:`FusedKernel.stream_resident`).  Where the rings fit no plane
tile's shared memory (the workspace arm's solutions), the computed rings
past it live in a workspace slice per resident block
(:meth:`FusedKernel.stream_workspace`, at most as many blocks as keep the
slices within the card's L2) and the staged inputs without a ring are
read from their own allocations.  ``-no-skew`` keeps K6's body.

K5 over K6's stream arm (``-skew`` under ``-mode shard_pallas``): the
source's ``<name>_stages_stream_region`` entry walks one shard's box
(K5's box table after K6's tables, :func:`call_region_stages_stream_entry`)
at global coordinates, each sub-stage's plain region clipped at the
global domain and kept to the box grown by its region, the ring copies
bounded by the shard's allocation, only the box's cells stored and no
pad written, so it keeps :func:`copy_base`'s outputs and the shared
outputs of an overlapped group's core and shells.  :func:`shard_step`
launches it where a kernel built with ``region=True`` engages the arm,
at each box's segment length (:meth:`FusedKernel.region_segment`: the
plan's rule at the box's extents), counted in
``shard_step.stream_launches``; its plain version is
:func:`plain_shard_step`.  ``-no-skew`` keeps K5 over the bodies.

The A3 arms (ROADMAP.md A3: misc dims, partial-dim writes, element size
2, more than three domain dims) live in the emitted ``Spec`` and the
headers; here a misc slice of an input or output, and an input at an
outer offset, is a table entry of its own (``_arg_tables``; the outer
dims take slots past the three, each with its stride and extent), a var
whose misc slices are not all written starts from a copy of its evicted
slot (:func:`copy_base`, counted in ``copy_base.launches``), at element
size 2 the stream arm checks the strides its pair copies need
(:func:`check_pair_strides`), and the launch code walks z cells past
CUDA's limit in several launches (:func:`grid_z`).  K4 takes them all,
its outer dims as window dims of its geometry.

K4 on Hopper, the trapezoid/diamond two-phase tiling of one K-step group
(``-trapezoid``): the port's one kernel that advances K time levels
inside one launch, each level running every stage and scratch sub-stage
of K6, with misc slices, element size 2 and outer dims (more than three
domain dims: uniform window dims with K·r margins).  :class:`TrapezoidKernel`
holds the spec ``cuda_emit.resolve_trapezoid`` returns;
:func:`trapezoid_chunk` is its wrapper (one phase-1 launch, then one
diamond launch per trapezoid dim, counted in
``trapezoid_chunk.phase1_launches`` and
``trapezoid_chunk.diamond_launches``), :func:`batched_trapezoid_chunk`
its member batch (K7 over K4, its own counters); level buffers that do
not fit shared memory live in a workspace of the card's resident blocks
(:meth:`TrapezoidKernel.workspace`).  Its plain versions are
:func:`plain_chunk` and :func:`plain_batched_chunk` over the K steps.

K4's stream arm (``-trapezoid`` with ``-skew``, the default, on a
solution of three domain dims or more that K6's stream arm takes): where ``cuda_emit.resolve_trapezoid``
returns a spec of ``cuda_emit.emit_trap_stream`` (``trap["arm"]`` is
``"stream"``, :attr:`TrapezoidKernel.stream`), one K-step group is one
launch of ``<name>_trap_stream`` (K7: ``_trap_stream_batched``), K6's
stream arm over the sub-stages of all K levels, each level lagged along
slot 0 by what the later levels read of it; :func:`trapezoid_chunk` and
:func:`batched_trapezoid_chunk` count it in their ``stream_launches``.
The entries take K6's stream-arm arguments
(:func:`call_stages_stream_entry`, :func:`call_batched_stages_stream_entry`),
the card's resident blocks walk the work items, and the outputs come from
``torch.empty`` (the kernel writes every cell, pads included).  Bound by
bytes as the two-phase passes (iso3dfd r=2 at K=4: 5 B per point per
step); the levels' in-plane growth is the recompute it pays instead of
the diamonds.  ``-no-skew`` keeps the two-phase passes.

Past three domain dims K6's stream arm is its own struct beside the body
in the same source (``spec.stream_spec``: each sub-stage once, the outer
dims windows of the work items), so :func:`stages_step` and
:func:`batched_stages_step` marshal its launches by that spec's inputs
and outputs; K5 over it is not emitted (the box keeps K6's body).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List

from yask_tpu_torch.utils.exceptions import YaskException
from yask_tpu_torch.ops import cuda_emit


def _zero_pads(program, name: str, a):
    """Zero everything outside the interior of one padded state tensor
    (the host-side lead-dim pad re-zeroing of the reference chunk,
    pallas_stencil.py:2345-2366, applied to every domain dim)."""
    g = program.geoms[name]
    for dn, kind in g.axes:
        if kind != "domain":
            continue
        ax = g.axis_of(dn)
        o = g.origin[dn]
        hi = o + program.sizes[dn]
        if o > 0:
            idx = [slice(None)] * a.ndim
            idx[ax] = slice(0, o)
            a[tuple(idx)] = 0
        if hi < a.shape[ax]:
            idx = [slice(None)] * a.ndim
            idx[ax] = slice(hi, a.shape[ax])
            a[tuple(idx)] = 0
    return a


def plain_chunk(program, state, t0: int, k: int):
    """The plain PyTorch version of one fused chunk: ``k`` steps of
    ``program.step`` (the port's ``torch`` mode) from step ``t0``, then
    the pads of the ring slots the chunk produced re-zeroed."""
    dirn = program.ana.step_dir
    for i in range(k):
        state = program.step(state, t0 + i * dirn)
    for name in {eq.lhs.var_name() for eq in program.ana.eqs} - {
            n for n, g in program.geoms.items() if g.is_scratch}:
        ring = state[name]
        for s in range(max(0, len(ring) - k), len(ring)):
            _zero_pads(program, name, ring[s])
    return state


def _interior_ptr(t, g, misc=(), outer=()) -> int:
    """Address of a state tensor's interior origin (pads skipped), in
    the misc slice ``misc`` (``((dim, index), ...)``) of a var with misc
    axes, shifted by ``outer`` (``((dim, offset), ...)``) in outer dims."""
    off = 0
    for ax, (dn, kind) in enumerate(g.axes):
        if kind == "domain":
            off += g.origin[dn] * t.stride(ax)
    for dn, v in misc:
        off += (v - g.misc_lo[dn]) * t.stride(g.axis_of(dn))
    for dn, o in outer:
        if o:
            off += o * t.stride(g.axis_of(dn))
    return t.data_ptr() + off * t.element_size()


def _slot_strides(t, g, dims) -> List[int]:
    """Element strides of a state tensor per kernel slot (0 where the var
    lacks the dim): three slots, then one per outer dim
    (``cuda_emit.slot_map``)."""
    slot = cuda_emit.slot_map(dims)
    out = [0] * max(3, len(slot))
    for d in dims:
        if d in g.domain_dims:
            out[slot[d]] = t.stride(g.axis_of(d))
    return out


def _arg_tables(program, spec, ins, outs):
    """The ctypes arguments both entry points share: interior-origin
    addresses and per-slot strides of the inputs and outputs, and the
    interior sizes per slot (outer slots after the three).  A misc slice
    (``spec.in_misc``, ``spec.out_slices``) and an input at an outer
    offset (``spec.in_outer``) are their tensor's own table entries."""
    dims = list(program.ana.domain_dims)
    slot = cuda_emit.slot_map(dims)
    ns = max(3, len(slot))
    outer_dims = sorted((d for d in dims if slot[d] >= 3), key=slot.get)

    def table(tensors, names, miscs, outers):
        ptrs = [_interior_ptr(a, program.geoms[n], m,
                              tuple(zip(outer_dims, o)))
                for a, n, m, o in zip(tensors, names, miscs, outers)]
        strides = [s for a, n in zip(tensors, names)
                   for s in _slot_strides(a, program.geoms[n], dims)]
        k = max(len(ptrs), 1)
        return ((ctypes.c_void_p * k)(*ptrs),
                (ctypes.c_longlong * (ns * k))(*strides))

    nin = len(spec.inputs)
    in_ptrs, in_s = table(ins, [n for n, _s in spec.inputs],
                          spec.in_misc or [()] * nin,
                          spec.in_outer or [()] * nin)
    slices = spec.out_slices or [(i, ()) for i in range(len(outs))]
    out_ptrs, out_s = table([outs[i] for i, _m in slices],
                            [spec.outputs[i] for i, _m in slices],
                            [m for _i, m in slices], [()] * len(slices))
    sizes = [1] * ns
    for d in dims:
        sizes[slot[d]] = program.sizes[d]
    return in_ptrs, in_s, out_ptrs, out_s, (ctypes.c_int * ns)(*sizes)


def _ws_args(spec, ws, nres) -> tuple:
    """The arguments of the workspace and flat arms' entries
    (``spec.walks``): the workspace tensor (None on the flat arm and the
    host path) and the resident blocks; none for the other kernels."""
    return (_ptr(ws), int(nres)) if spec.walks else ()


def call_entry(fn, program, spec, ins, outs, t: int, stream, ws=None,
               nres: int = 0) -> int:
    """Call an emitted kernel's C entry point: interior-origin addresses
    and per-slot strides of the input and output tensors, the interior
    sizes, the step index, for the workspace and flat arms
    (``spec.walks``) the workspace ``ws`` and ``nres`` resident blocks,
    and the stream.
    Returns its error code."""
    in_ptrs, in_s, out_ptrs, out_s, n3 = _arg_tables(program, spec, ins,
                                                     outs)
    return fn(ctypes.addressof(in_ptrs), ctypes.addressof(in_s),
              ctypes.addressof(out_ptrs), ctypes.addressof(out_s),
              ctypes.addressof(n3), int(t), *_ws_args(spec, ws, nres),
              stream)


def _member_strides(tensors):
    """The member stride (dim 0) of each (N, *shape) stack, as the K7
    entries take them."""
    return (ctypes.c_longlong * max(len(tensors), 1))(
        *[a.stride(0) for a in tensors])


def call_batched_entry(fn, program, spec, ins, outs, nm: int, t: int,
                       stream, ws=None, nres: int = 0) -> int:
    """Call an emitted kernel's K7 entry point on (N, *shape) stacks:
    member 0's tables (as :func:`call_entry` passes them), the member
    strides (one per table entry: a misc slice of an output takes its
    tensor's), the member count, the step index, the workspace (as
    :func:`call_entry`) and the stream."""
    in_ptrs, in_s, out_ptrs, out_s, n3 = _arg_tables(
        program, spec, [a[0] for a in ins], [o[0] for o in outs])
    slices = spec.out_slices or [(i, ()) for i in range(len(outs))]
    in_ms = _member_strides(ins)
    out_ms = _member_strides([outs[i] for i, _m in slices])
    return fn(ctypes.addressof(in_ptrs), ctypes.addressof(in_s),
              ctypes.addressof(in_ms), ctypes.addressof(out_ptrs),
              ctypes.addressof(out_s), ctypes.addressof(out_ms),
              ctypes.addressof(n3), int(nm), int(t),
              *_ws_args(spec, ws, nres), stream)


def _region_table(program, box, off) -> List[int]:
    """K5's int[4·(3 + outer dims)]: the box's lo and hi, the shard's
    origin and the global extents, per kernel slot (outer slots after the
    three; unused slots: [0, 1), 0, 1)."""
    slot = cuda_emit.slot_map(program.ana.domain_dims)
    ns = max(3, len(slot))
    lo, hi, o, gn = [0] * ns, [1] * ns, [0] * ns, [1] * ns
    for d, s in slot.items():
        lo[s], hi[s] = (int(x) for x in box[d])
        o[s] = int(off.get(d, 0))
        gn[s] = int(program.global_last[d]) + 1
    return lo + hi + o + gn


def call_region_entry(fn, program, spec, ins, outs, box, off, t: int,
                      stream, ws=None, nres: int = 0) -> int:
    """Call an emitted kernel's K5 entry point (over K1's body or K6's):
    K1's tables, then the box ``{dim: (lo, hi)}`` in local interior
    coordinates, the shard's global origin ``{dim: offset}`` and the
    global extents (from ``program``'s ``global_last``), the step, the
    workspace (as :func:`call_entry`) and the stream.  Returns its error
    code."""
    in_ptrs, in_s, out_ptrs, out_s, n3 = _arg_tables(program, spec, ins,
                                                     outs)
    tab = _region_table(program, box, off)
    reg = (ctypes.c_int * len(tab))(*tab)
    return fn(ctypes.addressof(in_ptrs), ctypes.addressof(in_s),
              ctypes.addressof(out_ptrs), ctypes.addressof(out_s),
              ctypes.addressof(n3), ctypes.addressof(reg), int(t),
              *_ws_args(spec, ws, nres), stream)


def _stream_table(program, spec, seg: int) -> List[int]:
    """The stream entry's int[1 + 2·NS·NOUT]: the segment length, then each
    output's pads (lo, hi) per kernel slot (NS slots: three, then one per
    outer dim)."""
    dims = list(program.ana.domain_dims)
    slot = cuda_emit.slot_map(dims)
    tab = [int(seg)]
    for name in spec.outputs:
        pads = [(0, 0)] * max(3, len(slot))
        for d, s in slot.items():
            pads[s] = program.geoms[name].pads[d]
        tab += [int(x) for lo_hi in pads for x in lo_hi]
    return tab


def call_stream_entry(fn, program, spec, ins, outs, t: int, stream,
                      seg: int = None) -> int:
    """Call an emitted kernel's stream entry point: K1's tables, then the
    segment length (``seg``, the plan's by default) and the outputs' pads,
    the step index and the stream.  Returns its error code."""
    in_ptrs, in_s, out_ptrs, out_s, n3 = _arg_tables(program, spec, ins,
                                                     outs)
    tab = _stream_table(program, spec,
                        spec.stream.seg if seg is None else seg)
    geo = (ctypes.c_int * len(tab))(*tab)
    return fn(ctypes.addressof(in_ptrs), ctypes.addressof(in_s),
              ctypes.addressof(out_ptrs), ctypes.addressof(out_s),
              ctypes.addressof(n3), ctypes.addressof(geo), int(t), stream)


def call_batched_stream_entry(fn, program, spec, ins, outs, nm: int,
                              t: int, stream, seg: int) -> int:
    """Call K7's entry over K1's stream arm (``<name>_stream_batched``) on
    (N, *shape) stacks: member 0's tables and the member strides (as
    :func:`call_batched_entry`), the segment length ``seg`` and the
    outputs' pads (as :func:`call_stream_entry`), the member count, the
    step and the stream.  Returns its error code."""
    in_ptrs, in_s, out_ptrs, out_s, n3 = _arg_tables(
        program, spec, [a[0] for a in ins], [o[0] for o in outs])
    in_ms, out_ms = _member_strides(ins), _member_strides(outs)
    tab = _stream_table(program, spec, seg)
    geo = (ctypes.c_int * len(tab))(*tab)
    return fn(ctypes.addressof(in_ptrs), ctypes.addressof(in_s),
              ctypes.addressof(in_ms), ctypes.addressof(out_ptrs),
              ctypes.addressof(out_s), ctypes.addressof(out_ms),
              ctypes.addressof(n3), ctypes.addressof(geo), int(nm), int(t),
              stream)


def call_region_stream_entry(fn, program, spec, ins, outs, box, off, t: int,
                             stream, seg: int) -> int:
    """Call K5's entry over K1's stream arm (``<name>_stream_region``):
    K1's tables, K5's box table (as :func:`call_region_entry` passes it),
    the segment and pad table with the box's segment length ``seg`` (as
    :func:`call_stream_entry` passes it), the step and the stream.
    Returns its error code."""
    in_ptrs, in_s, out_ptrs, out_s, n3 = _arg_tables(program, spec, ins,
                                                     outs)
    tab = _region_table(program, box, off)
    reg = (ctypes.c_int * len(tab))(*tab)
    tab = _stream_table(program, spec, seg)
    geo = (ctypes.c_int * len(tab))(*tab)
    return fn(ctypes.addressof(in_ptrs), ctypes.addressof(in_s),
              ctypes.addressof(out_ptrs), ctypes.addressof(out_s),
              ctypes.addressof(n3), ctypes.addressof(reg),
              ctypes.addressof(geo), int(t), stream)


def call_stages_stream_entry(fn, program, spec, ins, outs, t: int, stream,
                             seg: int = None, nres: int = 1,
                             ws=None) -> int:
    """Call K6's stream entry (``<name>_stages_stream``): K6's tables,
    the segment length (``seg``, the plan's by default), the step index,
    the workspace ``ws`` of ``nres`` slices where rings lie past shared
    memory (None elsewhere), ``nres`` blocks (the card's resident blocks;
    the host path ignores both) and the stream.  Returns its error
    code."""
    in_ptrs, in_s, out_ptrs, out_s, n3 = _arg_tables(program, spec, ins,
                                                     outs)
    return fn(ctypes.addressof(in_ptrs), ctypes.addressof(in_s),
              ctypes.addressof(out_ptrs), ctypes.addressof(out_s),
              ctypes.addressof(n3),
              int(spec.stages_stream.seg if seg is None else seg), int(t),
              _ptr(ws), int(nres), stream)


def call_region_stages_stream_entry(fn, program, spec, ins, outs, box, off,
                                    t: int, stream, seg: int, nres: int = 1,
                                    ws=None) -> int:
    """Call K5's entry over K6's stream arm
    (``<name>_stages_stream_region``): K6's tables, K5's box table (the
    box ``{dim: (lo, hi)}`` in local interior coordinates, the shard's
    global origin ``off`` and the global extents, as
    :func:`call_region_entry` passes them), the box's segment length
    ``seg``, the step, the workspace (as :func:`call_stages_stream_entry`),
    ``nres`` blocks and the stream.  Returns its error code."""
    in_ptrs, in_s, out_ptrs, out_s, n3 = _arg_tables(program, spec, ins,
                                                     outs)
    tab = _region_table(program, box, off)
    reg = (ctypes.c_int * len(tab))(*tab)
    return fn(ctypes.addressof(in_ptrs), ctypes.addressof(in_s),
              ctypes.addressof(out_ptrs), ctypes.addressof(out_s),
              ctypes.addressof(n3), ctypes.addressof(reg), int(seg), int(t),
              _ptr(ws), int(nres), stream)


def call_batched_stages_stream_entry(fn, program, spec, ins, outs, nm: int,
                                     t: int, stream, seg: int = None,
                                     nres: int = 1, ws=None) -> int:
    """Call K7's entry over K6's stream arm
    (``<name>_stages_stream_batched``) on (N, *shape) stacks: member 0's
    tables and the member strides (as :func:`call_batched_entry`), the
    member count, the segment length, the step, the workspace (as
    :func:`call_stages_stream_entry`), ``nres`` blocks and the stream."""
    in_ptrs, in_s, out_ptrs, out_s, n3 = _arg_tables(
        program, spec, [a[0] for a in ins], [o[0] for o in outs])
    in_ms, out_ms = _member_strides(ins), _member_strides(outs)
    return fn(ctypes.addressof(in_ptrs), ctypes.addressof(in_s),
              ctypes.addressof(in_ms), ctypes.addressof(out_ptrs),
              ctypes.addressof(out_s), ctypes.addressof(out_ms),
              ctypes.addressof(n3), int(nm),
              int(spec.stages_stream.seg if seg is None else seg), int(t),
              _ptr(ws), int(nres), stream)


#: the workspace and flat arms' arguments before the stream
#: (``KernelSpec.walks``): the workspace and the resident blocks
_WS_ARGS = [ctypes.c_void_p, ctypes.c_longlong]


def entry_argtypes(ws: bool = False):
    """K1's and K6's C signature: the tables, the step, (the workspace
    and flat arms, ``ws``: the workspace and the resident blocks,) the
    stream."""
    return ([ctypes.c_void_p] * 5 + [ctypes.c_int]
            + (_WS_ARGS if ws else []) + [ctypes.c_void_p])


def batched_argtypes(ws: bool = False):
    """K7's C signature: K1's tables with the member strides after each
    array table, the member count, the step, (the workspace,) the
    stream."""
    return ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int]
            + (_WS_ARGS if ws else []) + [ctypes.c_void_p])


def region_argtypes(ws: bool = False):
    """K5's C signature: K1's tables, the box table, the step, (the
    workspace,) the stream."""
    return ([ctypes.c_void_p] * 6 + [ctypes.c_int]
            + (_WS_ARGS if ws else []) + [ctypes.c_void_p])


def stream_argtypes():
    """The stream entry's C signature: K1's tables, the segment and pad
    table, the step, the stream."""
    return [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]


def batched_stream_argtypes():
    """K7's entry over K1's stream arm: K7's tables with the member
    strides, the segment and pad table, the member count, the step, the
    stream."""
    return [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]


def region_stream_argtypes():
    """K5's entry over K1's stream arm: K1's tables, the box table, the
    segment and pad table, the step, the stream."""
    return [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_void_p]


def stages_stream_argtypes():
    """K6's stream entry's C signature: K6's tables, the segment, the
    step, the workspace, the resident blocks, the stream."""
    return ([ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int]
            + _WS_ARGS + [ctypes.c_void_p])


def region_stages_stream_argtypes():
    """K5's entry over K6's stream arm: K6's tables, the box table, the
    segment, the step, the workspace, the resident blocks, the stream."""
    return ([ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int]
            + _WS_ARGS + [ctypes.c_void_p])


def batched_stages_stream_argtypes():
    """K7's entry over K6's stream arm: K7's tables with the member
    strides, the member count, the segment, the step, the workspace, the
    resident blocks, the stream."""
    return ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int,
                                     ctypes.c_int] + _WS_ARGS
            + [ctypes.c_void_p])


def check_box(program, spec, box) -> None:
    """Raise unless every read of a sub-step over ``box`` and every write
    stays inside the padded arrays, and the box is not empty.  An input's
    reach around the box is ``spec.reach`` (its read offsets, and K6's
    sub-stage regions grown past the block: the whole step's reach, which
    ``fused_step_radius`` must cover for the group's boxes to pass) and,
    in an outer dim, its outer offset."""
    dims = list(program.ana.domain_dims)
    for d in dims:
        lo, hi = box[d]
        if hi <= lo:
            raise YaskException(f"K5: empty box {box} in dim '{d}'")
    slot = cuda_emit.slot_map(dims)
    outer = sorted((d for d in dims if slot[d] >= 3), key=slot.get)

    def reach_of(a):
        r = list(spec.reach.get(a, ((0, 0),) * 3))
        for o in (spec.in_outer[a] if spec.in_outer else [0] * len(outer)):
            r.append((max(-o, 0), max(o, 0)))
        return r
    arrays = [(n, reach_of(a)) for a, (n, _s) in enumerate(spec.inputs)]
    arrays += [(n, ((0, 0),) * max(3, len(slot))) for n in spec.outputs]
    for name, reach in arrays:
        g = program.geoms[name]
        for d in g.domain_dims:
            rlo, rhi = reach[slot[d]]
            pl, pr = g.pads[d]
            lo, hi = box[d]
            if lo - rlo < -pl or hi + rhi > program.sizes[d] + pr:
                raise YaskException(
                    f"K5: box {box} with reads ({rlo}, {rhi}) of '{name}' "
                    f"in dim '{d}' passes its pads {g.pads[d]}")


def _check_inputs(kernel: "FusedKernel", state, lead=(), spec=None):
    """The kernel's input tensors from ``state``, checked: CUDA, one
    device, the kernel's dtype, shape ``lead + padded shape``,
    contiguous.  ``spec`` lists them (the kernel's by default).  Returns
    (tensors, device)."""
    import torch
    prog = kernel.program
    dev = None
    ins = []
    for name, slot in (spec or kernel.spec).inputs:
        a = state[name][slot]
        want = tuple(lead) + tuple(prog.geoms[name].shape)
        if not isinstance(a, torch.Tensor) or a.device.type != "cuda":
            raise YaskException(
                f"fused kernel: input '{name}' slot {slot} is not a CUDA "
                "tensor")
        if dev is None:
            dev = a.device
        if a.device != dev or a.dtype != kernel.dtype \
                or tuple(a.shape) != want or not a.is_contiguous():
            raise YaskException(
                f"fused kernel: input '{name}' slot {slot} has device "
                f"{a.device}, dtype {a.dtype}, shape {tuple(a.shape)}, "
                f"contiguous {a.is_contiguous()}; the kernel takes "
                f"{dev}, {kernel.dtype}, {want}, contiguous")
        ins.append(a)
    if dev is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return ins, dev


def _rotated(program, spec, state, outs):
    """The state after a launch: each output, in order, rotated into its
    var's ring (a var listed once per level it outputs, as K4's are,
    rotates that many times)."""
    new_state = dict(state)
    for name, o in zip(spec.outputs, outs):
        ring = new_state[name]
        new_state[name] = (list(ring[1:]) + [o]) \
            if program.geoms[name].has_step else [o]
    return new_state


def copy_base(kernel: "FusedKernel", state, dev, lead=(), empty=False):
    """The fresh zeroed output tensors of one sub-step (``lead +`` the
    padded shape: ``(nm,)`` for a member batch's stacks), except that a
    var some of whose misc slices no equation writes
    (``spec.base_outputs``) starts from a device copy of its evicted slot
    (of every member: slot 0 of the stack), as the plain version's new
    slot is the evicted one with the written slices replaced.  Counts
    each copy in ``copy_base.launches``.  With ``empty`` (the flat arm's
    solo and batch launches, which write every cell of their outputs)
    the others come from ``torch.empty``, but a partial-dim output, whose
    slab the kernel writes and not its pads, stays zeroed."""
    import torch
    from yask_tpu_torch.compiler.lowering import torch_dtype
    prog = kernel.program
    dims = list(prog.ana.domain_dims)
    outs = []
    for n in kernel.spec.outputs:
        shape = tuple(lead) + tuple(prog.geoms[n].shape)
        if n in kernel.spec.base_outputs:
            outs.append(state[n][0].clone())
            copy_base.launches += 1
        elif empty and list(prog.geoms[n].domain_dims) == dims:
            outs.append(torch.empty(shape, dtype=torch_dtype(prog.dtype),
                                    device=dev))
        else:
            outs.append(torch.zeros(shape, dtype=torch_dtype(prog.dtype),
                                    device=dev))
    return outs


copy_base.launches = 0


def grid_z(program, spec, members: int = 1) -> int:
    """The z cells of one sub-step of K1, K6 or K7: the slot-0 blocks
    times the cells of the outer dims times the members.  Past CUDA's
    gridDim.z limit of 65535 (``YT_MAX_GRID_Z`` in ``fused_step.cuh``)
    the launch code splits them over several launches, each with its z
    origin; the stream arm walks its y and z blocks alike."""
    slot = cuda_emit.slot_map(program.ana.domain_dims)
    z = members
    for d, s_ in slot.items():
        if s_ == 0:
            z *= -(-program.sizes[d] // spec.tile[0])
        elif s_ >= 3:
            z *= program.sizes[d]
    return z


def _launch(kernel: "FusedKernel", state, t: int, what: str):
    """Launch one sub-step of the kernel's C entry point (K1's or K6's:
    they take the same arguments) on the current CUDA stream; returns the
    new state (rings rotated; a pushed var has no output, so its ring
    keeps its stale input tensors)."""
    import torch
    prog = kernel.program
    spec = kernel.spec
    ins, dev = _check_inputs(kernel, state)
    outs = copy_base(kernel, state, dev, empty=bool(spec.flat))
    with torch.cuda.device(dev):
        ws, nres = kernel.workspace(dev, 0)
        rc = call_entry(kernel.fn, prog, spec, ins, outs, t,
                        torch.cuda.current_stream(dev).cuda_stream, ws, nres)
    if rc != 0:
        raise YaskException(
            f"{what} kernel '{spec.name}' launch failed: CUDA error {rc}")
    return _rotated(prog, spec, state, outs)


def fused_step(kernel: "FusedKernel", state, t: int):
    """Launch one sub-step of K1 on the current CUDA stream; returns the
    new state (rings rotated).  Counts each launch in
    ``fused_step.launches``."""
    state = _launch(kernel, state, t, "fused_step")
    fused_step.launches += 1
    return state


fused_step.launches = 0


def stages_step(kernel: "FusedKernel", state, t: int):
    """Launch one sub-step of K6 (every stage of a multi-stage solution,
    pushed vars kept in shared memory) on the current CUDA stream; returns
    the new state.  Counts each launch in ``stages_step.launches``; where
    K6's stream arm is engaged (``kernel.skew_dims``) it launches
    ``<name>_stages_stream`` instead (:func:`_launch_stages_stream`),
    counted in ``stages_step.stream_launches``."""
    if kernel.skew_dims:
        state = _launch_stages_stream(kernel, state, t, None)
        stages_step.stream_launches += 1
        return state
    state = _launch(kernel, state, t, "stages_step")
    stages_step.launches += 1
    return state


stages_step.launches = 0
stages_step.stream_launches = 0


def _launch_stages_stream(kernel: "FusedKernel", state, t: int, nm):
    """Launch one sub-step of K6's stream arm (``nm`` None) or of K7 over
    it for ``nm`` members stacked as (nm, *shape), on the current CUDA
    stream, at most the card's resident blocks walking the work items
    (each with its workspace slice where rings lie past shared memory,
    :meth:`FusedKernel.stream_workspace`); returns the new state (rings
    rotated).  The kernel writes every cell of its outputs, so they come
    from ``torch.empty``; it raises where the kernel fails to launch.
    Past three domain dims the arm's own spec (``spec.stream_spec``)
    gives its inputs and outputs."""
    import torch
    prog = kernel.program
    spec = kernel.spec.stream_spec or kernel.spec
    lead = () if nm is None else (nm,)
    ins, dev = _check_inputs(kernel, state, lead=lead, spec=spec)
    if kernel.dtype == torch.bfloat16:
        check_pair_strides(prog, spec, ins, len(lead), "stages_step")
    outs = [torch.empty(lead + tuple(prog.geoms[n].shape),
                        dtype=kernel.dtype, device=dev)
            for n in spec.outputs]
    with torch.cuda.device(dev):
        ws, nres = kernel.stream_workspace(dev, 0 if nm is None else 1)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if nm is None:
            rc = call_stages_stream_entry(kernel.stages_stream_fn, prog, spec,
                                          ins, outs, t, stream, nres=nres,
                                          ws=ws)
        else:
            rc = call_batched_stages_stream_entry(
                kernel.batched_stages_stream_fn, prog, spec, ins, outs, nm,
                t, stream, nres=nres, ws=ws)
    if rc != 0:
        entry = "_stages_stream" + ("" if nm is None else "_batched")
        raise YaskException(
            f"stages_step kernel '{kernel.spec.name}{entry}' launch failed: "
            f"CUDA error {rc}")
    return _rotated(prog, spec, state, outs)


def check_pair_strides(program, spec, ins, lead: int = 0,
                       what: str = "stream_step", unit: int = 2) -> None:
    """Raise unless each input a stream arm stages has a unit minor
    stride and row and plane strides that are multiples of ``unit``
    (and such outer-dim strides, and such a member stride over the
    ``lead`` stacked dims of a member batch): at element size 2 K6's
    stream arms fill their rings with 4-byte pairs (``unit`` 2), K1's
    with 16-byte units (``unit`` 8, :data:`PAIR_UNIT`), aligned alike in
    every row, plane, member and outer window of a launch (the context
    plans the padded minor extent at element size 2 to match).  ``what``
    names the kernel in the message."""
    dims = list(program.ana.domain_dims)
    for a in spec.tiled:
        name = spec.inputs[a][0]
        s0, s1, s2, *outer = _slot_strides(ins[a][(0,) * lead],
                                           program.geoms[name], dims)
        members = [ins[a].stride(i) for i in range(lead)]
        if s2 != 1 or s1 % unit or s0 % unit \
                or any(x % unit for x in outer) \
                or any(x % unit for x in members):
            need = ("the pair copies need a unit minor stride and even "
                    "row and plane strides (and even outer and member "
                    "strides)" if unit == 2 else
                    "the 16-byte unit copies need a unit minor stride and "
                    "row and plane strides (and outer and member strides) "
                    f"that are multiples of {unit}")
            raise YaskException(
                f"{what} at element size 2: staged input '{name}' has "
                f"slot strides ({s0}, {s1}, {s2}"
                + "".join(f", {x}" for x in outer) + ")"
                + (f", member stride {members[0]}" if members else "")
                + f"; {need}")


#: Elements of a 16-byte unit at element size 2: K1's stream arm fills its
#: rings unit by unit, so its staged inputs' strides are multiples of it.
PAIR_UNIT = 8


def _launch_stream(kernel: "FusedKernel", state, t: int, nm, what: str):
    """Launch one sub-step of K1's stream arm (``nm`` None) or of K7 over
    it for ``nm`` members stacked as (nm, *shape) (at the batch's segment
    length, :meth:`FusedKernel.batch_segment`) on the current CUDA stream;
    returns the new state (rings rotated).  The kernel writes every cell
    of its outputs (every member's pads), so they come from
    ``torch.empty``; it raises where the kernel fails to launch."""
    import torch
    prog = kernel.program
    spec = kernel.spec
    lead = () if nm is None else (nm,)
    ins, dev = _check_inputs(kernel, state, lead=lead)
    if kernel.dtype == torch.bfloat16:
        check_pair_strides(prog, spec, ins, len(lead), what, PAIR_UNIT)
    outs = [torch.empty(lead + tuple(prog.geoms[n].shape),
                        dtype=kernel.dtype, device=dev)
            for n in spec.outputs]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if nm is None:
            rc = call_stream_entry(kernel.stream_fn, prog, spec, ins, outs,
                                   t, stream)
        else:
            rc = call_batched_stream_entry(
                kernel.batched_stream_fn, prog, spec, ins, outs, nm, t,
                stream, kernel.batch_segment(nm)["segment_planes"])
    if rc != 0:
        entry = "_stream" + ("" if nm is None else "_batched")
        raise YaskException(
            f"{what} kernel '{spec.name}{entry}' launch failed: CUDA error "
            f"{rc}")
    return _rotated(prog, spec, state, outs)


def stream_step(kernel: "FusedKernel", state, t: int):
    """Launch one sub-step of K1's stream arm on the current CUDA stream;
    returns the new state (rings rotated).  The kernel writes every cell
    of its outputs, so they come from ``torch.empty``.  Counts each launch
    in ``stream_step.launches``."""
    state = _launch_stream(kernel, state, t, None, "stream_step")
    stream_step.launches += 1
    return state


stream_step.launches = 0


def _launch_batched(kernel: "FusedKernel", state, t: int, nm: int,
                    what: str):
    """Launch one sub-step of K7 (``<name>_batched``, over K1's or K6's
    body) for ``nm`` members on the current CUDA stream: ``state`` holds
    (nm, *shape) stacks per ring slot; returns the new stacked state
    (rings rotated)."""
    import torch
    prog = kernel.program
    spec = kernel.spec
    ins, dev = _check_inputs(kernel, state, lead=(nm,))
    outs = copy_base(kernel, state, dev, lead=(nm,), empty=bool(spec.flat))
    with torch.cuda.device(dev):
        ws, nres = kernel.workspace(dev, 1)
        rc = call_batched_entry(kernel.batched_fn, prog, spec, ins, outs,
                                nm, t,
                                torch.cuda.current_stream(dev).cuda_stream,
                                ws, nres)
    if rc != 0:
        raise YaskException(
            f"{what} kernel '{spec.name}_batched' launch failed: CUDA "
            f"error {rc}")
    return _rotated(prog, spec, state, outs)


def batched_step(kernel: "FusedKernel", state, t: int, nm: int):
    """Launch one sub-step of K7 over K1's body (a single-stage solution
    without scratch vars) for ``nm`` members stacked as (nm, *shape);
    returns the new stacked state.  Counts each launch in
    ``batched_step.launches``; where K1's stream arm is engaged
    (``kernel.skew_dims``) it launches ``<name>_stream_batched`` instead
    (:func:`_launch_stream`), counted in ``batched_step.stream_launches``."""
    if kernel.skew_dims:
        state = _launch_stream(kernel, state, t, nm, "batched_step")
        batched_step.stream_launches += 1
        return state
    state = _launch_batched(kernel, state, t, nm, "batched_step")
    batched_step.launches += 1
    return state


batched_step.launches = 0
batched_step.stream_launches = 0


def batched_stages_step(kernel: "FusedKernel", state, t: int, nm: int):
    """Launch one sub-step of K7 over K6's body (every stage and scratch
    sub-stage) for ``nm`` members stacked as (nm, *shape); returns the
    new stacked state.  Counts each launch in
    ``batched_stages_step.launches``; where K6's stream arm is engaged
    (``kernel.skew_dims``) it launches ``<name>_stages_stream_batched``
    instead, counted in ``batched_stages_step.stream_launches``."""
    if kernel.skew_dims:
        state = _launch_stages_stream(kernel, state, t, nm)
        batched_stages_step.stream_launches += 1
        return state
    state = _launch_batched(kernel, state, t, nm, "batched_stages_step")
    batched_stages_step.launches += 1
    return state


batched_stages_step.launches = 0
batched_stages_step.stream_launches = 0


def _with_offset(program, off, device):
    """``program`` seen from a shard at global origin ``off`` (a shallow
    copy: the geometry is shared), its ops on ``device``."""
    import copy
    from yask_tpu_torch.compiler.lowering import TorchOps
    p = copy.copy(program)
    p.rank_offset = {d: int(off.get(d, 0)) for d in program.ana.domain_dims}
    if getattr(p.ops, "device", None) != device:
        p.ops = TorchOps(device)
    return p


def _box_idx(g, box):
    """Index of ``box`` (interior coordinates) in a padded tensor of
    geometry ``g``."""
    return tuple(slice(g.origin[dn] + box[dn][0], g.origin[dn] + box[dn][1])
                 if kind == "domain" else slice(None) for dn, kind in g.axes)


def stage_boxes(program, box) -> List[Dict]:
    """Each stage's box in one sub-step over ``box``: ``box`` grown by the
    sum of the later stages' ghost widths (each stage's widest read in
    ``program.stage_reads``, a scratch part's write halo included), as the
    reference's stage loop lets each stage consume its own width of the
    block's margin (pallas_stencil.py:2058-2075).  Stage 0 then reads up
    to ``fused_step_radius`` past ``box``.  This is the step's own
    analysis, not the emitter's tighter per-read regions of K6."""
    grow = {d: 0 for d in box}
    out = []
    for reads in reversed(program.stage_reads):
        out.append({d: (lo - grow[d], hi + grow[d])
                    for d, (lo, hi) in box.items()})
        width = {d: max([max(w.get(d, (0, 0))) for w in reads.values()]
                        + [0]) for d in grow}
        grow = {d: grow[d] + width[d] for d in grow}
    return out[::-1]


def _zero_outside_global(program, name: str, a):
    """Zero the cells of a padded tensor of var ``name`` (of a shard:
    ``program.rank_offset``) that lie outside the global domain: what the
    single-domain version's zero pads hold there."""
    g = program.geoms[name]
    for dn in g.domain_dims:
        ax = g.axis_of(dn)
        lo = g.origin[dn] - program.rank_offset[dn]
        hi = lo + program.global_last[dn] + 1
        if lo > 0:
            a.narrow(ax, 0, min(lo, a.shape[ax])).zero_()
        if hi < a.shape[ax]:
            a.narrow(ax, max(hi, 0), a.shape[ax] - max(hi, 0)).zero_()
    return a


def plain_shard_chunk(program, state, t: int, box, base=()):
    """The plain version of K5: one sub-step from step ``t``, the shard's
    ``StepProgram`` (``rank_offset`` = the shard's global origin, global
    sizes) evaluated stage by stage, each stage over its box
    (:func:`stage_boxes`) with the values it writes zeroed outside the
    global domain (as the single-domain version's pads are, where a later
    stage reads them), into a fresh zeroed tensor (for a var in ``base``,
    whose misc slices are not all written, a copy of its evicted slot)
    that keeps the box's cells inside the global domain; rings rotated.
    A stage's box is clipped to the global domain: what it would write
    past it is zeroed, and the pads past it may be narrower than the
    growth (a box at a corner of a single domain)."""
    computed: Dict = {}
    scratch: Dict = {}
    writes = [{eq.lhs.var_name() for part in stage.parts
               if not part.is_scratch for eq in part.eqs}
              for stage in program.ana.stages]

    def inside(b):     # ``b`` clipped to the global domain
        out = {}
        for d, (lo, hi) in b.items():
            o = program.rank_offset[d]
            a = max(lo, -o)
            out[d] = (a, max(a, min(hi, program.global_last[d] + 1 - o)))
        return out
    for si, sbox in enumerate(stage_boxes(program, box)):
        program.eval_stage(si, t, state, computed, scratch,
                           over=inside(sbox))
        for name in writes[si]:
            _zero_outside_global(program, name, computed[name])
    outs = {}
    for name, val in computed.items():
        idx = _box_idx(program.geoms[name], inside(box))
        outs[name] = (state[name][0].clone() if name in base
                      else val.new_zeros(val.shape))
        outs[name][idx] = val[idx]
    return program.rotate(state, outs)


def plain_shard_step(kernel: "FusedKernel", state, t: int, box, off,
                     outs=None):
    """:func:`shard_step`'s plain version on the tensors' own device:
    :func:`plain_shard_chunk` of the shard's program over ``box``, into
    fresh outputs or the box of ``outs``."""
    prog = kernel.program
    new = plain_shard_chunk(
        _with_offset(prog, off, kernel._device_of(state)), state, t, box,
        kernel.spec.base_outputs)
    if outs is None:
        return new
    for name, o in zip(kernel.spec.outputs, outs):
        idx = _box_idx(prog.geoms[name], box)
        o[idx] = new[name][-1][idx]
    return _rotated(prog, kernel.spec, state, outs)


def shard_step(kernel: "FusedKernel", state, t: int, box, off, outs=None):
    """K5: one sub-step of one shard over ``box`` (``{dim: (lo, hi)}``,
    the shard's local interior coordinates, reaching into its pads where
    the group needs it), the shard's global origin ``off``; returns the
    shard's new state (rings rotated).  It launches the ``_region`` entry
    of the kernel's body: K1's for a single-stage solution, K6's (every
    stage and scratch sub-stage) otherwise; where a stream arm is
    engaged (``kernel.skew_dims``, a kernel built with ``region=True``)
    its box entry instead (K1's ``_stream_region``, K6's
    ``_stages_stream_region``), at the box's segment length
    (:meth:`FusedKernel.region_segment`).  The outputs are fresh
    zeroed tensors holding the box's cells (a var whose misc slices are
    not all written starts from a copy of its evicted slot,
    :func:`copy_base`), or the given ``outs``, of which only the box is
    written (the core and the shells of an overlapped group write
    disjoint boxes of one sub-step's outputs).  CPU tensors take
    :func:`plain_shard_chunk`; CUDA tensors launch the kernel (counted in
    ``shard_step.launches``, the stream arm in
    ``shard_step.stream_launches``) or raise."""
    import torch
    prog = kernel.program
    spec = kernel.spec
    if spec is None:    # no equations: nothing to compute (ROADMAP.md C14)
        return state
    dev = kernel._device_of(state)
    check_box(prog, spec, box)
    if dev.type == "cpu":
        return plain_shard_step(kernel, state, t, box, off, outs)
    if dev.type != "cuda":
        raise YaskException(
            f"fused kernel: state on '{dev}' (CUDA or CPU tensors)")
    kernel.build()
    ins, dev = _check_inputs(kernel, state)
    if kernel.skew_dims and kernel.dtype == torch.bfloat16:
        check_pair_strides(prog, spec, ins, what="shard_step",
                           unit=PAIR_UNIT if spec.stream is not None else 2)
    if outs is None:
        outs = copy_base(kernel, state, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if kernel.skew_dims and spec.stream is not None:
            entry = "_stream_region"
            rc = call_region_stream_entry(
                kernel.stream_region_fn, prog, spec, ins, outs, box, off, t,
                stream, kernel.region_segment(box)["segment_planes"])
        elif kernel.skew_dims:
            entry = "_stages_stream_region"
            ws, nres = kernel.stream_workspace(dev, 2)
            rc = call_region_stages_stream_entry(
                kernel.region_stages_stream_fn, prog, spec, ins, outs, box,
                off, t, stream,
                kernel.region_segment(box, nres)["segment_planes"], nres, ws)
        else:
            entry = "_region"
            ws, nres = kernel.workspace(dev, 2)
            rc = call_region_entry(kernel.region_fn, prog, spec, ins, outs,
                                   box, off, t, stream, ws, nres)
    if rc != 0:
        raise YaskException(
            f"shard_step kernel '{spec.name}{entry}' launch failed: CUDA "
            f"error {rc}")
    if kernel.skew_dims:
        shard_step.stream_launches += 1
    else:
        shard_step.launches += 1
    return _rotated(prog, spec, state, outs)


shard_step.launches = 0
shard_step.stream_launches = 0


def plain_batched_chunk(program, state, t0: int, k: int, nm: int):
    """The plain version of one K7 chunk: :func:`plain_chunk` on each
    member's view of the (nm, *shape) stacks, restacked."""
    import torch
    members = [plain_chunk(program, {name: [a[i] for a in ring]
                                     for name, ring in state.items()},
                           t0, k) for i in range(nm)]
    return {name: [torch.stack([m[name][s] for m in members])
                   for s in range(len(members[0][name]))]
            for name in members[0]}


class FusedKernel:
    """K1 (one stage) or K6 (several) for one planned solution: its
    emitted source and, after :meth:`build`, the loaded library.
    ``chunk`` is the wrapper: CPU tensors take :func:`plain_chunk`, CUDA
    tensors launch the kernel.  ``push`` is the push-memory request
    (:func:`~yask_tpu_torch.ops.cuda_emit.resolve_push`); ``skew`` the
    stream-arm request and ``max_skew_dims`` the ``-skew_dims`` window
    (:func:`~yask_tpu_torch.ops.cuda_emit.skew_engaged_dims`, whose
    reason records land in ``skew_reasons``): where it engages, ``chunk``
    launches :func:`stream_step` in place of :func:`fused_step` and
    :func:`batched_step` K7 over it (K1's arm: ``<name>_stream``,
    ``_stream_batched``), or :func:`stages_step` and
    :func:`batched_stages_step` launch K6's stream arm
    (``<name>_stages_stream``, ``_batched``).  ``region`` makes K5's
    kernel of a shard's program: the request then selects K5's arm, and
    :func:`shard_step` launches the stream arm over the box
    (``<name>_stream_region``, ``<name>_stages_stream_region``) where it
    engages."""

    def __init__(self, program, push=False, skew=False,
                 max_skew_dims: int = 2, region: bool = False):
        self.program = program
        #: None for a program without equations: its step launches
        #: nothing (ROADMAP.md C14)
        self.spec = (cuda_emit.emit(program, push) if program.ana.eqs
                     else None)
        self.skew_reasons: List[Dict] = []
        self._skew = (skew, max_skew_dims)
        self.region = region
        self.skew_dims = cuda_emit.skew_engaged_dims(
            program, skew, max_skew_dims, self.skew_reasons, self.spec,
            region=region)
        self.fn = None
        self.batched_fn = None
        self.region_fn = None
        #: K1's stream arm: its solo, batch and box entries
        self.stream_fn = None
        self.batched_stream_fn = None
        self.stream_region_fn = None
        #: K6's stream arm: its solo, batch and box entries and their
        #: resident-block query
        self.stages_stream_fn = None
        self.batched_stages_stream_fn = None
        self.region_stages_stream_fn = None
        self.stream_resident_fn = None
        #: K5's stream arm: each box's segments, per (box extents,
        #: resident blocks); K7's over K1's: per member count
        self._region_segs: Dict[tuple, Dict] = {}
        self._batch_segs: Dict[int, Dict] = {}
        #: the workspace arm's resident-block query and its answers per
        #: launch kind (0 solo, 1 member batch, 2 a shard's box)
        self.resident_fn = None
        self._resident: Dict[int, int] = {}
        self.build_secs = 0.0
        self.dtype = None
        #: where the last build() found the library: "memory" (already
        #: loaded), "disk" (built by an earlier process), None (nvcc ran)
        self.cache_hit = None

    def _load(self):
        """Build (nvcc at first use) and load the library; returns it with
        the seconds spent, and records where it came from."""
        import os
        from yask_tpu_torch.compiler.lowering import torch_dtype
        from yask_tpu_torch.ops import _build
        on_disk = os.path.exists(_build.library_path(self.spec.name,
                                                     self.spec.source))
        lib, secs = _build.build_and_load(self.spec.name, self.spec.source)
        self._lib = lib
        self.dtype = torch_dtype(self.program.dtype)
        self.build_secs += secs
        self.cache_hit = "disk" if on_disk else None
        return lib, secs

    def build(self) -> float:
        """Build (nvcc at first use) and bind the entry points (K1, K7,
        K5 and the stream arm for one stage, K6, K7 and K5 for several);
        returns the seconds it took.  Raises on a missing nvcc or a failed
        build.  A program without equations builds nothing."""
        if self.spec is None:
            return 0.0
        if self.fn is not None:
            self.cache_hit = "memory"
            return 0.0
        lib, secs = self._load()
        ws = self.spec.walks
        fn = getattr(lib, self.spec.name)
        fn.argtypes = entry_argtypes(ws)
        fn.restype = ctypes.c_int
        bfn = getattr(lib, self.spec.name + "_batched")
        bfn.argtypes = batched_argtypes(ws)
        bfn.restype = ctypes.c_int
        rfn = getattr(lib, self.spec.name + "_region")
        rfn.argtypes = region_argtypes(ws)
        rfn.restype = ctypes.c_int
        if ws:
            self.resident_fn = getattr(lib, self.spec.name + "_resident")
            self.resident_fn.argtypes = [ctypes.c_int]
            self.resident_fn.restype = ctypes.c_int
        if self.spec.stream is not None:
            stem = self.spec.name + "_stream"
            entries = [("stream_fn", stem, stream_argtypes()),
                       ("batched_stream_fn", stem + "_batched",
                        batched_stream_argtypes())]
            if not self.spec.outer:
                # K5 over the arm (three domain dims only)
                entries.append(("stream_region_fn", stem + "_region",
                                region_stream_argtypes()))
            for attr, entry, argtypes in entries:
                f = getattr(lib, entry)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
                setattr(self, attr, f)
        if self.spec.stages_stream is not None:
            stem = self.spec.name + "_stages_stream"
            self.stages_stream_fn = getattr(lib, stem)
            self.stages_stream_fn.argtypes = stages_stream_argtypes()
            self.batched_stages_stream_fn = getattr(lib, stem + "_batched")
            self.batched_stages_stream_fn.argtypes = \
                batched_stages_stream_argtypes()
            if not self.spec.outer:
                # K5 over the stream arm (three domain dims only)
                self.region_stages_stream_fn = getattr(lib, stem + "_region")
                self.region_stages_stream_fn.argtypes = \
                    region_stages_stream_argtypes()
            self.stream_resident_fn = getattr(lib, stem + "_resident")
            self.stream_resident_fn.argtypes = [ctypes.c_int]
            for f in (self.stages_stream_fn, self.batched_stages_stream_fn,
                      self.region_stages_stream_fn, self.stream_resident_fn):
                if f is not None:
                    f.restype = ctypes.c_int
        self.fn = fn
        self.batched_fn = bfn
        self.region_fn = rfn
        return secs

    def _resident_blocks(self, key, query) -> int:
        """The resident blocks of launch ``key``, asked of ``query()`` (the
        kernel's resident-block entry: the count, or a negative CUDA error,
        which raises) once per key and card."""
        if key not in self._resident:
            n = query()
            if n < 1:
                raise YaskException(
                    f"kernel '{self.spec.name}': the resident-block query "
                    f"failed: CUDA error {-n}")
            self._resident[key] = n
        return self._resident[key]

    def _workspace_of(self, dev, key, elems: int, query):
        """A workspace of the resident blocks of launch ``key`` times
        ``elems`` elements, and that block count."""
        import torch
        nres = self._resident_blocks(key, query)
        return (torch.empty(nres * elems, dtype=self.dtype, device=dev),
                nres)

    def workspace(self, dev, kind: int):
        """The workspace of one launch of the workspace arm of ``kind`` (0
        solo, 1 member batch, 2 a shard's box): ``ws_elems`` per resident
        block; (None, 0) for a kernel without one.  The flat arm has no
        workspace: (None, its resident blocks), the grid of its launch,
        which :meth:`tiling` reports."""
        if not self.spec.workspace:
            return None, (self._resident_blocks(
                kind, lambda: self.resident_fn(int(kind)))
                if self.spec.flat else 0)
        return self._workspace_of(dev, kind, self.spec.workspace["ws_elems"],
                                  lambda: self.resident_fn(int(kind)))

    def stream_resident(self, kind: int) -> int:
        """The resident blocks of K6's stream arm for a launch of ``kind``
        (0 solo, 1 member batch, 2 a shard's box): the grid of its
        launches, asked of the kernel once per kind and card; where rings
        lie past shared memory at most the plan's ``ws_blocks``, so that
        the blocks' workspace slices stay within the card's L2."""
        cap = self.spec.stages_stream.ws_blocks

        def query():
            n = self.stream_resident_fn(int(kind))
            return min(n, cap) if cap else n
        return self._resident_blocks(("stream", kind), query)

    def stream_workspace(self, dev, kind: int):
        """The workspace of one launch of K6's stream arm of ``kind`` and
        its resident blocks: ``ws_elems`` per block where rings lie past
        shared memory, else None."""
        import torch
        elems = self.spec.stages_stream.ws_elems
        nres = self.stream_resident(kind)
        if not elems:
            return None, nres
        return (torch.empty(nres * elems, dtype=self.dtype, device=dev),
                nres)

    def region_segment(self, box, nres: int = 0) -> Dict[str, object]:
        """K5's stream arm over ``box``: the plan's segment rule
        (:func:`~yask_tpu_torch.ops.tile_planner.stream_segments`) at the
        box's extents; K6's on ``nres`` resident blocks (0: those the card
        answered for a box, else the plan's estimate), K1's on its grid's
        waves (``StreamPlan.segments_of``).  Returns the box, its segment
        length, segments, columns and blocks (K1's: the grid's)."""
        from yask_tpu_torch.ops import tile_planner
        k1 = self.spec.stream
        plan = k1 or self.spec.stages_stream
        dims = list(self.program.ana.domain_dims)
        n = tuple(int(box[d][1]) - int(box[d][0]) for d in dims)
        if k1 is not None:
            nres = 0
        elif not nres:
            nres = self._resident.get(("stream", 2)) or min(
                tile_planner.SMS * plan.per_sm,
                plan.ws_blocks or tile_planner.SMS * plan.per_sm)
        key = (n, nres)
        if key not in self._region_segs:
            cols = -(-n[1] // plan.tile[0]) * -(-n[2] // plan.tile[1])
            if k1 is not None:
                seg, segs = k1.segments_of(n[0], cols)
                blocks = cols * segs
            else:
                seg, segs = tile_planner.stream_segments(n[0], cols, nres,
                                                         plan.warm)
                blocks = nres
            self._region_segs[key] = {"segment_planes": seg,
                                      "segments": segs, "columns": cols,
                                      "blocks": blocks}
        return dict(self._region_segs[key],
                    box=[[int(x) for x in box[d]] for d in dims])

    def batch_segment(self, members: int) -> Dict[str, object]:
        """K7 over K1's stream arm for ``members`` members: the plan's
        segment rule with the members' columns in the waves
        (``StreamPlan.segments_of``; past three domain dims a member's
        columns count its outer cells).  Returns the members, the segment
        length, segments per member, columns per member and the grid's
        blocks."""
        if members not in self._batch_segs:
            plan = self.spec.stream
            cols = plan.blocks // plan.segments
            dims = self.program.ana.domain_dims
            n0 = self.program.sizes[dims[self.spec.outer]]
            seg, segs = plan.segments_of(n0, cols * members)
            self._batch_segs[members] = {
                "members": members, "segment_planes": seg, "segments": segs,
                "columns": cols, "blocks": cols * segs * members}
        return dict(self._batch_segs[members])

    def chunk(self, state, t0: int, k: int):
        """Advance ``k`` steps from ``t0``: one kernel launch per step on
        CUDA tensors; the plain version on CPU tensors; raises otherwise.
        A program without equations launches nothing."""
        if self.spec is None:
            return state
        dev = self._device_of(state)
        if dev.type == "cpu":
            return plain_chunk(self.program, state, t0, k)
        if dev.type != "cuda":
            raise YaskException(
                f"fused kernel: state on '{dev}' (CUDA or CPU tensors)")
        self.build()
        step = (stages_step if self.spec.stages > 1 else
                stream_step if self.skew_dims else fused_step)
        dirn = self.program.ana.step_dir
        for i in range(k):
            state = step(self, state, t0 + i * dirn)
        return state

    def batched_chunk(self, state, t0: int, k: int, nm: int):
        """K7: advance ``nm`` members stacked as (nm, *shape) per ring
        slot by ``k`` steps from ``t0``: one launch per step for all
        members on CUDA tensors (over K1's body, or K6's for several
        sub-stages); the plain version on CPU tensors; raises otherwise.
        A program without equations launches nothing."""
        if self.spec is None:
            return state
        dev = self._device_of(state)
        if dev.type == "cpu":
            return plain_batched_chunk(self.program, state, t0, k, nm)
        if dev.type != "cuda":
            raise YaskException(
                f"fused kernel: state on '{dev}' (CUDA or CPU tensors)")
        self.build()
        step = batched_step if self.spec.stages == 1 else batched_stages_step
        dirn = self.program.ana.step_dir
        for i in range(k):
            state = step(self, state, t0 + i * dirn, nm)
        return state

    @staticmethod
    def _device_of(state):
        import torch
        for ring in state.values():
            for a in ring:
                if isinstance(a, torch.Tensor):
                    return a.device
        raise YaskException("fused kernel: state holds no tensors")

    def tiling(self, fuse_steps: int, members: int = 0) -> Dict[str, object]:
        """The tiling the kernel runs with (the port's ``chunk.tiling``):
        the arm, its tile and shared memory, and the skew decision; with
        ``members``, that of K7's batches of that many members (over K6's
        stream arm where it engages, else over K1's or K6's body)."""
        s = self.spec
        reasons = self.skew_reasons
        skew_dims = self.skew_dims
        if members:
            reasons = []
            skew_dims = cuda_emit.skew_engaged_dims(
                self.program, *self._skew, reasons=reasons, spec=s,
                batched=True, members=members)
        if s is None:
            return {"kernel": None, "name": None, "fuse_steps": fuse_steps,
                    "launches_per_step": 0, "stages": 0, "members": members,
                    "skew_reasons": list(reasons)}
        out = {"kernel": "fused_step" if s.stages == 1 else "stages_step",
               "name": s.name, "fuse_steps": fuse_steps,
               "launches_per_step": 1, "stages": s.stages,
               "scratch_stages": s.scratch_stages,
               "tile": list(s.tile), "smem_bytes": s.smem_bytes,
               "smem_inputs": [s.inputs[a] for a in s.tiled],
               "push": bool(s.push_vars), "push_vars": list(s.push_vars),
               "push_smem_bytes": s.push_smem_bytes,
               "pipeline_dmas": False, "skew": False, "skew_dims": [],
               "skew_reasons": list(reasons)}
        if s.workspace:
            # the workspace arm: its reason record, tile and bytes
            w = s.workspace
            out["workspace"] = {
                "code": w["code"], "detail": w["detail"],
                "tile": list(w["tile"]), "smem_bytes": w["smem_bytes"],
                "ws_block_bytes": w["ws_block_bytes"],
                "resident_blocks": dict(self._resident),
                "cells_per_point": w["cells_per_point"],
                "staged_in_ws": w["staged_in_ws"],
                "computed_in_ws": w["computed_in_ws"]}
        if s.flat:
            # K6's flat arm: its reason record, tile, threads, staged cells
            # per point, shared memory (both buffers) and, after a launch
            # on the card, its resident blocks per launch kind
            out["flat"] = dict(s.flat, tile=list(s.flat["tile"]),
                               resident_blocks=dict(self._resident))
        elif s.flat_cause:
            out["flat"] = {"code": s.flat_cause[0],
                           "detail": s.flat_cause[1]}
        if s.stages_stream is not None and skew_dims:
            # K6's stream arm (solo or K7 over it): its plan and, after a
            # launch on the card, its resident blocks per launch kind
            rec = s.stages_stream.record()
            out.update(
                name=s.name + "_stages_stream" + (
                    "_batched" if members else
                    "_region" if self.region else ""),
                tile=[1] + rec["plane_tile"], smem_bytes=rec["smem_bytes"],
                pipeline_dmas=True, skew=True,
                skew_dims=list(skew_dims),
                stages_stream=dict(rec, resident_blocks={
                    k[1]: v for k, v in self._resident.items()
                    if isinstance(k, tuple)}))
            if members:
                out.update(kernel="batched_stages_step", members=members)
        elif s.stream is not None and skew_dims:
            # K1's stream arm (solo, K7 over it at the batch's segment, K5
            # over it): its plan, also under "stream"
            rec = s.stream.record()
            if members:
                b = self.batch_segment(members)
                rec.update(segment_planes=b["segment_planes"],
                           segments=b["segments"], blocks=b["blocks"])
            out.update(rec)
            out.update(kernel="batched_step" if members else "stream_step",
                       name=s.name + "_stream" + (
                           "_batched" if members else
                           "_region" if self.region else ""),
                       tile=[1] + rec["plane_tile"], pipeline_dmas=True,
                       skew=True, skew_dims=list(skew_dims), stream=rec)
            if members:
                out["members"] = members
        elif members:
            out.update(kernel=("batched_step" if s.stages == 1
                               else "batched_stages_step"),
                       name=s.name + "_batched", members=members)
        return out


# ==== K4: the trapezoid/diamond two-phase tiling ==========================
# Replaces the trapezoid arm of build_pallas_chunk (pallas_stencil.py:
# :812-930 resolution, :1514-1553 diamond sub-builds, :2058-2188 the stage
# loop inside each level, :2331-2416 host stitch): one K-step group is one
# launch of phase 1 (trapezoid_kernel, K levels per tile inside the
# launch, every sub-stage of K6 inside each level) and one launch per
# trapezoid dim of the diamonds (diamond_kernel), which write their bands
# straight into phase 1's outputs; and the member batch the reference
# vmaps over it (yask_tpu/runtime/ensemble.py:253-263), the same kernels
# with BATCH = true.  Bound by bytes: iso3dfd r=2 at K=4 moves 5 B per
# point per step (p(t), p(t-1), vel read once and two levels written per
# group of 4) against K1's 16.  csrc/trapezoid.cuh has the design.


def trapezoid_argtypes():
    """K4's solo C signature: the pass, K1's tables, the step, the
    workspace and its resident blocks, the stream."""
    return [ctypes.c_int] + [ctypes.c_void_p] * 5 + [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]


def trap_batched_argtypes():
    """K4's member-batch C signature (``<name>_trap_batched``): the pass,
    K7's tables, the member count, the step, the workspace and its
    resident blocks, the stream."""
    return [ctypes.c_int] + [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p]


def _ptr(t):
    return None if t is None else t.data_ptr()


def call_trapezoid_entry(fn, program, spec, ins, outs, pas: int, t: int,
                         stream, ws=None, nres: int = 0) -> int:
    """Call pass ``pas`` of an emitted K4 entry point (0 = phase 1,
    D = the diamonds of the D-th trapezoid dim): K1's arguments after the
    pass index, then the workspace tensor ``ws`` of ``nres`` resident
    blocks (None where no pass has one; the host path allocates its own).
    Returns its error code."""
    in_ptrs, in_s, out_ptrs, out_s, n3 = _arg_tables(program, spec, ins,
                                                     outs)
    return fn(int(pas), ctypes.addressof(in_ptrs), ctypes.addressof(in_s),
              ctypes.addressof(out_ptrs), ctypes.addressof(out_s),
              ctypes.addressof(n3), int(t), _ptr(ws), int(nres), stream)


def call_trap_batched_entry(fn, program, spec, ins, outs, pas: int, nm: int,
                            t: int, stream, ws=None, nres: int = 0) -> int:
    """Call pass ``pas`` of K4's member-batch entry on (nm, *shape)
    stacks: member 0's tables and the member strides, as
    :func:`call_batched_entry` passes them, then the workspace."""
    in_ptrs, in_s, out_ptrs, out_s, n3 = _arg_tables(
        program, spec, [a[0] for a in ins], [o[0] for o in outs])
    in_ms = _member_strides(ins)
    out_ms = _member_strides([outs[i] for i, _m in spec.out_slices])
    return fn(int(pas), ctypes.addressof(in_ptrs), ctypes.addressof(in_s),
              ctypes.addressof(in_ms), ctypes.addressof(out_ptrs),
              ctypes.addressof(out_s), ctypes.addressof(out_ms),
              ctypes.addressof(n3), int(nm), int(t), _ptr(ws), int(nres),
              stream)


def trap_outputs(kernel: "TrapezoidKernel", state, dev, lead=()):
    """The output tensors of one K4 group (``lead +`` the padded shape):
    uninitialised, as the passes write every interior cell and the pads
    are re-zeroed after, except that a var some of whose misc slices no
    equation writes (``spec.base_outputs``) starts level L from a device
    copy of ring slot (L − 1) mod S, which is what the plain version's
    copies of the evicted slots carry there (counted in
    ``copy_base.launches``)."""
    import torch
    prog = kernel.program
    spec = kernel.spec
    outs = []
    for n, L in zip(spec.outputs, spec.trap["out_levels"]):
        if n in spec.base_outputs:
            outs.append(state[n][(L - 1) % prog.geoms[n].num_slots].clone())
            copy_base.launches += 1
        else:
            outs.append(torch.empty(tuple(lead) + tuple(prog.geoms[n].shape),
                                    dtype=kernel.dtype, device=dev))
    return outs


def _trap_group(kernel: "TrapezoidKernel", state, t0: int, K: int, nm: int,
                counter):
    """One K-step group of K4, solo (``nm`` 0) or over ``nm`` stacked
    members: every pass on the current CUDA stream into
    :func:`trap_outputs`, pads re-zeroed, rings rotated; each launch
    counted on ``counter``."""
    import torch
    prog = kernel.program
    spec = kernel.spec
    if K != spec.trap["K"]:
        raise YaskException(f"K4 kernel '{spec.name}' runs groups of "
                            f"{spec.trap['K']} steps, not {K}")
    lead = (nm,) if nm else ()
    ins, dev = _check_inputs(kernel, state, lead=lead)
    outs = trap_outputs(kernel, state, dev, lead)
    with torch.cuda.device(dev):
        ws, nres = kernel.workspace(dev, bool(nm))
        stream = torch.cuda.current_stream(dev).cuda_stream
        for pas, rep in enumerate(spec.trap["passes"]):
            if nm:
                rc = call_trap_batched_entry(kernel.batched_fn, prog, spec,
                                             ins, outs, pas, nm, t0, stream,
                                             ws, nres)
            else:
                rc = call_trapezoid_entry(kernel.fn, prog, spec, ins, outs,
                                          pas, t0, stream, ws, nres)
            if rc != 0:
                raise YaskException(
                    f"K4 kernel '{spec.name}' {rep['kernel']}"
                    f"{' (member batch)' if nm else ''} launch failed: "
                    f"CUDA error {rc}")
            if pas == 0:
                counter.phase1_launches += 1
            else:
                counter.diamond_launches += 1
    for name, o in zip(spec.outputs, outs):
        for m in (o if nm else [o]):
            _zero_pads(prog, name, m)
    return _rotated(prog, spec, state, outs)


def _trap_stream_group(kernel: "TrapezoidKernel", state, t0: int, K: int,
                       nm: int, counter):
    """One K-step group of K4's stream arm, solo (``nm`` 0) or over ``nm``
    stacked members: one launch of ``<name>_trap_stream`` (or
    ``_trap_stream_batched``) on the current CUDA stream, at most the
    card's resident blocks walking the work items, into ``torch.empty``
    outputs (the kernel writes every cell, pads included); rings rotated;
    the launch counted in ``counter.stream_launches``.  Raises where the
    kernel fails to launch."""
    import torch
    prog = kernel.program
    spec = kernel.spec
    if K != spec.trap["K"]:
        raise YaskException(f"K4 kernel '{spec.name}' runs groups of "
                            f"{spec.trap['K']} steps, not {K}")
    lead = (nm,) if nm else ()
    ins, dev = _check_inputs(kernel, state, lead=lead)
    if kernel.dtype == torch.bfloat16:
        check_pair_strides(prog, spec, ins, len(lead), "trapezoid_chunk")
    outs = [torch.empty(lead + tuple(prog.geoms[n].shape),
                        dtype=kernel.dtype, device=dev)
            for n in spec.outputs]
    with torch.cuda.device(dev):
        ws, nres = kernel.stream_workspace(dev, 1 if nm else 0)
        stream = torch.cuda.current_stream(dev).cuda_stream
        if nm:
            rc = call_batched_stages_stream_entry(
                kernel.batched_fn, prog, spec, ins, outs, nm, t0, stream,
                nres=nres, ws=ws)
        else:
            rc = call_stages_stream_entry(kernel.fn, prog, spec, ins, outs,
                                          t0, stream, nres=nres, ws=ws)
    if rc != 0:
        raise YaskException(
            f"K4 kernel '{spec.name}_trap_stream"
            f"{'_batched' if nm else ''}' launch failed: CUDA error {rc}")
    counter.stream_launches += 1
    return _rotated(prog, spec, state, outs)


def trapezoid_chunk(kernel: "TrapezoidKernel", state, t0: int, K: int):
    """K4: one K-step group from step ``t0`` on the current CUDA stream —
    on the stream arm (``kernel.stream``) one launch, counted in
    ``trapezoid_chunk.stream_launches``; else phase 1, then the diamonds
    of each trapezoid dim, into fresh output tensors whose pad bands are
    then re-zeroed (pallas_stencil.py:2347-2367), counted in
    ``trapezoid_chunk.phase1_launches`` and ``.diamond_launches``.
    Returns the new state (each ring: its surviving slots, then the
    group's newest levels, pallas_stencil.py:2371)."""
    if kernel.stream:
        return _trap_stream_group(kernel, state, t0, K, 0, trapezoid_chunk)
    return _trap_group(kernel, state, t0, K, 0, trapezoid_chunk)


trapezoid_chunk.phase1_launches = 0
trapezoid_chunk.diamond_launches = 0
trapezoid_chunk.stream_launches = 0


def batched_trapezoid_chunk(kernel: "TrapezoidKernel", state, t0: int,
                            K: int, nm: int):
    """K7 over K4: one K-step group of ``nm`` members stacked as (nm,
    *shape) per ring slot: on the stream arm one launch of
    ``<name>_trap_stream_batched`` (the member a work-item coordinate),
    counted in ``batched_trapezoid_chunk.stream_launches``; else each pass
    one launch for all members (``<name>_trap_batched``), counted in
    ``.phase1_launches`` and ``.diamond_launches``.  Returns the new
    stacked state.  As the reference's vmapped chunk, it never pushes."""
    if kernel.stream:
        return _trap_stream_group(kernel, state, t0, K, nm,
                                  batched_trapezoid_chunk)
    return _trap_group(kernel, state, t0, K, nm, batched_trapezoid_chunk)


batched_trapezoid_chunk.phase1_launches = 0
batched_trapezoid_chunk.diamond_launches = 0
batched_trapezoid_chunk.stream_launches = 0


class TrapezoidKernel(FusedKernel):
    """K4 for one planned solution and group depth: the spec
    :func:`~yask_tpu_torch.ops.cuda_emit.resolve_trapezoid` returned and,
    after :meth:`build`, the loaded library.  ``chunk`` (solo) and
    ``batched_chunk`` (a member batch) are the wrappers: CPU tensors take
    :func:`plain_chunk` / :func:`plain_batched_chunk` over the K steps,
    CUDA tensors launch the kernels or raise.  ``stream`` says which arm
    the spec is: K4's stream arm (``cuda_emit.emit_trap_stream``, one
    launch per group; ``fn``/``batched_fn`` are ``<name>_trap_stream`` and
    ``_trap_stream_batched``) or the two-phase passes."""

    def __init__(self, program, spec):
        self.program = program
        self.spec = spec
        self.K = spec.trap["K"]
        self.stream = spec.trap.get("arm") == "stream"
        self.fn = None
        self.batched_fn = None
        self.resident_fn = None
        self.stream_resident_fn = None
        self._resident: Dict[object, int] = {}
        self.build_secs = 0.0
        self.dtype = None
        self.cache_hit = None

    def build(self) -> float:
        if self.fn is not None:
            self.cache_hit = "memory"
            return 0.0
        lib, secs = self._load()
        if self.stream:
            stem = self.spec.name + "_trap_stream"
            fn, bfn = getattr(lib, stem), getattr(lib, stem + "_batched")
            fn.argtypes = stages_stream_argtypes()
            bfn.argtypes = batched_stages_stream_argtypes()
            rfn = getattr(lib, stem + "_resident")
            rfn.argtypes = [ctypes.c_int]
            fn.restype = bfn.restype = rfn.restype = ctypes.c_int
            self.fn, self.batched_fn, self.stream_resident_fn = fn, bfn, rfn
            return secs
        fn = getattr(lib, self.spec.name)
        fn.argtypes = trapezoid_argtypes()
        fn.restype = ctypes.c_int
        bfn = getattr(lib, self.spec.name + "_trap_batched")
        bfn.argtypes = trap_batched_argtypes()
        bfn.restype = ctypes.c_int
        rfn = getattr(lib, self.spec.name + "_trap_resident")
        rfn.argtypes = [ctypes.c_int, ctypes.c_int]
        rfn.restype = ctypes.c_int
        self.fn, self.batched_fn, self.resident_fn = fn, bfn, rfn
        return secs

    def workspace(self, dev, batched: bool):
        """The level-buffer workspace of a group: the blocks the card holds
        at once (the most over the passes that have one) times the most
        buffer elements one of their blocks takes, and that block count;
        (None, 0) where every buffer fits shared memory."""
        import torch
        passes = self.spec.trap["passes"]
        per = max(p["ws_block_bytes"] for p in passes)
        if not per:
            return None, 0

        def query():
            res = [self.resident_fn(i, int(batched))
                   for i, p in enumerate(passes) if p["ws_buffers"]]
            return min(res) if min(res) < 1 else max(res)
        esize = torch.empty((), dtype=self.dtype).element_size()
        return self._workspace_of(dev, batched, per // esize, query)

    def _ready(self, state, k: int):
        """The state's device after the group-length and device checks;
        builds on a CUDA device."""
        if k != self.K:
            raise YaskException(f"K4 advances groups of {self.K} steps, "
                                f"not {k}")
        dev = self._device_of(state)
        if dev.type not in ("cpu", "cuda"):
            raise YaskException(
                f"fused kernel: state on '{dev}' (CUDA or CPU tensors)")
        if dev.type == "cuda":
            self.build()
        return dev

    def chunk(self, state, t0: int, k: int):
        """Advance one group of K steps from ``t0``."""
        if self._ready(state, k).type == "cpu":
            return plain_chunk(self.program, state, t0, k)
        return trapezoid_chunk(self, state, t0, k)

    def batched_chunk(self, state, t0: int, k: int, nm: int):
        """Advance ``nm`` members stacked as (nm, *shape) per ring slot by
        one group of K steps from ``t0``."""
        if self._ready(state, k).type == "cpu":
            return plain_batched_chunk(self.program, state, t0, k, nm)
        return batched_trapezoid_chunk(self, state, t0, k, nm)

    def tiling(self, fuse_steps: int, members: int = 0) -> Dict[str, object]:
        """The tiling the K-step groups run with (``members``: that of a
        member batch of that many members)."""
        tr = self.spec.trap
        if self.stream:
            return self._stream_tiling(fuse_steps, members)
        out = {"kernel": "trapezoid_chunk", "name": self.spec.name,
               "fuse_steps": fuse_steps,
               "launches_per_group": len(tr["passes"]),
               "trapezoid": True, "trap_dims": list(tr["trap_dims"]),
               "block": dict(tr["block"]),
               "passes": [dict(p) for p in tr["passes"]],
               "diamond": [{k: d[k] for k in ("dim", "stride", "nbounds",
                                              "half", "band")}
                           for d in tr["diamond"]],
               "smem_bytes": self.spec.smem_bytes,
               "threads": tr["threads"], "level_buffers": tr["buffers"],
               "sub_stages": tr["sub_stages"],
               "scratch_stages": tr["scratch_stages"],
               "stage_widths": [dict(w) for w in tr["stage_widths"]],
               "ws_block_bytes": tr["ws_block_bytes"],
               "push": False, "push_vars": [], "pipeline_dmas": False,
               "skew_dims": []}
        if members:
            out.update(kernel="batched_trapezoid_chunk",
                       name=self.spec.name + "_trap_batched",
                       members=members)
        return out

    def _stream_tiling(self, fuse_steps: int, members: int) -> Dict[str, object]:
        """The stream arm's tiling: one launch per group, the plane tile
        and threads, each level's lags, the rings (depths and where they
        lie), staged and computed cells per useful point, the segments
        and, after a launch on the card, the resident blocks per launch
        kind."""
        tr = self.spec.trap
        rec = self.spec.stages_stream.record()
        per_level, mean = cuda_emit.trap_stream_cells(self.spec)
        out = {"kernel": "trapezoid_chunk", "arm": "trap_stream",
               "name": self.spec.name + "_trap_stream",
               "fuse_steps": fuse_steps, "launches_per_group": 1,
               "trapezoid": True, "trap_dims": list(tr["trap_dims"]),
               "block": dict(tr["block"]),
               "tile": [1] + rec["plane_tile"],
               "smem_bytes": rec["smem_bytes"], "threads": tr["threads"],
               "sub_stages": tr["sub_stages"],
               "scratch_stages": tr["scratch_stages"],
               "stage_widths": [dict(w) for w in tr["stage_widths"]],
               "level_lags": [list(x) for x in tr["level_lags"]],
               "computed_per_point_per_level": per_level,
               "computed_per_useful_point": mean,
               "trap_stream": dict(rec, resident_blocks={
                   k[1]: v for k, v in self._resident.items()
                   if isinstance(k, tuple)}),
               "push": False, "push_vars": [], "pipeline_dmas": True,
               "skew": True,
               "skew_dims": [self.program.ana.domain_dims[
                   self.spec.outer]]}
        if members:
            out.update(kernel="batched_trapezoid_chunk",
                       name=self.spec.name + "_trap_stream_batched",
                       members=members)
        return out
