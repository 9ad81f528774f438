"""Emit a solution's per-point update as CUDA C++ (the counterpart of
``_TileEval`` in ``yask_tpu/ops/pallas_stencil.py``).

Pallas traces ``_TileEval`` per solution; the port does what YASK itself
does and prints C++ per solution.  :func:`emit` turns an analyzed solution
into one ``Spec`` struct:

* one stage: ``Spec::point(rd, g, n, t, out)`` — a ``__host__
  __device__`` inline function computing every written var at one point
  (K1, K7 and K5 run it).  It prints the same terms in the same order as
  ``StepProgram._eval`` (and ``_TileEval.eval``), one statement per
  distinct ``skey()``, which is the common-subexpression elimination their
  memos do.  Reads go through ``rd.template at<A>(o...)``; the tile
  machinery in ``csrc/fused_step.cuh`` supplies ``rd``.
* several stages, or scratch vars (K6, K7 over its members and K5 over a
  shard's box): ``Spec::stage<K>(rd, g, n, t, out)``, one point function per sub-stage
  with the same CSE and typing.
  A stage's scratch parts become sub-stages of their own (one per write
  halo), each computed over the stage's region grown by that halo, cells
  past the domain included, into a tile with no output; the stage's
  other parts follow in one sub-stage.  A read of a scratch var, or at
  step offset ``+step_dir`` of a var an earlier stage wrote, reads the
  tile of the newest earlier sub-stage that writes it (``rd.template
  cmp<B>(o...)``), not an input; a var rewritten in a later stage gets a
  tile per writing stage, and a conditional rewrite's base is the earlier
  tile.  Stage K is computed over the block expanded by what the later
  stages read of it (:func:`_stage_expansions`), so the input halos grow
  to match.  A *pushed* var (:func:`push_eligible_vars`) lives only in
  its shared-memory tile: no input, no output.
* where the tiles fit no rung of the shared-memory ladder, the workspace
  arm: K6's body (one sub-step or several) with the tiles past shared
  memory in a device-memory workspace, one slice per resident block
  (``KernelSpec.workspace``).
* K6's body on a solution that leaves slot 0 unused (1-D and 2-D), the
  flat arm (``KernelSpec.flat``): a rung of :data:`_FLAT_LADDER` whose
  wide tile is served by fewer threads (``FLAT_NT``), the staged inputs
  in two buffers ``BUF_ELEMS`` apart (the next tile's copied while one
  computes), each output slice's pads (``out_pad``), which its kernel
  zeroes, and the workspace arm's entries (``KernelSpec.walks``: the
  resident blocks passed in, no workspace); where no rung fits, the tile
  ladder's plan with the reason (``flat_cause``).
* compile-time tables the machinery reads: which inputs ride shared memory
  (those of full-dim vars read at a spatial offset, or over an expanded
  region) and their halos, the tile extents, and for K6 the stage
  expansions and the computed tiles.  A single-stage 3-D solution read at
  a slot-0 offset also gets K1's stream arm (``csrc/stream_step.cuh``,
  entry ``<name>_stream``, and ``_stream_batched`` and ``_stream_region``
  for K7 and K5 over it): its plane tile, prefetch depth and rings
  (``tile_planner.stream_plan``) and the same-point inputs it loads ahead
  into registers; :func:`skew_engaged_dims` says whether it runs.  Past
  three domain dims the same arm takes a single-stage solution, each
  outer cell a coordinate of its work items and each input read at an
  outer offset a ring of its own, the pad pass over every slot's pads
  (entries ``YT_FUSED_STREAM_OUTER_ENTRY``: solo and K7, no K5).  A 3-D
  solution on K6's body without misc or partial-dim outputs, at element
  size 4 or 8, also gets K6's stream arm (``csrc/stream_stages.cuh``,
  entries ``<name>_stages_stream`` and ``_stages_stream_batched``): each
  sub-stage's lag (scratch sub-stages included), each staged input's and
  computed tile's ring (``tile_planner.stages_stream_plan``, over the
  slot-0 offsets each sub-stage reads, :func:`_stages_stream_plan`) and
  the outputs' pads; where no plane tile's rings fit shared memory (the
  workspace arm's solutions), the rings' placement (``ss_glob``,
  ``SS_WS_ELEMS``: ring-less staged inputs, computed rings in a
  workspace).  Past three domain dims the stream arm is a struct of its
  own beside the body, ``StreamSpec`` (one level of
  :func:`emit_trap_stream`: each sub-stage once, the outer dims windows
  of the work items; ``KernelSpec.stream_spec``, entries
  ``YT_STAGES_STREAM_OUTER_ENTRIES``).
* K4, one K-step group of ``-trapezoid`` (:func:`resolve_trapezoid`):
  the two-phase passes (:func:`emit_trapezoid`, ``csrc/trapezoid.cuh``)
  or, under ``-skew`` on what K6's stream arm takes, K4's stream arm
  (:func:`emit_trap_stream`): a ``TrapSpec`` of the K levels' sub-stages
  that ``csrc/stream_stages.cuh`` runs in one launch.

Value types follow the plain version's (PyTorch's) promotion, so the
kernel rounds where the tensors do: a tensor op with a Python scalar runs
at the tensor's dtype, scalar-only subtrees run in double, a domain index
is an ``int32`` tensor, and ``/`` on integers is true division.  At
element size 2 ``real_t`` is bfloat16 storage (``yt::bf16_t``) and the
point function computes in float, with the bfloat16 arithmetic that
``compiler/lowering.py`` defines for the plain version: a bfloat16 value
(kind ``R``, a ``float`` holding a bfloat16 value) comes from a read
(``yt::to_f``) or from an op rounded once (``yt::rbf``); a scalar or an
index that meets one is rounded to bfloat16 first; an op on indices and
scalars alone gives float32 (kind ``F``, unrounded), which wins over
bfloat16; a store rounds.  K6 keeps its stage and scratch tiles in
``real_t``, so at element size 2 each holds the value rounded once to
bfloat16, as ``yask_tpu`` stores it.  Solution dims map onto the last of
three slots (``x, y, z`` → slots 0, 1, 2; a 2-D ``x, y`` → slots 1, 2),
slot 2 being the contiguous minor dim (:func:`slot_map`).

More than three domain dims: the last three take the slots and each
outer dim takes a slot of its own past them (``w, x, y, z`` → 3, 0, 1,
2), folded into the grid (each block owns one index of every outer dim;
``Spec::NOUTER`` counts them).  A read at an outer offset is an input of
its own, the var's tensor at that offset (``KernelSpec.in_outer``), as a
misc slice is.  K6's body covers what a later stage reads at an outer
offset by *outer copies* of a sub-stage: one copy per outer offset of its
region (``sub_dw``), each a sub-stage over the slots with its inputs and
its reads of earlier tiles shifted by that offset, its tiles its own;
only the copy at offset 0 stores outputs.  The stream arms (K6's and
K4's) print each sub-stage once instead, its region reaching into the
outer slots, a read at an outer offset reading the var's one ring there
(``tile_of`` maps every such input to it, ``in_dw`` gives the offset).

Misc dims: each (var, ring slot, misc indices) a point reads is an input
of its own, the var's slice at those misc indices (its domain strides,
its own interior pointer); a var with misc axes alone has stride 0 in
every slot.  A misc index used as a value is the current equation's LHS
binding, an ``int`` constant.  Outputs are (var, LHS misc indices)
slices of one output tensor per var (``KernelSpec.out_slices``); a var
some of whose misc slices no equation writes starts from a copy of its
evicted slot (``KernelSpec.base_outputs``).  A written var lacking a
domain dim has stride 0 there: every block computes the same slab and
only the blocks holding index 0 of each missing slot store it
(``out_slab``).
"""

from __future__ import annotations

import hashlib
import itertools
import math
import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from yask_tpu_torch.utils.exceptions import YaskException
from yask_tpu_torch.compiler.lowering import dtype_name, is_bfloat16
from yask_tpu_torch.compiler.expr import (
    AddExpr,
    AndExpr,
    CompExpr,
    ConstExpr,
    DivExpr,
    Expr,
    FirstIndexExpr,
    FuncExpr,
    IndexExpr,
    IndexType,
    LastIndexExpr,
    ModExpr,
    MultExpr,
    NegExpr,
    NotExpr,
    OrExpr,
    PointVisitor,
    SubExpr,
    VarPoint,
    uses_misc_index,
)

#: Shared memory one block may use on Hopper (227 KB).
SMEM_LIMIT = 232448
#: Tile extents (points per block) tried in order until the shared-memory
#: tiles (staged inputs, and K6's computed stage tiles) fit; slot 2 is the
#: minor dim (one thread per point), slot 1 the other thread dim, slot 0
#: the loop inside each thread.  The last rungs (16 and 8 threads a block)
#: are for wide halos that fit nothing larger (ssg r=4, iso3dfd r=16).
_TILE_LADDER = ((8, 8, 64), (4, 8, 64), (2, 8, 64), (1, 8, 64),
                (1, 4, 64), (1, 2, 64), (1, 1, 64), (1, 1, 32), (1, 1, 16),
                (1, 1, 8))

#: K6's flat arm (:func:`_flat_plan`), for a solution that leaves slot 0
#: unused (1-D and 2-D): (T1, T2, threads) tiles tried in order until two
#: staged buffers and the computed tiles fit :data:`SMEM_LIMIT`; each
#: thread computes T1·T2 / threads points of a sub-stage.  A 1-D solution
#: takes T1·T2 points along its dim.  The rungs are those the registered
#: solutions take at element sizes 2, 4 and 8: 64×64 (4096 points in
#: 1-D), which phase 16 (b)'s sweep in ``chip_smoke.py`` (gaussian r=2
#: 8192²×3 on the H100, PERF.md) finds level with the fastest rung it
#: tried and which stages the fewest cells of the 4096-point tiles; 32×64
#: where 64×64 passes 227 KB (swe2d in float32, test_stages_2d in
#: float64), the sweep's next; 8×128 (swe2d in float64, not measured on
#: the card).  Where none fits, the tile ladder's plan stays
#: (``flat_cause``).
_FLAT_LADDER = ((64, 64, 512), (32, 64, 512), (8, 128, 512))
#: An SM's shared memory and the part each resident block reserves of it
#: (Hopper: 228 KB, 1 KB), for the flat arm's blocks per SM.
SM_SMEM = 233472
BLOCK_RESERVED = 1024

#: The caps on one block's slice of a device-memory workspace, where its
#: tiles do not all fit shared memory; a launch holds one slice per
#: resident block (132 at one per SM).  Both arms trade the slice for
#: recompute, and each cap is the least that keeps its arm off thin
#: tiles, so they differ:
#:
#: * K6's workspace arm (:func:`_workspace_plan`) takes the rung with the
#:   fewest computed cells per useful point under
#:   :data:`WS_STAGES_BLOCK_BYTES`.  4 MiB takes 8×8×64 for every
#:   registered solution at r=8 (ssg 3.1 MB: 12.25 cells per point there,
#:   107 at 1×4×64 under 2 MiB), about 0.4 GB in all.
#: * K4 (:func:`emit_trapezoid`) shrinks its minor tile down
#:   ``_MINOR_LADDER`` until the level buffers fit :data:`WS_BLOCK_BYTES`,
#:   but not under 8 (a thinner tile recomputes its K·r margins many
#:   times).  K4's plans on the card were measured under 2 MiB; at 4 MiB
#:   ssg r=2, tti r=2 and awp take wider minor tiles in some passes, so
#:   one cap for both would change kernels measured before.
WS_STAGES_BLOCK_BYTES = 4 << 20
WS_BLOCK_BYTES = 2 << 20

_C_TYPES = {"R": "real_t", "I": "int", "i": "int", "d": "double",
            "B": "bool", "b": "bool"}
#: element size 2: bfloat16 values (R) and float32 ones (F) in float
_C_TYPES_BF16 = dict(_C_TYPES, R="float", F="float")
_IND = " " * 8   # statement indent inside Spec::point


def fused_applicable(program) -> Tuple[bool, str]:
    """Can the emitter print this solution?  One or more domain dims (past
    three, the outer ones fold into the grid); float32, float64 and
    bfloat16 (element size 2); misc dims and misc indices as values;
    written vars (scratch ones too) over a subset of the domain dims that
    keeps the minor dim, in solution order, as ``yask_tpu``'s
    ``pallas_applicable`` admits them.  Any number of stages; scratch
    vars and vars rewritten in a later stage run on K6 (:func:`emit`).
    What this admits, ``-mode shard_pallas`` runs too: every emitted
    source carries K5's entry over its body (``<name>_region``)."""
    ana = program.ana
    nd = len(ana.domain_dims)
    if nd < 1:
        return False, "needs at least one domain dim"
    name = dtype_name(program.dtype)
    if name not in ("float32", "float64", "bfloat16"):
        return False, (f"dtype {name} (the kernel takes float32, float64 "
                       "and bfloat16)")
    minor = ana.domain_dims[-1]
    for v in program.soln.get_vars():
        if not v.is_written:
            continue
        dd = v.domain_dim_names()
        if not dd:
            return False, (f"written var '{v.get_name()}' has no domain "
                           "dims")
        if dd[-1] != minor:
            return False, (f"written var '{v.get_name()}' lacks the minor "
                           f"dim '{minor}' as its last domain dim")
        if dd != [d for d in ana.domain_dims if d in dd]:
            return False, (f"written var '{v.get_name()}' declares its "
                           "domain dims out of solution order")
    return True, "ok"


def a3_arms(program) -> List[str]:
    """The ROADMAP.md A3 arms this solution takes: more than three domain
    dims, misc-dim vars, written vars lacking a domain dim, element size
    2.  K1, K6, K7 (the member batch over either) and K5 (the shard's box
    over either) take them; K4 takes all but partial-dim writes, which
    the reference's trapezoid does not take either."""
    arms = []
    geoms = program.geoms
    dims = list(program.ana.domain_dims)
    if len(dims) > 3:
        arms.append("4-D")
    if any(kind == "misc" for g in geoms.values() for _d, kind in g.axes):
        arms.append("misc-dim vars")
    if any(g.is_written and list(g.domain_dims) != dims
           for g in geoms.values()):
        arms.append("partial-dim written vars")
    if is_bfloat16(program.dtype):
        arms.append("element size 2")
    return arms


def slot_map(dims) -> Dict[str, int]:
    """Solution dim → kernel slot: the last three dims take slots 0-2 (the
    last of them slot 2, fewer dims the last slots), each dim before them
    an outer slot 3, 4, ... in solution order."""
    dims = list(dims)
    no = max(len(dims) - 3, 0)
    inner = dims[no:]
    out = {d: 3 - len(inner) + i for i, d in enumerate(inner)}
    out.update({d: 3 + j for j, d in enumerate(dims[:no])})
    return out


def has_scratch(program) -> bool:
    """Does the solution hold scratch vars (so that K6 runs it, even with
    one stage)?"""
    return any(g.is_scratch for g in program.geoms.values())


def push_eligible_vars(program) -> Dict[str, str]:
    """Per written non-scratch var: ``"ok"`` when its computed tile can be
    PUSHED to its consumers inside the launch (no input, no output — the
    push-memory fusion of K6), else the reason it cannot.  The port's copy
    of ``yask_tpu.ops.pallas_stencil.push_eligible_vars``: the same rule
    and the same reasons, for the same program the same dict.

    A var is pushable exactly when every read of it anywhere in the
    program is a same-sub-step read of the value written this sub-step
    (step offset ``+step_dir``), its writes are unconditional over the full
    domain (so the zero ghost cells of its tile are what the padded ring
    slot would hold), and it has at least one such reader (a never-read
    written var is a final output).  Full-dim, misc-free vars only."""
    ana = program.ana
    dims = ana.domain_dims
    sd = ana.step_dir
    read_offs: Dict[str, set] = {}
    writers: Dict[str, List] = {}
    for eq in ana.eqs:
        name = eq.lhs.var_name()
        writers.setdefault(name, []).append(eq)
        pv = PointVisitor()
        eq.rhs.accept(pv)
        if eq.cond is not None:
            eq.cond.accept(pv)
        if eq.step_cond is not None:
            eq.step_cond.accept(pv)
        for p in pv.points:
            read_offs.setdefault(p.var_name(), set()).add(
                p.step_offset())
    out: Dict[str, str] = {}
    for n in sorted(program.geoms):
        g = program.geoms[n]
        if not g.is_written or g.is_scratch:
            continue
        if g.domain_dims != dims:
            out[n] = ("partial-dim written var (zero-seeded base tile "
                      "cannot reproduce the repeated-write slab)")
            continue
        if any(kind == "misc" for _dn, kind in g.axes):
            out[n] = ("misc axes (unwritten misc slices would read the "
                      "zero seed instead of the HBM values)")
            continue
        offs = read_offs.get(n, set())
        if not offs:
            out[n] = "never read (final output stays on the DMA path)"
            continue
        if offs != {sd}:
            bad = sorted(o if o is not None else 0
                         for o in offs if o != sd)
            out[n] = (f"read at step offsets {bad} (ring/same-level "
                      "reads need the HBM ring state)")
            continue
        if any(eq.cond is not None or eq.step_cond is not None
               for eq in writers.get(n, [])):
            out[n] = ("conditional write (unselected cells keep the "
                      "base tile, which a pushed var seeds with zeros)")
            continue
        out[n] = "ok"
    return out


def resolve_push(program, push) -> Tuple[List[str], List[Dict]]:
    """The vars the kernel pushes for a ``push`` request, with the reason
    records (the ``push=`` resolution of ``build_pallas_chunk``): False =
    off, None = every eligible var, True = every eligible var, raising
    when there is none."""
    reasons: List[Dict] = []
    if push is False:
        reasons.append({"code": "push_disabled",
                        "detail": "push=False requested"})
        return [], reasons
    elig = push_eligible_vars(program)
    if push is True:
        want = sorted(n for n, why in elig.items() if why == "ok")
        if not want:
            raise YaskException(f"push-memory fusion infeasible: no "
                                f"eligible vars (candidates: {elig})")
        reasons.append({"code": "push_forced", "vars": list(want)})
        return want, reasons
    pushed = []
    for n in sorted(elig):
        if elig[n] == "ok":
            pushed.append(n)
            reasons.append({"code": "push_engaged", "var": n,
                            "detail": "all reads at +step_dir ride the "
                                      "in-launch computed tile"})
        else:
            reasons.append({"code": "push_ineligible", "var": n,
                            "detail": elig[n]})
    return pushed, reasons


@dataclass
class KernelSpec:
    """What the wrapper needs to call an emitted kernel."""
    name: str                      # C entry point of K1 (or K6) / library
                                   # stem; K7's is name + "_batched"
    source: str                    # the emitted .cu
    inputs: List[Tuple[str, int]]  # (var, ring slot) per input array
    outputs: List[str]             # written var per output tensor
    tiled: List[int]               # input indices staged in smem
    tile: Tuple[int, int, int]     # points per block in slots 0, 1, 2
    smem_bytes: int
    halos: Dict[int, Tuple[Tuple[int, int], ...]] = field(
        default_factory=dict)      # tiled input → per-slot (lo, hi)
    stages: int = 1                # > 1: K6's sub-stages (entry `name`
                                   # runs them all)
    push_vars: List[str] = field(default_factory=list)
    push_reasons: List[Dict] = field(default_factory=list)
    computed: List[str] = field(default_factory=list)  # K6's stage tiles
    push_smem_bytes: int = 0       # shared memory of the pushed tiles
    #: K4 only: the trapezoid plan (K, trap_dims, block, the passes with
    #: their tiles, grids and shared memory, the diamond geometry)
    trap: Dict = field(default_factory=dict)
    #: every input → per-slot (lo, hi) reach around the box a launch
    #: computes: its read offsets, and for K6 the sub-stage regions grown
    #: past the block (K5's wrapper checks that a box's reads stay inside
    #: the pads)
    reach: Dict[int, Tuple[Tuple[int, int], ...]] = field(
        default_factory=dict)
    #: the stream arm's plan (``tile_planner.StreamPlan``; its entry is
    #: ``name + "_stream"``), or None with ``stream_cause``, the reason
    #: code and detail of why not
    stream: object = None
    stream_cause: Tuple[str, str] = None
    #: K6 only: how many of its sub-stages compute scratch vars
    scratch_stages: int = 0
    #: K6 only: per sub-stage, how far its region reaches below and above
    #: the block per slot ((lo0, lo1, lo2), (hi0, hi1, hi2))
    sub_regions: List[Tuple[Tuple[int, ...], Tuple[int, ...]]] = field(
        default_factory=list)
    #: per input: its misc indices, ((dim, index), ...) sorted (() for a
    #: var without misc axes); empty for a solution without misc dims
    in_misc: List[Tuple] = field(default_factory=list)
    #: per kernel output: (index into ``outputs``, misc indices); empty
    #: when each output tensor is one kernel output
    out_slices: List[Tuple[int, Tuple]] = field(default_factory=list)
    #: output vars whose unwritten misc slices keep the evicted slot's
    #: values: the wrapper starts them from a copy of it
    base_outputs: List[str] = field(default_factory=list)
    #: how many outer dims fold into the grid (more than 3 domain dims)
    outer: int = 0
    #: per input: its offset in each outer dim (empty when ``outer`` is 0)
    in_outer: List[Tuple[int, ...]] = field(default_factory=list)
    #: K6's workspace arm (:func:`_workspace_plan`; empty where every tile
    #: fits shared memory): the tile, the shared-memory and workspace
    #: elements per block, computed cells per useful point
    workspace: Dict = field(default_factory=dict)
    #: K6's flat arm (:func:`_flat_plan`; empty where it does not run):
    #: its reason record, tile, threads, points per thread, staged cells
    #: per point, buffer and shared-memory bytes; ``flat_cause`` is the
    #: reason code and detail where a 1-D or 2-D solution on K6's body
    #: does not take it
    flat: Dict = field(default_factory=dict)
    flat_cause: Tuple[str, str] = None
    #: K6's stream arm (``tile_planner.StagesStreamPlan``; its entries are
    #: ``name + "_stages_stream"`` and ``"_stages_stream_batched"``), or
    #: None with ``stream_cause``
    stages_stream: object = None
    #: past three domain dims: K6's stream arm's own spec (the struct
    #: ``StreamSpec`` printed beside the body in the same source, each
    #: sub-stage once without outer copies: its inputs, outputs and plan),
    #: which the stream arm's launches marshal by; None elsewhere
    stream_spec: object = None

    @property
    def walks(self) -> bool:
        """The workspace arm or the flat arm: a launch runs at most the
        card's resident blocks, each walking tiles, and the entries
        (``YT_FUSED_WS_ENTRIES``) take a workspace (none on the flat arm)
        and that block count before the stream."""
        return bool(self.workspace or self.flat)


def _hexf(v: float) -> str:
    """Exact C++17 hex-float literal of a Python float."""
    if v != v or v in (float("inf"), float("-inf")):
        raise YaskException(f"non-finite constant {v} in a stencil")
    return f"({float(v).hex()})"


def _misc_key(p) -> Tuple:
    """A var point's misc indices, ((dim, index), ...) sorted."""
    return tuple(sorted(p.misc_vals().items()))


class _Printer:
    """Post-order printer of one sub-stage's equations with structural
    CSE; the inputs, their reach and the computed tiles are shared by all
    the sub-stages of a solution.  Written values are keyed by slice:
    (var, misc indices), ``(name, ())`` for a var without misc axes."""

    def __init__(self, program, slot_of: Dict[str, int],
                 copies: bool = True):
        self.prog = program
        #: False (K4's levels): no outer copies; a read of a computed tile
        #: at an outer offset prints the offset after the three
        self.copies = copies
        self.ana = program.ana
        self.slot_of = slot_of          # solution dim → slot
        self.ns = max(3, len(slot_of))   # 3 + outer dims
        #: the outer dims, in slot order (slot 3 + j)
        self.outer = sorted((d for d, s_ in slot_of.items() if s_ >= 3),
                            key=slot_of.get)
        # bfloat16 arithmetic (the module docstring)
        self.bf16 = is_bfloat16(program.dtype)
        self.ctypes = _C_TYPES_BF16 if self.bf16 else _C_TYPES
        self.lines: List[str] = []
        self.memo: Dict[tuple, Tuple[str, str]] = {}
        self.inputs: List[Tuple[str, int]] = []
        self.in_misc: List[Tuple] = []
        self.in_outer: List[Tuple[int, ...]] = []
        self.in_index: Dict[Tuple[str, int, Tuple, Tuple], int] = {}
        #: the current equation's LHS misc binding (misc indices as values)
        self.misc_env: Dict[str, int] = {}
        # (input index) → per-slot left/right reach of the tile: the read
        # offsets plus the current sub-stage's region
        self.reach: Dict[int, List[List[int]]] = {}
        # (input index) → per-slot left/right read offsets alone (what the
        # padded array holds around the domain)
        self.raw: Dict[int, List[List[int]]] = {}
        # (input index) → does it need a shared-memory tile: read at a
        # spatial offset, or at cells of a grown region that only a tile
        # holds (a scratch sub-stage reads its same-point inputs in global
        # memory: its cells lie inside the plain version's region, hence
        # inside the allocation)
        self.tile_need: Dict[int, bool] = {}
        # (input index, and computed tile) → {sub-stage: [min, max]} of
        # its slot-0 read offsets (K6's stream arm sizes its rings by them)
        self.reads0: Dict[int, Dict[int, List[int]]] = {}
        self.cmp_reads0: Dict[int, Dict[int, List[int]]] = {}
        # and {sub-stage: its distinct read offsets} (the weights of the
        # stream arm's rings past shared memory)
        self.offs3: Dict[int, Dict[int, set]] = {}
        self.cmp_offs3: Dict[int, Dict[int, set]] = {}
        # and of computed tiles, as printed (K4's levels: the outer slots'
        # offsets after the three)
        self.cmp_offs: Dict[int, Dict[int, set]] = {}
        self.sub = 0                    # the current sub-stage (copy)
        self.base = 0                   # the sub-stage it copies
        self.dw: Tuple[int, ...] = ()   # its offset per outer dim
        self.lo = [0, 0, 0]             # its region below the block
        self.hi = [0, 0, 0]             # and above it
        self.scratch = False
        #: (slice, writing copy) → computed tile
        self.cmp_of: Dict[Tuple[Tuple, int], int] = {}
        self.cmp_geom: List[Tuple[List[int], List[int]]] = []
        #: slice → the sub-stages that write it, in order
        self.writers: Dict[Tuple, List[int]] = {}
        #: (sub-stage, outer offsets) → its copy
        self.copy_of: Dict[Tuple[int, Tuple[int, ...]], int] = {}
        self.nvals = 0

    def begin_stage(self, sub: int, u: "_Sub") -> None:
        """Start printing sub-stage (copy) ``sub``, ``u``."""
        self.lines = []
        self.memo = {}
        self.sub = sub
        self.base, self.dw = u.base, tuple(u.dw)
        self.lo, self.hi = list(u.lo), list(u.hi)
        self.scratch = u.scratch

    def earlier_writer(self, sk: Tuple):
        """The newest sub-stage before the current one that writes slice
        ``sk``, or None."""
        w = [j for j in self.writers.get(sk, []) if j < self.base]
        return w[-1] if w else None

    def writer_copy(self, sk: Tuple, offs: List[int]) -> int:
        """The copy of the newest earlier writer of slice ``sk`` that a
        read at ``offs`` (per slot) from the current copy reaches."""
        w = self.earlier_writer(sk)
        if w is None:
            raise YaskException(
                f"same-step read of '{sk[0]}' before a stage computed it")
        if not self.copies:
            return self.copy_of[(w, self.dw)]
        dw = tuple(d + offs[3 + j] for j, d in enumerate(self.dw))
        if (w, dw) not in self.copy_of:
            raise YaskException(
                f"same-step read of '{sk[0]}' at outer offsets {dw} reaches "
                "past its stage's computed region")
        return self.copy_of[(w, dw)]

    def outer_key(self, var: str, offs: List[int]) -> Tuple[int, ...]:
        """An input's offset per outer dim: the read's plus the current
        copy's, 0 in a dim the var lacks."""
        dd = self.prog.geoms[var].domain_dims
        return tuple(offs[3 + j] + d if od in dd else 0
                     for j, (od, d) in enumerate(zip(self.outer, self.dw)))

    def input_of(self, var: str, ring_idx: int, misc: Tuple = (),
                 outer: Tuple[int, ...] = ()) -> int:
        key = (var, ring_idx, misc, outer)
        if key not in self.in_index:
            self.in_index[key] = len(self.inputs)
            self.inputs.append((var, ring_idx))
            self.in_misc.append(misc)
            self.in_outer.append(outer)
            self.reach[self.in_index[key]] = [[0, 0] for _ in range(3)]
            self.raw[self.in_index[key]] = [[0, 0] for _ in range(3)]
            self.tile_need[self.in_index[key]] = False
        return self.in_index[key]

    def _note_read0(self, table, key: int, o: int) -> None:
        r = table.setdefault(key, {}).setdefault(self.sub, [o, o])
        r[0], r[1] = min(r[0], o), max(r[1], o)

    def _note_reach(self, a: int, offs: List[int]) -> None:
        self._note_read0(self.reads0, a, offs[0])
        self.offs3.setdefault(a, {}).setdefault(self.sub, set()).add(
            tuple(offs[:3]))
        for s_, o in enumerate(offs[:3]):
            lo_hi = self.reach[a][s_]
            lo_hi[0] = max(lo_hi[0], self.lo[s_] - o)
            lo_hi[1] = max(lo_hi[1], self.hi[s_] + o)
            raw = self.raw[a][s_]
            raw[0] = max(raw[0], -o)
            raw[1] = max(raw[1], o)
            if o or (not self.scratch and (self.lo[s_] or self.hi[s_])):
                self.tile_need[a] = True

    def base_read(self, sk: Tuple) -> str:
        """The base of a conditional write of slice ``sk`` at the current
        point: the value an earlier sub-stage computed (a rewrite, or an
        earlier write of a scratch var), else the evicted slot's value (0
        for a scratch var), as the plain version's ``where`` takes it."""
        name, misc = sk
        zero = [0] * self.ns
        if self.earlier_writer(sk) is not None:
            return self._computed_read(sk, zero)[0]
        if self.prog.geoms[name].is_scratch:
            return "0.0f" if self.bf16 else "real_t(0)"
        a = self.input_of(name, 0, misc, self.outer_key(name, zero))
        self._note_reach(a, zero)
        return self._wide(f"rd.template at<{a}>(0, 0, 0)")

    def _wide(self, text: str) -> str:
        """A stored value as the point function computes it (bfloat16
        widens to float)."""
        return f"yt::to_f({text})" if self.bf16 else text

    def _new(self, kind: str, text: str) -> Tuple[str, str]:
        name = f"v{self.nvals}"
        self.nvals += 1
        self.lines.append(f"{_IND}const {self.ctypes[kind]} {name} = {text};")
        return name, kind

    # -- typing (PyTorch promotion with weak Python scalars) -------------

    def _cast(self, x: Tuple[str, str], kind: str) -> str:
        text, k = x
        if k == kind or (k in "Ii" and kind in "Ii") \
                or (k in "RF" and kind in "RF"):
            return text
        if kind == "R" and self.bf16:
            # a scalar or an index meeting a bfloat16 value
            return f"yt::rbf((float)({text}))"
        return f"({self.ctypes[kind]})({text})"

    @staticmethod
    def _kind_bf16(kinds, op: str) -> str:
        """The kind of an op's result at element size 2: float32 wins,
        then bfloat16; indices with a float scalar (or divided) give
        float32, as PyTorch's and JAX's promotion do."""
        if "F" in kinds:
            return "F"
        if "R" in kinds:
            return "R"
        if "I" in kinds:
            return "F" if "d" in kinds or op == "/" else "I"
        return "d" if "d" in kinds or op == "/" else "i"

    def _rounded(self, kind: str, text: str) -> str:
        """An op's bfloat16 result, rounded once."""
        return f"yt::rbf({text})" if kind == "R" and self.bf16 else text

    def _arith(self, op: str, a, b) -> Tuple[str, str]:
        ka, kb = a[1], b[1]
        if self.bf16:
            k = self._kind_bf16((ka, kb), op)
        elif "R" in (ka, kb) or ("I" in (ka, kb) and "d" in (ka, kb)):
            k = "R"
        elif "I" in (ka, kb):
            k = "R" if op == "/" else "I"
        elif "d" in (ka, kb) or op == "/":
            k = "d"
        else:
            k = "i"
        x, y = self._cast(a, k), self._cast(b, k)
        if op == "%":
            fn = "yt::i_mod" if k in "Ii" else "yt::f_mod"
            return self._new(k, self._rounded(k, f"{fn}({x}, {y})"))
        return self._new(k, self._rounded(k, f"{x} {op} {y}"))

    # -- nodes ------------------------------------------------------------

    def ev(self, e: Expr) -> Tuple[str, str]:
        key = e.skey()
        if key in self.memo:
            return self.memo[key]
        ev = self.ev
        if isinstance(e, ConstExpr):
            r = (_hexf(e.value), "d")
        elif isinstance(e, IndexExpr):
            if e.type == IndexType.STEP:
                r = ("t", "i")
            elif e.type == IndexType.DOMAIN:
                r = (f"g[{self.slot_of[e.name]}]", "I")
            else:
                # the current equation's LHS binding; never memoized (the
                # node recurs in sibling eqs with other bindings)
                if e.name not in self.misc_env:
                    raise YaskException(
                        f"misc index '{e.name}' used as a value outside an "
                        "equation that pins it on the LHS")
                return (str(int(self.misc_env[e.name])), "i")
        elif isinstance(e, FirstIndexExpr):
            r = ("0", "i")
        elif isinstance(e, LastIndexExpr):
            r = (f"(n[{self.slot_of[e.dim.name]}] - 1)", "i")
        elif isinstance(e, VarPoint):
            r = self._read(e)
        elif isinstance(e, NegExpr):
            a = ev(e.arg)
            r = self._new(a[1], f"-({a[0]})")
        elif isinstance(e, (AddExpr, MultExpr)):
            op = "+" if isinstance(e, AddExpr) else "*"
            r = ev(e.args[0])
            for a in e.args[1:]:
                r = self._arith(op, r, ev(a))
        elif isinstance(e, (SubExpr, DivExpr, ModExpr)):
            op = {SubExpr: "-", DivExpr: "/", ModExpr: "%"}[type(e)]
            a = ev(e.lhs)
            r = self._arith(op, a, ev(e.rhs))
        elif isinstance(e, FuncExpr):
            args = [ev(a) for a in e.args]
            kinds = [a[1] for a in args]
            if all(k_ in "di" for k_ in kinds):
                k = "d"
            elif self.bf16:
                k = self._kind_bf16(kinds + ["d"], "f")
            else:
                k = "R"
            r = self._new(k, self._rounded(k, f"yt::f_{e.name}(" + ", ".join(
                self._cast(a, k) for a in args) + ")"))
        elif isinstance(e, CompExpr):
            a = ev(e.lhs)
            b = ev(e.rhs)
            kinds = (a[1], b[1])
            if self.bf16:
                k = self._kind_bf16(kinds, "cmp")
            elif "R" in kinds or ("I" in kinds and "d" in kinds):
                k = "R"
            elif "d" in kinds:
                k = "d"
            else:
                k = "i"
            tensor = any(k_ in "RIF" for k_ in kinds)
            r = self._new("B" if tensor else "b",
                          f"{self._cast(a, k)} {e.op} {self._cast(b, k)}")
        elif isinstance(e, (AndExpr, OrExpr)):
            op = "&&" if isinstance(e, AndExpr) else "||"
            a = ev(e.lhs)
            b = ev(e.rhs)
            k = "B" if "B" in (a[1], b[1]) else "b"
            r = self._new(k, f"{a[0]} {op} {b[0]}")
        elif isinstance(e, NotExpr):
            a = ev(e.arg)
            r = self._new(a[1], f"!({a[0]})")
        else:  # pragma: no cover
            raise YaskException(f"cannot emit node {type(e).__name__}")
        self.memo[key] = r
        return r

    def _read(self, p: VarPoint) -> Tuple[str, str]:
        name = p.var_name()
        misc = _misc_key(p)
        g = self.prog.geoms[name]
        so = p.step_offset()
        offs = [0] * self.ns
        for d, o in p.domain_offsets().items():
            offs[self.slot_of[d]] = o
        if g.is_scratch:
            return self._new("R", self._computed_read((name, misc),
                                                      offs)[0])
        if g.has_step and g.is_written:
            s = so if so is not None else 0
            if s == self.ana.step_dir:
                return self._new("R", self._computed_read((name, misc),
                                                          offs)[0])
            idx = g.num_slots - 1 + s * self.ana.step_dir
            if not 0 <= idx < g.num_slots:
                raise YaskException(
                    f"step offset {s} of '{name}' outside its allocation "
                    f"{g.alloc}")
        else:
            idx = 0
        a = self.input_of(name, idx, misc, self.outer_key(name, offs))
        self._note_reach(a, offs)
        return self._new("R", self._wide(
            f"rd.template at<{a}>({offs[0]}, {offs[1]}, {offs[2]})"))

    def _computed_read(self, sk: Tuple, offs: List[int]) -> Tuple[str, str]:
        """A read of this step's value of slice ``sk`` (a scratch var, or
        a written var at +step_dir): the tile of the newest earlier
        sub-stage that writes it."""
        name = sk[0]
        w = self.writer_copy(sk, offs)
        if (sk, w) not in self.cmp_of:
            raise YaskException(
                f"same-step read of '{name}' before a stage computed it")
        b = self.cmp_of[(sk, w)]
        self._note_read0(self.cmp_reads0, b, offs[0])
        self.cmp_offs3.setdefault(b, {}).setdefault(self.sub, set()).add(
            tuple(offs[:3]))
        lo, hi = self.cmp_geom[b]
        # K4 (no copies): the outer slots' regions and offsets too
        ns = 3 if self.copies else self.ns
        self.cmp_offs.setdefault(b, {}).setdefault(self.sub, set()).add(
            tuple(offs[:ns]))
        for s_, o in enumerate(offs[:ns]):
            if self.lo[s_] - o > lo[s_] or self.hi[s_] + o > hi[s_]:
                raise YaskException(
                    f"same-step read of '{name}' at offset {o} reaches past "
                    "its stage's computed region")
        return (self._wide(f"rd.template cmp<{b}>("
                           + ", ".join(str(o) for o in offs[:ns]) + ")"),
                "R")


def _masks(eq, scratch: bool) -> list:
    """The conditions that mask a write, in the plain version's order (a
    scratch write takes its domain condition alone)."""
    conds = (eq.cond,) if scratch else (eq.cond, eq.step_cond)
    return [c for c in conds if c is not None]


def _stage_expansions(ana, slot_of) -> List[List[int]]:
    """Per stage, per slot: how far past the block its region reaches so
    that every later stage can read its values there: the most, over the
    later stages' reads of this step's value of a var it writes (a read
    resolves to the newest earlier writer), of the reader's own expansion
    plus the read's width (a scratch eq's write halo included).  A chain
    of stages sums its read widths, as ``build_pallas_chunk`` shrinks its
    regions stage by stage; a stage that no later stage reads at an offset
    is not grown (AWP's boundary stages read the stresses at the point).
    Writes and reads are matched per slice (var, misc indices)."""
    writers: Dict[Tuple, List[int]] = {}
    for k, stage in enumerate(ana.stages):
        for part in stage.parts:
            for eq in part.eqs:
                w = writers.setdefault((eq.lhs.var_name(),
                                        _misc_key(eq.lhs)), [])
                if k not in w:
                    w.append(k)
    ns = max(3, len(slot_of))
    expand = [[0] * ns for _ in ana.stages]
    for j in reversed(range(len(ana.stages))):
        for part in ana.stages[j].parts:
            for eq in part.eqs:
                wh = (ana.scratch_write_halo.get(eq.lhs.var_name(), {})
                      if part.is_scratch else {})
                conds = _masks(eq, part.is_scratch)
                pv = PointVisitor()
                for e in [eq.rhs] + conds:
                    e.accept(pv)
                reads = [((p.var_name(), _misc_key(p)), p.domain_offsets(),
                          p.get_var().is_scratch()
                          or p.step_offset() == ana.step_dir)
                         for p in pv.points]
                if conds:   # the base of a conditional rewrite
                    reads.append(((eq.lhs.var_name(), _misc_key(eq.lhs)),
                                  {}, True))
                for name, offs, same_step in reads:
                    ks = [k for k in writers.get(name, []) if k < j]
                    if not same_step or not ks:
                        continue
                    e = expand[ks[-1]]
                    for d, s_ in slot_of.items():
                        o = offs.get(d, 0)
                        wl, wr = wh.get(d, (0, 0))
                        e[s_] = max(e[s_], expand[j][s_]
                                    + max(wl - min(o, 0), wr + max(o, 0)))
    return expand


def _table(fn, rows, default="-1"):
    """A compile-time table as a constexpr function (usable in device
    code)."""
    body = " : ".join(f"k == {i} ? {v}" for i, v in enumerate(rows))
    return (f"    YT_HD static constexpr int {fn}(int k) "
            f"{{ return {body + ' : ' if rows else ''}{default}; }}")


def _table2(fn, rows, default="-1"):
    body = " : ".join(f"k == {k} && j == {j} ? {v}"
                      for k, row in enumerate(rows)
                      for j, v in enumerate(row))
    return (f"    YT_HD static constexpr int {fn}(int k, int j) "
            f"{{ return {body + ' : ' if body else ''}{default}; }}")


@dataclass
class _Sub:
    """One sub-stage of K6: the scratch eqs of a part that share a write
    halo, or every non-scratch part of a stage (independent of each other,
    so one point function computes them together); past three domain
    dims, one outer copy of it (``base``, ``dw``)."""
    stage: int
    scratch: bool
    eqs: list
    lo: List[int]        # per slot, how far its region reaches below the
    hi: List[int]        # block and above it
    clip_lo: List[int]   # the plain version's region, [-clip_lo, n +
    clip_hi: List[int]   # clip_hi) per slot: cells outside hold 0
    base: int = 0        # the sub-stage an outer copy copies
    dw: Tuple[int, ...] = ()   # and its offset per outer dim


def _sub_stages(ana, slot_of, expand) -> List[_Sub]:
    """The sub-stages of every stage, in order.  A scratch var is computed
    where the plain version computes it (``StepProgram._eval_part``): over
    the domain grown by its write halo (``ana.scratch_write_halo``),
    inside the stage's region grown by the same halo."""
    ns = max(3, len(slot_of))
    subs: List[_Sub] = []
    for k, stage in enumerate(ana.stages):
        e = expand[k]
        plain = []
        for part in stage.parts:
            if not part.is_scratch:
                plain += part.eqs
                continue
            groups: Dict[tuple, list] = {}
            for eq in part.eqs:
                wl, wr = [0] * ns, [0] * ns
                for d, (l, r) in ana.scratch_write_halo.get(
                        eq.lhs.var_name(), {}).items():
                    wl[slot_of[d]], wr[slot_of[d]] = l, r
                groups.setdefault((tuple(wl), tuple(wr)), []).append(eq)
            for (wl, wr), eqs in groups.items():
                subs.append(_Sub(k, True, eqs,
                                 [e[s_] + wl[s_] for s_ in range(ns)],
                                 [e[s_] + wr[s_] for s_ in range(ns)],
                                 list(wl), list(wr)))
        if plain:
            subs.append(_Sub(k, False, plain, list(e), list(e), [0] * ns,
                             [0] * ns))
    return subs


def _whole(subs: List[_Sub]) -> List[_Sub]:
    """Each sub-stage once, over its region in every slot, the outer ones
    included (K4's levels: an outer offset is a window offset there)."""
    return [_Sub(u.stage, u.scratch, u.eqs, list(u.lo), list(u.hi),
                 u.clip_lo, u.clip_hi, i, (0,) * (len(u.lo) - 3))
            for i, u in enumerate(subs)]


def _outer_copies(subs: List[_Sub]) -> List[_Sub]:
    """Each sub-stage once per offset of its region in the outer dims
    (slots 3 and up), in order: a copy keeps the slots' region and takes
    its offsets as ``dw`` (one copy, ``dw = ()``, up to three dims)."""
    out: List[_Sub] = []
    for i, u in enumerate(subs):
        ranges = [range(-u.lo[s_], u.hi[s_] + 1)
                  for s_ in range(3, len(u.lo))]
        for dw in itertools.product(*ranges):
            out.append(_Sub(u.stage, u.scratch, u.eqs, u.lo[:3], u.hi[:3],
                            u.clip_lo, u.clip_hi, i, tuple(dw)))
    return out


@dataclass
class _Printed:
    """Every sub-stage of a solution printed: the printer (inputs, reach),
    the output tensors and the slices the point functions write, and per
    sub-stage its statements and the slices it writes."""
    pr: "_Printer"
    slot_of: Dict[str, int]
    outputs: List[str]
    slices: List[Tuple]
    stage_lines: List[List[str]]
    stage_vars: List[List[Tuple]]
    computed: List[str]
    computed_sub: List[int]
    subs: List[_Sub]
    last_writer: Dict[Tuple, int]


def _base_outputs(program, outputs, slices) -> List[str]:
    """The output vars some of whose misc slices no equation writes: their
    new level starts from a copy of the evicted ring slot."""
    import numpy as np
    out = []
    for n in outputs:
        g = program.geoms[n]
        every = int(np.prod([g.misc_ext[d] for d, k in g.axes
                             if k == "misc"]))
        if sum(1 for m, _mk in slices if m == n) < every:
            out.append(n)
    return out


def _check_applicable(program) -> None:
    ok, why = fused_applicable(program)
    if not ok:
        raise YaskException(
            f"solution '{program.soln.get_name()}' cannot use the fused "
            f"kernel: {why}; use -mode torch")


def _print(program, pushed, copies: bool = True) -> _Printed:
    """Print every sub-stage's point function (see :func:`emit`); past
    three domain dims in outer copies (K1, K6), or (``copies`` False, K4)
    once each over its region in every slot."""
    _check_applicable(program)
    ana = program.ana
    geoms = program.geoms
    dims = list(ana.domain_dims)
    slot_of = slot_map(dims)
    bases = _sub_stages(ana, slot_of, _stage_expansions(ana, slot_of))
    subs = _outer_copies(bases) if copies else _whole(bases)
    single = len(subs) == 1     # K1's point function writes the outputs
    pr = _Printer(program, slot_of, copies)

    def key(p):
        return (p.var_name(), _misc_key(p))

    for i, sub in enumerate(subs):
        pr.copy_of[(sub.base, sub.dw)] = i
    for i, sub in enumerate(bases):
        for eq in sub.eqs:
            w = pr.writers.setdefault(key(eq.lhs), [])
            if i not in w:
                w.append(i)
    # which (var, writing copy) pairs a later sub-stage reads: this step's
    # value of a written var at +step_dir, or a scratch var, reads the
    # newest earlier writer's tile (its copy at the read's outer offset);
    # so does a conditional rewrite's base.  Each pair gets a tile of its
    # own, so a rewrite never writes the tile its own points still read at
    # offsets.
    need = set()
    for i, sub in enumerate(subs):
        pr.begin_stage(i, sub)
        for eq in sub.eqs:
            pv = PointVisitor()
            for e in [eq.rhs] + _masks(eq, sub.scratch):
                e.accept(pv)
            for p in pv.points:
                g = geoms[p.var_name()]
                if g.is_scratch or (g.has_step and g.is_written
                                    and p.step_offset() == ana.step_dir):
                    offs = [0] * pr.ns
                    for d, o in p.domain_offsets().items():
                        offs[slot_of[d]] = o
                    need.add((key(p), pr.writer_copy(key(p), offs)))
            if _masks(eq, sub.scratch) \
                    and pr.earlier_writer(key(eq.lhs)) is not None:
                need.add((key(eq.lhs),
                          pr.writer_copy(key(eq.lhs), [0] * pr.ns)))
    computed: List[str] = []
    computed_sub: List[int] = []
    for i, sub in enumerate(subs):
        for sk in dict.fromkeys(key(eq.lhs) for eq in sub.eqs):
            if (sk, i) in need:
                pr.cmp_of[(sk, i)] = len(computed)
                pr.cmp_geom.append((sub.lo, sub.hi))
                computed.append(sk[0])
                computed_sub.append(i)

    outputs: List[str] = []
    slices: List[Tuple] = []
    stage_lines: List[List[str]] = []
    stage_vars: List[List[Tuple]] = []
    for i, sub in enumerate(subs):
        pr.begin_stage(i, sub)
        # a misc index used as a value binds per equation: no CSE across
        # the sub-stage's equations (lowering.py's per-eq memo)
        misc_vals = any(uses_misc_index(eq.rhs, eq.cond, eq.step_cond)
                        for eq in sub.eqs)
        names: List[Tuple] = []
        for eq in sub.eqs:
            sk = key(eq.lhs)
            name = sk[0]
            pr.misc_env = eq.lhs.misc_vals()
            if misc_vals:
                pr.memo = {}
            if sk not in names:
                names.append(sk)
                if not geoms[name].is_scratch and name not in pushed \
                        and sk not in slices:
                    slices.append(sk)
                    if name not in outputs:
                        outputs.append(name)
            # one sub-stage writes its slices straight into the outputs
            j = slices.index(sk) if single else names.index(sk)
            val = pr.ev(eq.rhs)
            sel = None
            for c in _masks(eq, sub.scratch):
                sc = pr.ev(c)
                sel = sc if sel is None else (f"({sel[0]} && {sc[0]})", "B")
            v = pr._cast(val, "R")
            if sel is None:
                pr.lines.append(f"{_IND}out[{j}] = {v};")
            else:
                # unselected points keep the base, as where(mask, val,
                # base) does in the plain version
                if not any(ln.startswith(f"{_IND}out[{j}] = ")
                           for ln in pr.lines):
                    pr.lines.insert(0, f"{_IND}out[{j}] = "
                                       f"{pr.base_read(sk)};")
                pr.lines.append(f"{_IND}if ({sel[0]}) out[{j}] = {v};")
        # every written slice must be set at every point: an
        # unconditional eq or a base copy precedes any conditional one
        for sk in names:
            j = slices.index(sk) if single else names.index(sk)
            if not any(ln.startswith(f"{_IND}out[{j}] = ")
                       for ln in pr.lines):
                raise YaskException(f"output '{sk[0]}' is never assigned")
        stage_lines.append(pr.lines)
        stage_vars.append(names)
    # the copy at outer offset 0 of each slice's last writer stores it
    zero = tuple(0 for _ in pr.outer)
    last = {sk: pr.copy_of[(w[-1], zero)] for sk, w in pr.writers.items()}
    return _Printed(pr, slot_of, outputs, slices, stage_lines, stage_vars,
                    computed, computed_sub, subs, last)


def _stream_plan(program, tiled, halos, esize):
    """The stream arm's plan for a single-stage solution, or None with
    the reason code and detail.  It takes 3 domain dims or more (past
    three, each outer cell a coordinate of the work items, as K1's body
    folds them into its grid), written vars over all of them without misc
    axes, and a staged input (K1's ``tiled``) read at a slot-0 offset; its
    rings hold K1's staged inputs with their halos (an input read at an
    outer offset is one of its own) and must fit :data:`SMEM_LIMIT`."""
    from yask_tpu_torch.ops.tile_planner import stream_plan
    dims = list(program.ana.domain_dims)
    if len(dims) < 3:
        return None, ("skew_ineligible", f"{len(dims)}-D solution: the "
                      "stream arm walks slot 0 of a 3-D domain")
    arms = [a for a in a3_arms(program) if a not in ("element size 2",
                                                     "4-D")]
    if arms:
        return None, ("skew_ineligible", f"{' and '.join(arms)}: the "
                      "stream arm writes every cell of whole output "
                      "tensors (misc and partial-dim outputs in it are "
                      "ROADMAP.md A5)")
    if not any(halos[a][0][0] or halos[a][0][1] for a in tiled):
        return None, ("skew_ineligible", "no staged input is read at a "
                      "slot-0 offset: there are no planes to carry")
    outer = (math.prod(program.sizes[d] for d in dims[:-3])
             if len(dims) > 3 else 0)
    plan = stream_plan({a: halos[a] for a in tiled},
                       [program.sizes[d] for d in dims[-3:]], esize,
                       SMEM_LIMIT, outer)
    if plan is None:
        return None, ("skew_fallback", f"the plane rings do not fit "
                      f"{SMEM_LIMIT} bytes of shared memory even at the "
                      "smallest plane tile")
    return plan, None


def _stages_stream_plan(program, pt: "_Printed", tiled, halos, esize,
                        tiles=None):
    """K6's stream arm (``csrc/stream_stages.cuh``) for a solution on K6's
    body, or None with the reason code and detail.  It takes a 3-D domain
    (scratch sub-stages included: a scratch var is a computed ring), written
    vars over every dim without misc axes, at element size 2, 4 or 8 (at 2
    its staged rings are filled with 4-byte pairs, each row from the pair
    holding its first cell)
    (``tile_planner.stages_stream_plan``: each sub-stage at its lag, each
    ring sized by the slot-0 offsets its readers read at their lags; where
    no plane tile's rings fit :data:`SMEM_LIMIT`, the rings placed past
    it, the computed ones that do not fit in a workspace slice of at most
    :data:`WS_STAGES_BLOCK_BYTES` per block); ``tiles`` replaces the plan's
    ladder of plane tiles."""
    from yask_tpu_torch.ops.tile_planner import (STAGES_STREAM_TILES,
                                                 stages_stream_plan)
    dims = list(program.ana.domain_dims)
    if len(dims) != 3:
        return None, ("skew_ineligible", f"{len(dims)}-D solution: K6's "
                      "stream arm walks slot 0 of a 3-D domain (its other "
                      "dims are ROADMAP.md A5)")
    arms = [a for a in a3_arms(program) if a != "element size 2"]
    if arms:
        return None, ("skew_ineligible", f"{' and '.join(arms)}: the "
                      "stream arm writes every cell of whole output "
                      "tensors (misc and partial-dim outputs in it are "
                      "ROADMAP.md A5)")
    pr = pt.pr

    def offsets(reads):
        return {j: (-lo, hi) for j, (lo, hi) in reads.items()}
    plan = stages_stream_plan(
        {a: halos[a] for a in tiled},
        {a: offsets(pr.reads0[a]) for a in tiled},
        [(tuple(u.lo[:3]), tuple(u.hi[:3])) for u in pt.subs],
        list(pt.computed_sub),
        [offsets(pr.cmp_reads0[b]) for b in range(len(pt.computed))],
        [program.sizes[d] for d in dims], esize, SMEM_LIMIT,
        tiles or STAGES_STREAM_TILES,
        in_nreads={a: {j: len(o) for j, o in pr.offs3[a].items()}
                   for a in tiled},
        cmp_nreads=[{j: len(o) for j, o in pr.cmp_offs3[b].items()}
                    for b in range(len(pt.computed))],
        ws_limit=WS_STAGES_BLOCK_BYTES)
    if plan is None:
        return None, ("skew_fallback", "the computed rings of K6's stream "
                      f"arm exceed {SMEM_LIMIT} bytes of shared memory and "
                      f"{WS_STAGES_BLOCK_BYTES} bytes of workspace per block "
                      "at every plane tile (ROADMAP.md A5)")
    return plan, None


def _outer_stream(program, pushed, tiles=None):
    """K6's stream arm past three domain dims: the sub-step's sub-stages
    once each over their regions in every slot (no outer copies), the
    outer dims windows of the work items, as one level of
    :func:`emit_trap_stream` (struct ``StreamSpec``).  Returns (its
    :class:`KernelSpec`, None) or (None, the reason code and detail: that
    function's refusals, or pushed vars)."""
    if pushed:
        return None, ("skew_ineligible", f"pushed var(s) {pushed} past three "
                      "domain dims: K6's 4-D stream arm keeps every written "
                      "var's output (ROADMAP.md A5)")
    return emit_trap_stream(program, 1, [], {}, SMEM_LIMIT, tiles,
                            struct="StreamSpec")


def _placement(rec) -> str:
    """The reason detail's account of rings past shared memory (K6's
    stream arm's record), or "" where every ring fits it."""
    glob = [a for a, p in rec["ring_places"].items() if p == "global"]
    ws = [b for b, p in enumerate(rec["computed_ring_places"])
          if p == "workspace"]
    if not glob and not ws:
        return ""
    return (f"; rings past shared memory: staged input(s) {glob} read from "
            f"their allocations, computed ring(s) {ws} in a workspace of "
            f"{rec['ws_block_bytes']} B per block, at most "
            f"{rec['ws_blocks']} blocks ({rec['ws_total_bytes']} B)")


def skew_engaged_dims(program, skew=None, max_dims: int = 2,
                      reasons: List[Dict] = None, spec: KernelSpec = None,
                      batched: bool = False, region: bool = False,
                      members: int = 0) -> List[str]:
    """The dims the stream arms walk for a ``skew`` request: the port's
    counterpart of ``yask_tpu``'s ``skew_engaged_dims`` and of the skew
    resolution of ``build_pallas_chunk`` (pallas_stencil.py:366-441,
    :940-990), with its reason codes.  ``False`` = off
    (``skew_disabled``), ``None`` = auto (the ``-skew`` default: engaged
    wherever an arm can run), ``True`` = forced (raises where it cannot).
    The port streams one dim, slot 0 (the outermost domain dim), one level
    per launch (ROADMAP.md C11): K1's stream arm for a single-stage 3-D
    solution, and past three dims with each outer cell a coordinate of
    its work items (``spec.stream``; kernel ``stream_batched`` over
    member batches, ``stream_region`` over a shard's 3-D box), K6's
    (``spec.stages_stream``, kernel ``stages_stream``) for a multi-stage
    or scratch one, its rings past shared memory where they fit no plane
    tile, solo, over member batches (K7, ``batched``) or over a shard's
    box (K5, ``region``, kernel ``stages_stream_region``); ``max_dims`` <
    1 (``-skew_dims 0``) leaves it out.  The solutions neither arm takes
    keep their kernel with the emitter's reason (``spec.stream_cause``,
    :func:`_stream_plan`); K5 over a 4-D box keeps its body.
    Returns ``[slot-0 dim]`` or ``[]``; ``spec`` is ``emit(program)``, and
    ``members`` a batch's members (K1's arm: its segment in the detail)."""
    if reasons is None:
        reasons = []
    if skew is False:
        reasons.append({"code": "skew_disabled",
                        "detail": "skew=False requested (-no-skew)"})
        return []
    dims = list(program.ana.domain_dims)
    lead = dims[:-1]
    cause = None   # (reason code, detail)
    if not program.ana.eqs:
        cause = ("skew_ineligible", "no equations: a step launches nothing")
    elif max_dims < 1:
        cause = ("skew_ineligible",
                 f"outside the -skew_dims {max_dims} window")
    else:
        if spec is None:
            spec = emit(program)
        cause = spec.stream_cause
    if cause is not None:
        if skew is True:
            raise YaskException(f"stream arm (skew) infeasible: {cause[1]}")
        for d in lead or dims:
            reasons.append({"code": cause[0], "dim": d, "detail": cause[1]})
        return []
    if region and spec.outer:
        cause = ("skew_ineligible", f"{len(dims)}-D solution: K5 over K1's "
                 "and K6's stream arms walks a 3-D box (its outer dims are "
                 "ROADMAP.md A5)")
        if skew is True:
            raise YaskException(f"stream arm (skew) infeasible: {cause[1]}")
        for d in lead:
            reasons.append({"code": cause[0], "dim": d, "detail": cause[1]})
        return []
    # the walk's dim: slot 0 (past three dims the first of the last three)
    d0 = dims[spec.outer]
    code = "skew_forced" if skew is True else "skew_engaged"
    if spec.stages_stream is not None:
        rec = spec.stages_stream.record()
        over = (" over member batches" if batched
                else " over a shard's box" if region else "")
        if "outer_window" in rec:
            over += (f", outer window {rec['outer_window']} in "
                     f"{', '.join(dims[:spec.outer])}")
        reasons.append({
            "code": code, "dim": d0,
            "kernel": "stages_stream_region" if region else "stages_stream",
            "detail": f"K6's slot-0 stream{over}, one "
                      f"level per launch: plane tile {rec['plane_tile']} by "
                      f"{rec['threads']} threads, prefetch "
                      f"{rec['prefetch']}, sub-stage lags {rec['lags']}, "
                      f"rings {rec['ring_depths']} planes (computed "
                      f"{rec['computed_ring_depths']}), "
                      f"{rec['smem_bytes']} B, {rec['segments']} "
                      f"segment(s) of {rec['segment_planes']} planes, "
                      f"{rec['staged_per_point']} staged and "
                      f"{rec['computed_per_point']} computed cells per "
                      f"point{_placement(rec)}"})
    else:
        rec = spec.stream.record()
        seg, segs, where = rec["segment_planes"], rec["segments"], ""
        if batched and members:
            # the batch's members' columns in the waves
            seg, segs = spec.stream.segments_of(
                program.sizes[d0], spec.stream.blocks
                // spec.stream.segments * members)
            where = f" for {members} members"
        elif region:
            where = " at the shard's interior (each box at its own extents)"
        over = (" over member batches" if batched
                else " over a shard's box" if region else "")
        if spec.outer:
            over += (f", {rec['outer_cells']} outer cell(s) in "
                     f"{', '.join(dims[:spec.outer])} as work-item "
                     "coordinates")
        row = {"code": code, "dim": d0,
               "detail": f"slot-0 stream{over}, one level per launch: "
                         f"plane tile {rec['plane_tile']} by "
                         f"{rec['plane_tile'][0] * rec['plane_tile'][1]} "
                         f"threads, prefetch {rec['prefetch']}, rings "
                         f"{rec['ring_depths']} planes, "
                         f"{rec['smem_bytes']} B, {segs} segment(s) of "
                         f"{seg} planes" + where}
        if batched or region:
            row["kernel"] = "stream_batched" if batched else "stream_region"
        reasons.append(row)
    for d in lead:
        if d != d0:
            reasons.append({"code": "skew_ineligible", "dim": d,
                            "detail": "the port streams slot 0 only "
                                      "(ROADMAP.md C11)"
                                      + (("; an outer dim is a window of "
                                          "its work items"
                                          if spec.stages_stream is not None
                                          else "; an outer dim is a "
                                          "coordinate of its work items")
                                         if d in dims[:spec.outer]
                                         else "")})
    return [d0]


def _place(sizes: List[int], limit: int) -> Tuple[List[int], int, int]:
    """First fit, in order, of tiles of ``sizes`` elements into ``limit``
    elements of shared memory: each tile's offset (a tile that does not
    fit what is left goes to the workspace, at offsets from the shared
    elements on), the shared elements and the workspace elements."""
    where, sm, wsn = [], 0, 0
    for c in sizes:
        if sm + c <= limit:
            where.append((True, sm))
            sm += c
        else:
            where.append((False, wsn))
            wsn += c
    return [o if inside else sm + o for inside, o in where], sm, wsn


def _workspace_plan(rungs, sizes_of, cells_of, esize: int) -> Dict:
    """K6's workspace arm, where no rung fits :data:`SMEM_LIMIT`: the
    tiles (staged inputs, then computed tiles) take shared memory in order
    while they fit, the rest a workspace slice per resident block.  The
    rung is the one with the fewest computed cells per useful point whose
    slice fits :data:`WS_STAGES_BLOCK_BYTES` (the first such on a tie),
    else the one with the smallest slice.  A slice is a whole number of
    16-byte units, so every block's slice is aligned alike."""
    best = None
    for t3 in rungs:
        offs, sm, wsn = _place(sizes_of(t3), SMEM_LIMIT // esize)
        unit = 16 // esize
        wsn = -(-wsn // unit) * unit
        pts = t3[0] * t3[1] * t3[2]
        row = {"code": "workspace_engaged", "tile": t3, "offsets": offs,
               "smem_elems": sm, "ws_elems": wsn,
               "smem_bytes": sm * esize, "ws_block_bytes": wsn * esize,
               "cells_per_point": cells_of(t3) / pts}
        over = wsn * esize > WS_STAGES_BLOCK_BYTES
        key = (over, wsn if over else row["cells_per_point"])
        if best is None or key < best[0]:
            best = (key, row)
    row = best[1]
    row["detail"] = (f"no tile of the ladder fits {SMEM_LIMIT} bytes of "
                     f"shared memory: tile {row['tile']}, "
                     f"{row['smem_bytes']} B in shared memory and "
                     f"{row['ws_block_bytes']} B per resident block in a "
                     f"device-memory workspace, "
                     f"{row['cells_per_point']:.2f} computed cells per "
                     "useful point")
    return row


def _flat_plan(rungs, two_d: bool, staged_of, computed_of, nstaged: int,
               esize: int) -> Dict:
    """K6's flat arm: the first rung ``(T1, T2, threads)`` whose two
    staged buffers (each a whole number of 16-byte units, so both are
    aligned alike) and computed tiles fit :data:`SMEM_LIMIT`, or {} where
    none does.  A 1-D solution (``two_d`` False) takes T1·T2 points along
    its dim.  The blocks per SM it asks the compiler for (``min_blocks``)
    are those its shared memory and threads allow, at most two of 512
    threads (64 registers a thread).  ``staged_cells_per_point`` is per
    staged input (the mean over its ``nstaged``)."""
    unit = 16 // esize
    for t1, t2, nt in rungs:
        t3 = (1, t1, t2) if two_d else (1, 1, t1 * t2)
        staged = staged_of(t3)
        buf = -(-staged // unit) * unit
        smem = (2 * buf + computed_of(t3)) * esize
        if smem > SMEM_LIMIT:
            continue
        pts = t1 * t2
        per_in = staged / pts / max(nstaged, 1)
        per_sm = max(1, min(SM_SMEM // (smem + BLOCK_RESERVED), 2048 // nt,
                            65536 // (64 * nt)))
        return {"code": "flat_engaged", "tile": t3, "threads": nt,
                "points_per_thread": pts // nt, "buf_elems": buf,
                "staged_cells_per_point": per_in,
                "buffer_bytes": buf * esize, "smem_bytes": smem,
                "min_blocks": per_sm,
                "detail": (f"slot 0 unused: {'x'.join(map(str, t3[1:]))} "
                           f"tiles by {nt} threads ({pts // nt} points a "
                           f"thread), {per_in:.3f} staged cells per point "
                           f"and input, two staged buffers of {buf * esize} "
                           "B (cp.async fills one while a tile computes "
                           f"from the other), {smem} B of shared memory, "
                           "resident blocks walking the tiles")}
    return {}


def emit(program, push=False, ladder=_TILE_LADDER,
         flat_ladder=_FLAT_LADDER, stream_tiles=None) -> KernelSpec:
    """Print ``program`` as a CUDA C++ kernel source: K1's (and K7's, K5's)
    entries for one stage, K6's (and K7's, K5's) for several stages or scratch
    vars (one sub-stage per scratch write halo of a part, and one for the
    rest of each stage).  ``push`` is the :func:`resolve_push` request;
    the tile is the first of ``ladder`` whose shared-memory tiles fit, or
    for K6's body on a 1-D or 2-D solution the first of ``flat_ladder``
    whose two staged buffers and computed tiles fit (the flat arm,
    :func:`_flat_plan`).  A 3-D solution on K6's body, on the workspace
    arm too, carries K6's stream arm where it can run
    (:func:`_stages_stream_plan`; ``stream_tiles`` replaces its ladder of
    plane tiles).
    Where none fits, the workspace arm (:func:`_workspace_plan`): K6's
    body, for one sub-step too, with the tiles past shared memory in a
    device-memory workspace of the card's resident blocks, which walk the
    tiles (``KernelSpec.workspace``; entries ``YT_FUSED_WS_ENTRIES``).  A
    program without equations has no kernel: a step of it changes
    nothing, and this raises."""
    import numpy as np
    _check_applicable(program)
    if not program.ana.eqs:
        raise YaskException(
            f"solution '{program.soln.get_name()}' has no equations: there "
            "is no kernel to emit (its step changes nothing)")
    pushed, push_reasons = resolve_push(program, push)
    pt = _print(program, pushed)
    pr, slot_of, outputs, slices = pt.pr, pt.slot_of, pt.outputs, pt.slices
    stage_lines, stage_vars = pt.stage_lines, pt.stage_vars
    computed, computed_sub, subs = pt.computed, pt.computed_sub, pt.subs
    dims = list(program.ana.domain_dims)
    nst = len(subs)
    full = set(dims)
    esize = np.dtype(program.dtype).itemsize
    geoms = program.geoms
    no = len(pr.outer)
    # past three domain dims: the outer dims fold into the grid
    outer_enum = f", NOUTER = {no}" if no else ""
    # misc slices and partial-dim outputs
    out_slices = [(outputs.index(n), m) for n, m in slices]
    base_outputs = _base_outputs(program, outputs, slices)
    slab = [sum(1 << s_ for d, s_ in slot_of.items()
                if d not in geoms[n].domain_dims) for n, _m in slices]
    tiled = [a for a, (var, _s) in enumerate(pr.inputs)
             if set(program.geoms[var].domain_dims) == full
             and pr.tile_need[a]]
    halos = {a: tuple(tuple(x) for x in pr.reach[a]) for a in tiled}
    used = [s_ in slot_of.values() for s_ in range(3)]

    def cells(t3, lo_hi):
        c = 1
        for s_ in range(3):
            c *= t3[s_] + lo_hi[s_][0] + lo_hi[s_][1]
        return c

    def cmp_cells(t3, b):
        sub = subs[computed_sub[b]]
        return cells(t3, list(zip(sub.lo, sub.hi)))

    tile = None
    flat, flat_cause = {}, None
    if not used[0] and nst > 1:
        # K6's body on a solution that leaves slot 0 unused: the flat arm
        flat = _flat_plan(
            flat_ladder, used[1],
            lambda t3: sum(cells(t3, halos[a]) for a in tiled),
            lambda t3: sum(cmp_cells(t3, b) for b in range(len(computed))),
            len(tiled), esize)
        if flat:
            tile = flat["tile"]
        else:
            flat_cause = ("flat_fallback", "no rung of the flat ladder fits "
                          "two staged buffers and the computed tiles in "
                          f"{SMEM_LIMIT} bytes of shared memory: the tile "
                          "ladder's plan")
    for cand in ladder if tile is None else ():
        t3 = tuple(c if used[s_] else 1 for s_, c in enumerate(cand))
        smem = (sum(cells(t3, halos[a]) for a in tiled)
                + sum(cmp_cells(t3, b) for b in range(len(computed))))
        if smem * esize <= SMEM_LIMIT:
            tile = t3
            break
    ws = None
    if tile is None:
        # the workspace arm: no rung fits shared memory
        ws = _workspace_plan(
            [tuple(c if used[s_] else 1 for s_, c in enumerate(cand))
             for cand in ladder],
            lambda t3: ([cells(t3, halos[a]) for a in tiled]
                        + [cmp_cells(t3, b) for b in range(len(computed))]),
            lambda t3: sum(cells(t3, list(zip(u.lo, u.hi))) for u in subs),
            esize)
        tile = ws["tile"]
        ws["staged_in_ws"] = sum(1 for o in ws["offsets"][:len(tiled)]
                                 if o >= ws["smem_elems"])
        ws["computed_in_ws"] = sum(1 for o in ws["offsets"][len(tiled):]
                                   if o >= ws["smem_elems"])

    real_t = {2: "yt::bf16_t", 4: "float", 8: "double"}[esize]
    # the point functions' results: float at bfloat16
    out_t = "float" if esize == 2 else "real_t"
    tabs = []
    offs = 0
    tile_off = []
    for a in tiled:
        tile_off.append(offs)
        offs += cells(tile, halos[a])
    if ws is not None:
        tile_off = ws["offsets"][:len(tiled)]
        offs = ws["smem_elems"]
    if any(slab):
        # a partial-dim output: the used slots it lacks (only the blocks
        # holding index 0 of each store its slab)
        tabs.append(_table("out_slab", slab, "0"))
    tabs.append(_table("tiled_input", tiled))
    tabs.append(_table("tile_offset", tile_off, "0"))
    for s_ in range(3):
        tabs.append(_table(f"halo_lo{s_}", [halos[a][s_][0] for a in tiled],
                           "0"))
        tabs.append(_table(f"halo_hi{s_}", [halos[a][s_][1] for a in tiled],
                           "0"))
    tabs.append("    YT_HD static constexpr int tile_of(int a) { return "
                + "".join(f"a == {a} ? {k} : " for k, a in enumerate(tiled))
                + "-1; }")

    if nst == 1 and ws is None:
        body = stage_lines[0]
        plan, cause = _stream_plan(program, tiled, halos, esize)
        stream_enum = ""
        if plan is not None:
            # a ring per staged input: K1's tables give its halos
            from yask_tpu_torch.ops.tile_planner import stream_row
            ring_off, o = [], 0
            for a in tiled:
                ring_off.append(o)
                o += plan.depths[a] * ((plan.tile[0] + sum(halos[a][1]))
                                       * stream_row(plan.tile[1]
                                                    + sum(halos[a][2]),
                                                    esize))
            tabs.append(_table("ring_depth", [plan.depths[a] for a in tiled],
                               "1"))
            tabs.append(_table("ring_offset", ring_off, "0"))
            # full-dim inputs read at the point alone: the register queue
            pre = [a for a, (var, _s) in enumerate(pr.inputs)
                   if a not in tiled and not any(lo or hi
                                                 for lo, hi in pr.raw[a])
                   and list(program.geoms[var].domain_dims) == dims]
            tabs.append(_table("pre_input", pre, "0"))
            tabs.append("    YT_HD static constexpr int pre_of(int a) { "
                        "return " + "".join(f"a == {a} ? {j} : "
                                            for j, a in enumerate(pre))
                        + "-1; }")
            stream_enum = (f",\n           ST1 = {plan.tile[0]}, ST2 = "
                           f"{plan.tile[1]}, SP = {plan.prefetch}, "
                           f"STREAM_ELEMS = {o}, NPRE = {len(pre)}, "
                           f"SQ = {plan.queue}, SMIN = {plan.per_sm}")
        stem = hashlib.sha256(
            ("\n".join(body) + repr((tiled, halos, tile, real_t,
                                     len(pr.inputs), len(slices)))
             + "\n".join(tabs) + stream_enum + outer_enum)
            .encode()).hexdigest()[:12]
        name = f"fused_step_{stem}"
        stream_entry = ("" if plan is None else
                        f"YT_FUSED_STREAM_OUTER_ENTRY({name}_stream, Spec)\n"
                        if no else
                        f"YT_FUSED_STREAM_ENTRY({name}_stream, Spec)\n")
        more = (f"YT_FUSED_BATCHED_ENTRY({name}_batched, Spec)\n"
                f"YT_FUSED_REGION_ENTRY({name}_region, Spec)\n")
        src = f"""// Emitted by yask_tpu_torch.ops.cuda_emit for solution
// '{program.soln.get_name()}': one sub-step of K1, and of K7 over N members
// (see ops/fused_stencil.py).
#include "fused_step.cuh"
{'#include "stream_step.cuh"' + chr(10) if plan is not None else ''}
struct Spec {{
    typedef {real_t} real_t;
    enum {{ NIN = {len(pr.inputs)}, NOUT = {len(slices)}, NTILED = {len(tiled)},
           T0 = {tile[0]}, T1 = {tile[1]}, T2 = {tile[2]}, SMEM_ELEMS = {offs}{stream_enum}{outer_enum} }};
{chr(10).join(tabs)}

    template <class RD>
    YT_HD static inline void point(const RD& rd, const int* g, const int* n,
                                   const int t, {out_t}* out) {{
        (void)g; (void)n; (void)t;
{chr(10).join(body)}
    }}
}};

YT_FUSED_STEP_ENTRY({name}, Spec)
{more}{stream_entry}"""
        reach = {a: tuple(tuple(x) for x in pr.raw[a])
                 for a in range(len(pr.inputs))}
        return KernelSpec(name=name, source=src, inputs=list(pr.inputs),
                          outputs=outputs, tiled=tiled, tile=tile,
                          smem_bytes=offs * esize, halos=halos,
                          push_reasons=push_reasons, reach=reach,
                          stream=plan, stream_cause=cause,
                          in_misc=list(pr.in_misc), out_slices=out_slices,
                          base_outputs=base_outputs, outer=no,
                          in_outer=list(pr.in_outer) if no else [])

    # ---- K6: several sub-stages per launch (and the workspace arm, one
    #      sub-stage or several) ------------------------------------------
    sspec = None
    if nst > 1 and no:
        # past three domain dims: the stream arm's own struct, each
        # sub-stage once (the body's outer copies are its -no-skew twin)
        sspec, ss_cause = _outer_stream(program, pushed, stream_tiles)
        ss = sspec.stages_stream if sspec is not None else None
    elif nst > 1:
        ss, ss_cause = _stages_stream_plan(program, pt, tiled, halos, esize,
                                           stream_tiles)
    else:
        # one stage past shared memory: K1's stream arm keeps its rings
        # in shared memory
        ss, ss_cause = None, ("skew_fallback", "the tiles do not fit "
                              f"{SMEM_LIMIT} bytes of shared memory at any "
                              "tile: the workspace arm has no stream arm "
                              "(ROADMAP.md A5)")
    in_elems = offs
    flat_enum = ""
    if flat:
        # two staged buffers, BUF_ELEMS apart, then the computed tiles
        offs = 2 * flat["buf_elems"]
        flat_enum = (f",\n           FLAT_NT = {flat['threads']}, FLAT_MIN = "
                     f"{flat['min_blocks']}, BUF_ELEMS = {flat['buf_elems']}")
    cmp_off = []
    for b in range(len(computed)):
        cmp_off.append(offs)
        offs += cmp_cells(tile, b)
    ws_enum = ""
    if ws is not None:
        cmp_off = ws["offsets"][len(tiled):]
        in_elems = offs = ws["smem_elems"]
        ws_enum = f", WS_ELEMS = {ws['ws_elems']}"
    push_elems = sum(cmp_cells(tile, b) for b, n in enumerate(computed)
                     if n in pushed)
    # a staged input holds what its allocation holds, 0 past it: a scratch
    # sub-stage reads the pads, as the plain version does
    dim_of = {s_: d for d, s_ in slot_of.items()}
    for s_ in range(3):
        for side, fn in ((0, "alloc_lo"), (1, "alloc_hi")):
            tabs.append(_table(f"{fn}{s_}", [
                program.geoms[pr.inputs[a][0]].pads[dim_of[s_]][side]
                if s_ in dim_of else 0 for a in tiled], "0"))
    if flat or (ss is not None and not no):
        # each output slice's pads (lo, hi) per slot, which the flat arm's
        # kernel (and K6's stream arm) zeroes
        tabs.append(_table2("out_pad", [[
            geoms[n].pads[dim_of[s_]][side]
            if s_ in dim_of and dim_of[s_] in geoms[n].domain_dims else 0
            for s_ in range(3) for side in (0, 1)] for n, _m in slices],
            "0"))
    for s_ in range(3):
        tabs.append(_table(f"sub_lo{s_}", [u.lo[s_] for u in subs], "0"))
        tabs.append(_table(f"sub_hi{s_}", [u.hi[s_] for u in subs], "0"))
        tabs.append(_table(f"clip_lo{s_}", [u.clip_lo[s_] for u in subs],
                           "0"))
        tabs.append(_table(f"clip_hi{s_}", [u.clip_hi[s_] for u in subs],
                           "0"))
    if no:
        # outer copies: each one's offset and plain region per outer dim,
        # and the block indices at which a staged input's outer offset
        # stays inside its allocation (a tile past it holds 0)
        big = 1 << 29
        tabs.append(_table2("sub_dw", [u.dw for u in subs], "0"))
        tabs.append(_table2("oclip_lo", [u.clip_lo[3:] for u in subs], "0"))
        tabs.append(_table2("oclip_hi", [u.clip_hi[3:] for u in subs], "0"))
        for fn, side, sign in (("outer_alo", 0, 1), ("outer_ahi", 1, -1)):
            tabs.append(_table2(fn, [[
                geoms[pr.inputs[a][0]].pads[od][side]
                + sign * pr.in_outer[a][j]
                if od in geoms[pr.inputs[a][0]].domain_dims else big
                for j, od in enumerate(pr.outer)] for a in tiled], "0"))
    tabs.append(_table("cmp_offset", cmp_off, "0"))
    tabs.append(_table("cmp_sub", computed_sub, "0"))
    tabs.append(_table("stage_nv", [len(n) for n in stage_vars], "0"))
    tabs.append(_table2("stage_out", [
        [slices.index(sk) if sk in slices and pt.last_writer[sk] == i
         else -1 for sk in names] for i, names in enumerate(stage_vars)]))
    tabs.append(_table2("stage_cmp", [
        [pr.cmp_of.get((sk, i), -1) for sk in names]
        for i, names in enumerate(stage_vars)]))
    ss_enum = ""
    if ss is not None and not no:
        # K6's stream arm: each sub-stage's lag, each staged input's ring
        # (its lowest and highest plane around the walk's, depth and
        # offset), each computed tile's ring
        # (rings past shared memory: a ring-less staged input's ring
        # offset is 0 and ss_glob 1; a computed ring at or past SS_ELEMS
        # lies in the block's workspace slice of SS_WS_ELEMS elements)
        tabs.append(_table("ss_lag", ss.lags, "0"))
        tabs.append(_table("ss_rlo", [ss.in_reach[a][0] for a in tiled],
                           "0"))
        tabs.append(_table("ss_rhi", [ss.in_reach[a][1] for a in tiled],
                           "0"))
        tabs.append(_table("ss_depth", [ss.in_depths[a] for a in tiled],
                           "1"))
        tabs.append(_table("ss_ring", [ss.in_offsets.get(a, 0)
                                       for a in tiled], "0"))
        if ss.placed:
            tabs.append(_table("ss_glob", [int(ss.in_place[a] == "global")
                                           for a in tiled], "0"))
        tabs.append(_table("ss_clo", ss.cmp_lo, "0"))
        tabs.append(_table("ss_cdepth", ss.cmp_depths, "1"))
        tabs.append(_table("ss_cring", ss.cmp_offsets, "0"))
        ss_enum = (f",\n           SS_T1 = {ss.tile[0]}, SS_T2 = "
                   f"{ss.tile[1]}, SS_NT = {ss.threads}, SS_MIN = "
                   f"{ss.per_sm}, SS_P = {ss.prefetch}, SS_W = {ss.warm}, "
                   f"SS_ELEMS = {ss.smem_elems}")
        if ss.placed:
            ss_enum += f", SS_WS_ELEMS = {ss.ws_elems}"
    stages_src = "\n".join(
        f"        if constexpr (K == {k}) {{\n"
        + "\n".join("    " + ln for ln in lines) + "\n        }"
        for k, lines in enumerate(stage_lines))
    maxv = max(len(n) for n in stage_vars)
    struct = f"""struct Spec {{
    typedef {real_t} real_t;
    enum {{ NIN = {len(pr.inputs)}, NOUT = {len(slices)}, NTILED = {len(tiled)},
           T0 = {tile[0]}, T1 = {tile[1]}, T2 = {tile[2]}, SMEM_ELEMS = {offs},
           IN_ELEMS = {in_elems}, NSTAGES = {nst}, NCMP = {len(computed)},
           MAXV = {maxv}{outer_enum}{ws_enum}{flat_enum}{ss_enum} }};
{chr(10).join(tabs)}

    template <int K, class RD>
    YT_HD static inline void stage(const RD& rd, const int* g, const int* n,
                                   const int t, {out_t}* out) {{
        (void)rd; (void)g; (void)n; (void)t; (void)out;
{stages_src}
    }}
}};
"""
    if sspec is not None:
        # past three domain dims the stream arm's struct follows the body's
        struct += "\n" + sspec.source
    name = "fused_stages_" + hashlib.sha256(struct.encode()).hexdigest()[:12]
    nscr = sum(u.scratch for u in subs)
    stream_entries = (f"YT_STAGES_STREAM_OUTER_ENTRIES({name}, StreamSpec)\n"
                      if sspec is not None else
                      f"YT_STAGES_STREAM_ENTRIES({name}, Spec)\n")
    if ws is None and not flat:
        entries = (f"YT_FUSED_STAGES_ENTRY({name}, Spec)\n"
                   f"YT_FUSED_BATCHED_ENTRY({name}_batched, Spec)\n"
                   f"YT_FUSED_REGION_ENTRY({name}_region, Spec)\n")
        arm = ""
        if ss is not None:
            entries += stream_entries
        if ss is not None and not ss.placed:
            arm = (f"\n// Stream arm: {ss.tile[0]}x{ss.tile[1]} plane tiles by "
                   f"{ss.threads} threads, rings of {ss.smem_bytes} B.")
    else:
        entries = f"YT_FUSED_WS_ENTRIES({name}, Spec)\n"
        arm = (f"\n// Flat arm: {flat['threads']} threads a "
               f"{'x'.join(map(str, tile[1:]))} tile, two staged buffers."
               if flat else
               f"\n// Workspace arm: {ws['ws_elems']} elements per resident "
               "block past shared memory.")
        if ss is not None:
            entries += stream_entries
    if ss is not None and ss.placed:
        arm += (f"\n// Stream arm: {ss.tile[0]}x{ss.tile[1]} plane tiles by "
                f"{ss.threads} threads, rings of {ss.smem_bytes} B in shared "
                f"memory, {ss.ws_elems} elements per resident block in a "
                f"workspace, {sum(p == 'global' for p in ss.in_place.values())}"
                " staged input(s) read from their allocations.")
    if sspec is not None:
        arm += (f"\n// Stream arm's outer windows: "
                f"{'x'.join(map(str, ss.outer_tile))} in "
                f"{', '.join(dims[:no])}, each sub-stage once (StreamSpec).")
    src = f"""// Emitted by yask_tpu_torch.ops.cuda_emit for solution
// '{program.soln.get_name()}': one sub-step of K6, {nst} sub-stages per launch
// ({len(program.ana.stages)} stage(s), {nscr} of scratch vars), of K7
// over N members and of K5 over a shard's box (see ops/fused_stencil.py);
// pushed vars:
// {', '.join(pushed) or 'none'}.{arm}
#include "{'stream_stages.cuh' if ss is not None else 'fused_step.cuh'}"

{struct}
{entries}"""
    if ws is not None:
        ws = {k: v for k, v in ws.items() if k != "offsets"}
    return KernelSpec(name=name, source=src, inputs=list(pr.inputs),
                      outputs=outputs, tiled=tiled, tile=tile,
                      smem_bytes=offs * esize, halos=halos, stages=nst,
                      workspace=ws or {},
                      stream_cause=ss_cause,
                      stages_stream=ss, stream_spec=sspec,
                      push_vars=list(pushed), push_reasons=push_reasons,
                      computed=computed, push_smem_bytes=push_elems * esize,
                      scratch_stages=nscr, reach={
                          a: tuple(tuple(x) for x in pr.reach[a])
                          for a in range(len(pr.inputs))},
                      sub_regions=[(tuple(u.lo), tuple(u.hi)) for u in subs],
                      in_misc=list(pr.in_misc), out_slices=out_slices,
                      base_outputs=base_outputs, outer=no,
                      in_outer=list(pr.in_outer) if no else [],
                      flat=flat, flat_cause=flat_cause)


# ==== K4: the trapezoid/diamond two-phase tiling =========================
# The port's counterpart of the trapezoid arm of build_pallas_chunk
# (pallas_stencil.py:445-470, :812-930, :1415-1432, :1514-1553): the
# eligibility, the pad need, the resolution with its auto gate and its
# fallbacks, and the emitted Spec that csrc/trapezoid.cuh runs.

#: Threads of one K4 block: the level buffers fill shared memory, so one
#: block runs per SM, and the most a block takes (32 warps) gives the
#: level loops the most warps to hide their latency.
TRAP_THREADS = 1024
#: Minor-dim tile extents tried in order until the phase-1 buffers fit.
_MINOR_LADDER = (64, 32, 16, 8, 4, 2, 1)


def skew_eligible_dims(program, fuse_steps: int) -> List[str]:
    """The lead dims a K-step tiling other than the uniform shrink can run
    on: the eligibility test of ``yask_tpu``'s ``skew_eligible_dims``
    (pallas_stencil.py:306).  Empty unless K ≥ 2 and every written var
    spans all domain dims; then the two innermost lead dims with a fused
    radius > 0.  The reference's K-level skew carry is not ported: the
    port's stream arm (:func:`skew_engaged_dims`) carries one level per
    launch (ROADMAP.md A4b)."""
    ana = program.ana
    lead = ana.domain_dims[:-1]
    if fuse_steps < 2 or not lead:
        return []
    for g in program.geoms.values():
        if g.is_written and not g.is_scratch \
                and list(g.domain_dims) != list(ana.domain_dims):
            return []
    rad = ana.fused_step_radius()
    return [d for d in lead[-2:] if rad.get(d, 0) > 0]


def trapezoid_eligible_dims(program, fuse_steps: int) -> List[str]:
    """The lead dims the trapezoid/diamond tiling CAN run on (lead order),
    feasibility only: the skew set's geometry (pallas_stencil.py:445)."""
    return skew_eligible_dims(program, fuse_steps)


def trapezoid_pad_need(rd: int, k: int, unit: int = 1) -> int:
    """Per-side pad a trapezoid dim of fused radius ``rd`` needs at fuse
    depth ``k``: the diamond windows reach ``cl(K) + K·r`` past the
    outermost tile boundaries (the domain edges).  One definition for the
    context's pad planning and the kernel plan.  The reference adds
    ``2·sub_t`` of DMA slab rounding (pallas_stencil.py:458); the card
    copies no slabs, so the port does not."""
    if rd <= 0 or k < 2:
        return rd * max(k, 1)
    return k * rd + -(-((k - 1) * rd) // unit) * unit


def _tab(fn: str, args: Tuple[str, ...], mapping: Dict[tuple, int],
         default: int) -> str:
    """A compile-time table of any arity as a constexpr function."""
    conds = [" && ".join(f"{a} == {v}" for a, v in zip(args, key))
             + f" ? {val}" for key, val in sorted(mapping.items())
             if val != default]
    sig = ", ".join(f"int {a}" for a in args)
    body = " : ".join(conds)
    return (f"    YT_HD static constexpr int {fn}({sig}) "
            f"{{ return {body + ' : ' if conds else ''}{default}; }}")


def _pass_cells(geo) -> int:
    """Elements of one buffer of a pass: its window's cells (every slot,
    the outer ones included)."""
    cells = 1
    for g_ in geo:
        cells *= g_["tile"] + 2 * g_["marg"]
    return cells


def _pass_smem(nbuf: int, geo, esize: int) -> int:
    return nbuf * _pass_cells(geo) * esize


def _uniform(T: int, r: int, K: int) -> Dict:
    """A uniform dim: K·r margins, level L over the tile grown by
    (K−L)·r, the whole tile written."""
    return {"tile": T, "marg": K * r, "stride": T, "orig": 0,
            "reg": [(-(K - L) * r, T + (K - L) * r) for L in range(1, K + 1)],
            "wr": [(0, T)] * K}


def emit_trapezoid(program, K: int, trap_dims: List[str],
                   block: Dict[str, int],
                   smem_limit: int = SMEM_LIMIT) -> KernelSpec:
    """Print ``program`` as K4's source for one K-step group: phase 1 over
    the lead ``block`` (trapezoid in ``trap_dims``) and one diamond pass
    per trapezoid dim, each level running K6's sub-stages (:func:`_print`)
    over its buffers.  Past three domain dims the outer dims (slots 3,
    ...) are window dims of the geometry, uniform with K·r margins: each
    sub-stage is computed once over its region in every slot, and a read
    at an outer offset reads the level buffer there.  Buffers go to shared
    memory while they fit ``smem_limit`` and to a device-memory workspace
    past it.  Raises when the state's pads do not hold the diamond
    windows."""
    import numpy as np
    from yask_tpu_torch.ops.tile_planner import TilePlan
    ana = program.ana
    dims = list(ana.domain_dims)
    pt = _print(program, [], copies=False)
    pr, slot_of, subs = pt.pr, pt.slot_of, pt.subs
    ns = pr.ns                  # slots: the three, then the outer dims
    no = ns - 3
    lead = dims[:-1]
    dim_of = {s_: d for d, s_ in slot_of.items()}
    geoms = program.geoms
    tp = TilePlan(program, K, trap_dims=trap_dims)
    rad = ana.fused_step_radius()
    r = [rad.get(dim_of[s_], 0) if s_ in dim_of else 0 for s_ in range(ns)]
    n = [program.sizes[dim_of[s_]] if s_ in dim_of else 1
         for s_ in range(ns)]
    esize = np.dtype(program.dtype).itemsize
    last = pt.last_writer
    zero_o = (0,) * no

    def scratch(sk):
        return geoms[sk[0]].is_scratch

    # ---- inputs: the printed ones, then the ring slots only staging reads
    #      (at outer offset 0)
    inputs = list(pr.inputs)
    in_misc = list(pr.in_misc)
    in_outer = list(pr.in_outer) if no else [zero_o] * len(inputs)

    def in_idx(v, s, misc, outer=zero_o):
        for i, (key, m, o) in enumerate(zip(inputs, in_misc, in_outer)):
            if key == (v, s) and m == misc and o == outer:
                return i
        inputs.append((v, s))
        in_misc.append(misc)
        in_outer.append(outer)
        return len(inputs) - 1

    # per sub-stage, its reads of inputs: (input, offsets per slot, the
    # input's outer offsets after the three), as printed
    at_offs = [[(int(a), tuple(int(o) for o in offs) + in_outer[int(a)])
                for a, *offs in _AT_READ.findall("\n".join(lines))]
               for lines in pt.stage_lines]
    readers = {a: {k for k, reads in enumerate(at_offs)
                   if any(b == a for b, _o in reads)}
               for a in range(len(pr.inputs))}

    # ---- level buffers: a ring per written slice, one per staged
    #      read-only input, one per scratch or rewritten (slice, sub-stage)
    #      that a later sub-stage reads
    nbuf, base, nb = 0, {}, {}
    for sk in pt.slices:
        w, misc = sk
        g = geoms[w]
        if not g.has_step:
            raise YaskException(f"written var '{w}' has no step ring")
        ring_in = [a for a, (v, _s) in enumerate(pr.inputs)
                   if v == w and pr.in_misc[a] == misc]
        if ring_in:
            inplace = all(not any(lo or hi for lo, hi in pr.raw[a])
                          and not any(in_outer[a])
                          and readers[a] <= {last[sk]}
                          for a in ring_in if pr.inputs[a][1] == 0)
            nb[sk] = g.num_slots + (0 if inplace else 1)
        else:
            nb[sk] = 1 if (sk, last[sk]) in pr.cmp_of else 0
        if nb[sk]:
            base[sk] = nbuf
            nbuf += nb[sk]

    def buf(sk, lev):
        return base[sk] + lev % nb[sk]

    staged: Dict[int, int] = {}        # buffer → input index
    lvl_src: Dict[tuple, int] = {}
    lvl_in: Dict[tuple, int] = {}
    ring_lev: Dict[tuple, tuple] = {}  # (level, input) → (slice, its level)
    ro_buf: Dict[tuple, int] = {}      # read-only (var, slot, misc) → buffer
    for a, (v, idx) in enumerate(pr.inputs):
        sk, g = (v, pr.in_misc[a]), geoms[v]
        offs = any(lo or hi for lo, hi in pr.raw[a])
        full = list(g.domain_dims) == dims
        if nb.get(sk):
            for L in range(1, K + 1):
                lev = L - g.num_slots + idx
                lvl_src[(L, a)] = buf(sk, lev)
                ring_lev[(L, a)] = (sk, lev)
                if lev <= 0:
                    staged[buf(sk, lev)] = in_idx(v, g.num_slots - 1 + lev,
                                                  sk[1])
        elif g.is_written:
            # a misc slice no equation writes: level L reads, in global
            # memory, the slot the plain version's copy of the evicted
            # slot carries there
            for L in range(1, K + 1):
                ai = in_idx(v, (L - g.num_slots + idx - 1) % g.num_slots,
                            sk[1], in_outer[a])
                if ai != a:
                    lvl_in[(L, a)] = ai
        elif full and (offs or any(in_outer[a])):
            # one buffer per read-only slice, staged at outer offset 0; a
            # read at an outer offset reads it there
            key = (v, idx, pr.in_misc[a])
            if key not in ro_buf:
                ro_buf[key] = nbuf
                staged[nbuf] = in_idx(v, idx, pr.in_misc[a])
                nbuf += 1
            for L in range(1, K + 1):
                lvl_src[(L, a)] = ro_buf[key]
    extra: Dict[tuple, int] = {}
    cmp_buf: Dict[tuple, int] = {}
    for (sk, i), b_ in sorted(pr.cmp_of.items(), key=lambda kv: kv[1]):
        for L in range(1, K + 1):
            if not scratch(sk) and i == last[sk]:
                cmp_buf[(L, b_)] = buf(sk, L)
            else:
                if (sk, i) not in extra:
                    extra[(sk, i)] = nbuf
                    nbuf += 1
                cmp_buf[(L, b_)] = extra[(sk, i)]

    # ---- outputs: per written var, a tensor per level of the group's
    #      newest min(K, S); per tensor an entry per written slice
    k4_outputs: List[str] = []
    out_levels: List[int] = []
    out_entries: List[Tuple[int, Tuple]] = []
    out_of: Dict[tuple, int] = {}
    for w in pt.outputs:
        nback = min(K, geoms[w].num_slots)
        for L in range(K - nback + 1, K + 1):
            ti = len(k4_outputs)
            k4_outputs.append(w)
            out_levels.append(L)
            for sk in pt.slices:
                if sk[0] == w:
                    out_of[(sk, L)] = len(out_entries)
                    out_entries.append((ti, sk[1]))
    base_outputs = _base_outputs(program, pt.outputs, pt.slices)
    st_buf: Dict[tuple, int] = {}
    st_out: Dict[tuple, int] = {}
    for k, names in enumerate(pt.stage_vars):
        for j, sk in enumerate(names):
            for L in range(1, K + 1):
                if not scratch(sk) and k == last[sk]:
                    if nb[sk]:
                        st_buf[(k, j, L)] = buf(sk, L)
                    if (sk, L) in out_of:
                        st_out[(k, j, L)] = out_of[(sk, L)]
                elif (sk, k) in extra:
                    st_buf[(k, j, L)] = extra[(sk, k)]

    # ---- the pad contract: no bounds test in a trapezoid dim
    for d in trap_dims:
        need = trapezoid_pad_need(tp.rad[d], K)
        for a in staged.values():
            v = inputs[a][0]
            if min(geoms[v].pads[d]) < need:
                raise YaskException(
                    f"pads of '{v}' in '{d}' are {geoms[v].pads[d]}; the "
                    f"diamond windows need {need} per side (prepare with "
                    "-trapezoid plans them)")

    # ---- phase 1: the minor tile of the ladder whose buffers all fit
    #      shared memory; past the smallest, a workspace: the largest
    #      minor tile whose buffers fit WS_BLOCK_BYTES, but not under 8
    df = tp.dataflow(block)
    mL, _mR = tp.margins()

    def phase1(zt):
        geo = []
        for s_ in range(ns):
            d = dim_of.get(s_)
            if d is None:
                geo.append(_uniform(1, 0, K))
            elif d in trap_dims:
                T, m = block[d], mL[d]
                geo.append({
                    "tile": T, "marg": m, "stride": T, "orig": 0,
                    "reg": [(e["read"][d][0] + tp.rad[d] - m,
                             e["read"][d][1] - tp.rad[d] - m) for e in df],
                    "wr": [(e["write"][d][0] - m, e["write"][d][1] - m)
                           for e in df]})
            else:
                geo.append(_uniform(block[d] if d in lead else zt, r[s_], K))
        return geo

    zts = list(dict.fromkeys(min(z, n[2]) for z in _MINOR_LADDER))
    p1 = next((g_ for g_ in map(phase1, zts)
               if _pass_smem(nbuf, g_, esize) <= smem_limit), None)
    if p1 is None:
        zws = [z for z in zts if z >= min(8, n[2])]
        p1 = next((g_ for g_ in map(phase1, zws)
                   if _pass_smem(nbuf, g_, esize) <= WS_BLOCK_BYTES),
                  phase1(zws[-1]))
    passes = [p1]

    # ---- one diamond pass per trapezoid dim, band-wide tiles centred on
    #      every tile boundary, from level 0: uniform in the dims whose
    #      gaps an earlier pass fills, still a trapezoid (phase 1's
    #      geometry) in the trapezoid dims after it, whose own pass later
    #      fills the band's cells in their gaps
    diamonds = []
    for i_D, D in enumerate(trap_dims):
        sD = slot_of[D]
        dia = tp.diamond(D)
        half, band = dia["half"], dia["band"]
        nbounds = n[sD] // block[D] + 1
        cls = {L: tp.cl(D, L) for L in range(1, K + 1)}
        later = {slot_of[d] for d in trap_dims[i_D + 1:]}

        def diamond(tiles):
            geo = []
            for s_ in range(ns):
                if s_ == sD:
                    g_ = _uniform(band, r[s_], K)
                    g_.update(stride=block[D], orig=-half,
                              wr=[(half - cls[L], half + cls[L])
                                  for L in range(1, K + 1)])
                elif s_ in later:
                    g_ = dict(p1[s_])
                else:
                    g_ = _uniform(tiles[s_], r[s_], K)
                geo.append(g_)
            return geo

        def shrink(tiles) -> bool:
            # the minor tile first, down to 8, then the widest other
            # uniform lead tile (to a divisor of the span in a trapezoid
            # dim: no ragged tile there, which the pad contract relies on)
            if tiles[2] > 8 and sD != 2:
                tiles[2] = max(t for t in _MINOR_LADDER if t < tiles[2])
                return True
            cand = [s_ for s_ in [0, 1] + list(range(3, ns))
                    if s_ != sD and s_ not in later and tiles[s_] > 1]
            if not cand:
                return False
            s_ = max(cand, key=lambda c: tiles[c])
            if dim_of.get(s_) in trap_dims:
                tiles[s_] = max(b for b in range(1, tiles[s_])
                                if n[s_] % b == 0)
            else:
                tiles[s_] = max(1, tiles[s_] // 2)
            return True

        tiles = [p1[s_]["tile"] for s_ in range(ns)]
        geo = diamond(tiles)
        while _pass_smem(nbuf, geo, esize) > smem_limit and shrink(tiles):
            geo = diamond(tiles)
        if _pass_smem(nbuf, geo, esize) > smem_limit:
            # a workspace: phase 1's tiles, the minor one shrunk towards
            # WS_BLOCK_BYTES but not under 8
            tiles = [p1[s_]["tile"] for s_ in range(ns)]
            geo = diamond(tiles)
            while _pass_smem(nbuf, geo, esize) > WS_BLOCK_BYTES \
                    and tiles[2] > 8 and sD != 2:
                tiles[2] = max(t for t in _MINOR_LADDER if t < tiles[2])
                geo = diamond(tiles)
        passes.append(geo)
        diamonds.append({"dim": D, "stride": block[D], "nbounds": nbounds,
                         "half": half, "band": band, "cls": cls})
    for i, geo in enumerate(passes):
        for s_ in range(ns):
            g_ = geo[s_]
            g_["grid"] = (diamonds[i - 1]["nbounds"]
                          if i and s_ == slot_of[diamonds[i - 1]["dim"]]
                          else -(-n[s_] // g_["tile"]))

    # ---- the geometry holds: every sub-stage's region inside the window
    #      (and, in phase 1's trapezoid dims, grown past the level's by no
    #      more than its stage's TilePlan.stage_flow window is grown past
    #      the final stage's, plus a scratch var's write halo),
    #      every read of a staged level inside the window, every read of a
    #      computed level inside the region its writer computed
    flow = tp.stage_flow(block)
    for i, geo in enumerate(passes):
        def region(L, k, s_):
            return (geo[s_]["reg"][L - 1][0] - subs[k].lo[s_],
                    geo[s_]["reg"][L - 1][1] + subs[k].hi[s_])
        for L in range(1, K + 1):
            for k in range(len(subs)):
                for s_ in range(ns):
                    lo, hi = region(L, k, s_)
                    m_, T = geo[s_]["marg"], geo[s_]["tile"]
                    ok = -m_ <= lo and hi <= T + m_
                    d = dim_of.get(s_)
                    if i == 0 and d in trap_dims:
                        st = flow[L - 1]["stages"]
                        fw = st[subs[k].stage]["write"][d]
                        lw = st[-1]["write"][d]
                        ok = ok and (subs[k].lo[s_] - subs[k].clip_lo[s_]
                                     <= lw[0] - fw[0]
                                     and subs[k].hi[s_] - subs[k].clip_hi[s_]
                                     <= fw[1] - lw[1])
                    for a, offs in at_offs[k]:
                        if (L, a) in ring_lev and ring_lev[(L, a)][1] >= 1:
                            sk, lev = ring_lev[(L, a)]
                            wlo, whi = region(lev, last[sk], s_)
                        elif (L, a) in lvl_src:
                            wlo, whi = -m_, T + m_
                        else:
                            continue
                        ok = ok and wlo <= lo + offs[s_] \
                            and hi + offs[s_] <= whi
                    if not ok:
                        raise YaskException(
                            f"K4 geometry: sub-stage {k} of level {L} in "
                            f"pass {i}, slot {s_}: region [{lo}, {hi}) in "
                            f"a window of {T} + 2·{m_}, or a read past "
                            "what its level holds")

    # ---- where the buffers live: the first ones that fit in shared
    #      memory (the rings first), the rest in the block's workspace
    nsmem = [min(nbuf, smem_limit // (_pass_cells(geo) * esize))
             for geo in passes]

    # ---- the Spec
    real_t = {2: "yt::bf16_t", 4: "float", 8: "double"}[esize]
    out_t = "float" if esize == 2 else "real_t"
    tabs = []
    for key in ("tile", "marg", "stride", "orig", "grid"):
        tabs.append(_tab(key, ("P", "s"), {
            (i, s_): geo[s_][key] for i, geo in enumerate(passes)
            for s_ in range(ns)}, 0))
    for key, part, k_ in (("reg_lo", "reg", 0), ("reg_hi", "reg", 1),
                          ("wr_lo", "wr", 0), ("wr_hi", "wr", 1)):
        tabs.append(_tab(key, ("P", "s", "L"), {
            (i, s_, L): geo[s_][part][L - 1][k_]
            for i, geo in enumerate(passes) for s_ in range(ns)
            for L in range(1, K + 1)}, 0))
    for key in ("lo", "hi"):
        tabs.append(_tab(f"sub_{key}", ("q", "s"), {
            (k, s_): getattr(u, key)[s_] for k, u in enumerate(subs)
            for s_ in range(ns)}, 0))
        tabs.append(_tab(f"clip_{key}", ("q", "s"), {
            (k, s_): getattr(u, f"clip_{key}")[s_]
            for k, u in enumerate(subs) for s_ in range(ns)}, 0))
    if no:
        # each input's outer offsets: a read of a level buffer there
        tabs.append(_tab("in_dw", ("A", "j"), {
            (a, j): o for a, offs in enumerate(in_outer)
            for j, o in enumerate(offs)}, 0))
    tabs.append(_tab("stage_nv", ("q",), {
        (k,): len(v) for k, v in enumerate(pt.stage_vars)}, 0))
    tabs.append(_tab("st_buf", ("q", "j", "L"), st_buf, -1))
    tabs.append(_tab("st_out", ("q", "j", "L"), st_out, -1))
    tabs.append(_tab("trap_slot", ("s",), {(slot_of[d],): 1
                                           for d in trap_dims}, 0))
    tabs.append(_tab("lvl_src", ("L", "A"), lvl_src, -1))
    tabs.append(_tab("lvl_in", ("L", "A"), lvl_in, -1))
    tabs.append(_tab("cmp_buf", ("L", "B"), cmp_buf, -1))
    st_bufs = sorted(staged)
    tabs.append(_tab("staged_in", ("k",), {(k_,): staged[b]
                                           for k_, b in enumerate(st_bufs)},
                     -1))
    tabs.append(_tab("staged_buf", ("k",), {(k_,): b
                                            for k_, b in enumerate(st_bufs)},
                     -1))
    tabs.append(_tab("nsmem", ("P",), {
        (i,): ns for i, ns in enumerate(nsmem)}, 0))
    tabs.append(_tab("nws", ("P",), {
        (i,): nbuf - ns for i, ns in enumerate(nsmem)}, 0))
    stages_src = "\n".join(
        f"        if constexpr (Q == {k}) {{\n"
        + "\n".join("    " + ln for ln in lines) + "\n        }"
        for k, lines in enumerate(pt.stage_lines))
    maxv = max(len(v) for v in pt.stage_vars)
    text = f"""struct Spec {{
    typedef {real_t} real_t;
    enum {{ NIN = {len(inputs)}, NOUT = {len(out_entries)}, K = {K},
           STEP_DIR = {ana.step_dir}, NPASS = {len(passes)}, NBUF = {nbuf},
           NSTAGED = {len(staged)}, NT = {TRAP_THREADS},
           NSTAGES = {len(subs)}, MAXV = {maxv}{f', NOUTER = {no}' if no else ''} }};
{chr(10).join(tabs)}

    template <int Q, class RD>
    YT_HD static inline void stage(const RD& rd, const int* g, const int* n,
                                   const int t, {out_t}* out) {{
        (void)rd; (void)g; (void)n; (void)t; (void)out;
{stages_src}
    }}
}};
"""
    name = "trapezoid_" + hashlib.sha256(text.encode()).hexdigest()[:12]
    nscr = sum(u.scratch for u in subs)
    src = (f"// Emitted by yask_tpu_torch.ops.cuda_emit for solution\n"
           f"// '{program.soln.get_name()}': K4, one {K}-step group of the "
           f"trapezoid/diamond\n// tiling over {', '.join(trap_dims)}, "
           f"{len(subs)} sub-stage(s) per level ({nscr} of scratch vars),\n"
           f"// solo and member-batched (see ops/fused_stencil.py).\n"
           f"#include \"trapezoid.cuh\"\n\n"
           f"{text}\nYT_TRAPEZOID_ENTRY({name}, Spec)\n")

    def report(i, geo):
        cells = sum(np.prod([geo[s_]["reg"][L][1] - geo[s_]["reg"][L][0]
                             + subs[k].lo[s_] + subs[k].hi[s_]
                             for s_ in range(ns)])
                    for L in range(K) for k in range(len(subs)))
        nsm = nsmem[i]
        e = _pass_cells(geo) * esize
        return {"pass": i,
                "kernel": "trapezoid_kernel" if i == 0 else "diamond_kernel",
                "dim": None if i == 0 else diamonds[i - 1]["dim"],
                "tile": [geo[s_]["tile"] for s_ in range(ns)],
                "grid": [geo[s_]["grid"] for s_ in range(ns)],
                "smem_bytes": nsm * e, "smem_buffers": nsm,
                "ws_buffers": nbuf - nsm, "ws_block_bytes": (nbuf - nsm) * e,
                "computed_cells": int(cells) * int(np.prod(
                    [geo[s_]["grid"] for s_ in range(ns)]))}
    reports = [report(i, geo) for i, geo in enumerate(passes)]
    trap = {"K": K, "trap_dims": list(trap_dims),
            "block": {**{d: block[d] for d in lead},
                      dims[-1]: p1[2]["tile"]},
            "passes": reports, "threads": TRAP_THREADS, "buffers": nbuf,
            "sub_stages": len(subs), "scratch_stages": nscr,
            "out_levels": out_levels,
            "ws_block_bytes": max(p["ws_block_bytes"] for p in reports),
            "stage_widths": tp.stage_widths(),
            "diamond": diamonds}
    return KernelSpec(name=name, source=src, inputs=inputs,
                      outputs=k4_outputs,
                      tiled=[staged[b] for b in st_bufs],
                      tile=tuple(p1[s_]["tile"] for s_ in range(3)),
                      smem_bytes=reports[0]["smem_bytes"], trap=trap,
                      stages=len(subs), scratch_stages=nscr,
                      in_misc=in_misc, out_slices=out_entries,
                      base_outputs=base_outputs, outer=no,
                      in_outer=in_outer if no else [])


_AT_READ = re.compile(r"rd\.template at<(\d+)>\((-?\d+), (-?\d+), (-?\d+)\)")
_CMP_READ = re.compile(r"rd\.template cmp<(\d+)>\(")


def emit_trap_stream(program, K: int, trap_dims: List[str],
                     block: Dict[str, int], smem_limit: int = SMEM_LIMIT,
                     stream_tiles=None, struct: str = "TrapSpec"):
    """K4's stream arm: one K-step group as one launch of K6's stream arm
    (``csrc/stream_stages.cuh``) over the sub-stages of all K levels.
    Returns (K4's :class:`KernelSpec`, None), or (None, (reason code,
    detail)) where the arm does not take the solution: it takes what
    :func:`_stages_stream_plan` takes (written vars over every dim without
    misc axes, element size 2, 4 or 8), on three domain dims or more.

    The levels are K copies of the solution's sub-stages (:func:`_print`
    without copies).  At level L a read of ring slot ``idx`` of a written
    var (level L − S + idx, S its slots) reads the computed ring of that
    level where it is ≥ 1, else the group's input of that slot; a read of
    this step's value (``cmp``) reads this level's ring.  Each level's
    regions are the solution's grown by what the later levels read of it
    (``_stage_expansions``' rule across levels, one growth per level), so
    level L runs its sub-stages at a lag of about (K − L)·r planes along
    slot 0 and over its plane tile grown by about (K − L)·r in slots 1 and
    2; the plan (``tile_planner.stages_stream_plan``) sizes each ring by
    its readers at their lags.  Each written var's newest min(K, S)
    levels are the outputs, in the order :func:`emit_trapezoid` gives
    them, each stored by its level's last writer.

    Past three domain dims the outer slots are window dims: every region
    and growth reaches into them too, a read at an outer offset of a
    staged var reads its ring (one per var and ring slot, ``tile_of``
    mapping each of its inputs there, ``in_dw`` the offset), a read of an
    earlier level's value at an outer offset reads that level's ring
    there, and the plan picks the outer window with the plane tile.
    ``struct`` names the emitted struct: "TrapSpec" (K4), or
    "StreamSpec" for K6's and K7's 4-D stream arm (:func:`emit`, K = 1:
    the sub-step's sub-stages once, no ``trap`` record)."""
    import numpy as np
    from yask_tpu_torch.ops.tile_planner import (STAGES_STREAM_TILES,
                                                 TilePlan, stages_stream_plan)
    ana = program.ana
    dims = list(ana.domain_dims)
    esize = np.dtype(program.dtype).itemsize
    arm = "K4's stream arm" if struct == "TrapSpec" else "K6's stream arm"
    if len(dims) < 3:
        return None, ("skew_ineligible", f"{len(dims)}-D solution: {arm} "
                      "walks slot 0 of a 3-D domain (ROADMAP.md A5)")
    arms = [a for a in a3_arms(program) if a not in ("element size 2",
                                                     "4-D")]
    if arms:
        return None, ("skew_ineligible", f"{' and '.join(arms)}: {arm} "
                      "writes every cell of whole output tensors "
                      "(ROADMAP.md A5)")
    geoms = program.geoms
    pt = _print(program, [], copies=False)
    pr, subs, slices, last = pt.pr, pt.subs, pt.slices, pt.last_writer
    ns = pr.ns                  # slots: the three, then the outer dims
    no = ns - 3
    zero_o = (0,) * no
    nsub = len(subs)
    inputs = list(pr.inputs)
    in_outer = list(pr.in_outer) if no else [()] * len(inputs)

    def in_idx(v, s, outer=()):
        outer = tuple(outer) if no else ()
        for i, (key, o) in enumerate(zip(inputs, in_outer)):
            if key == (v, s) and o == outer:
                return i
        inputs.append((v, s))
        in_outer.append(outer)
        return len(inputs) - 1

    # per input of a written var: its slice, the var's slots, its slot
    ring = {}
    for a, (v, idx) in enumerate(pr.inputs):
        g = geoms[v]
        if g.is_written:
            if not g.has_step:
                return None, ("skew_ineligible", f"written var '{v}' has "
                              "no step ring")
            ring[a] = ((v, pr.in_misc[a]), g.num_slots, idx)

    def src(L, a):
        """What level L's read of input ``a`` reads: ("in", input) or
        ("x", level, slice), that level's computed ring."""
        if a not in ring:
            return ("in", a)
        sk, S, idx = ring[a]
        lev = L - S + idx
        return ("x", lev, sk) if lev >= 1 else ("in", in_idx(
            sk[0], S - 1 + lev, in_outer[a]))

    def q_of(L, k):
        return (L - 1) * nsub + k

    # every read's offsets per slot: an input's outer offset follows the
    # three (its reads all share it), a computed read's as printed
    in_offs = {a: {k: {tuple(o) + tuple(in_outer[a]) for o in offs}
                   for k, offs in per.items()}
               for a, per in pr.offs3.items()}

    # each level's growth below and above the solution's regions, from the
    # last level (none) down
    grow = {K: ([0] * ns, [0] * ns)}
    for L in range(K - 1, 0, -1):
        lo, hi = [0] * ns, [0] * ns
        for Lr in range(L + 1, K + 1):
            for a, per in in_offs.items():
                for k, offs in per.items():
                    s_ = src(Lr, a)
                    if s_[0] != "x" or s_[1] != L:
                        continue
                    w = last[s_[2]]
                    for d in range(ns):
                        lo[d] = max(lo[d], grow[Lr][0][d] + subs[k].lo[d]
                                    - min(o[d] for o in offs) - subs[w].lo[d])
                        hi[d] = max(hi[d], grow[Lr][1][d] + subs[k].hi[d]
                                    + max(o[d] for o in offs) - subs[w].hi[d])
        grow[L] = (lo, hi)
    reg = [([subs[k].lo[d] + grow[L][0][d] for d in range(ns)],
            [subs[k].hi[d] + grow[L][1][d] for d in range(ns)])
           for L in range(1, K + 1) for k in range(nsub)]

    # computed rings: per level the solution's tiles, then each written
    # slice a later level reads (its level's own tile where it has one)
    cross = sorted({(s_[1], s_[2]) for Lr in range(2, K + 1)
                    for a in pr.offs3 for s_ in [src(Lr, a)]
                    if s_[0] == "x"}, key=lambda x: (x[0], slices.index(x[1])))
    tiles, names, ring_of = [], [], {}
    for L in range(1, K + 1):
        for b, w in enumerate(pt.computed_sub):
            ring_of[("in", L, b)] = len(tiles)
            tiles.append(q_of(L, w))
            names.append(pt.computed[b])
        for lev, sk in cross:
            if lev != L:
                continue
            if (sk, last[sk]) in pr.cmp_of:
                ring_of[("x", L, sk)] = ring_of[("in", L,
                                                 pr.cmp_of[(sk, last[sk])])]
            else:
                ring_of[("x", L, sk)] = len(tiles)
                tiles.append(q_of(L, last[sk]))
                names.append(sk[0])

    # every read of a K-level sub-stage: inputs and computed rings, each
    # inside what its writer computes
    in_rd: Dict[int, Dict[int, set]] = {}
    cmp_rd: Dict[int, Dict[int, set]] = {}
    for L in range(1, K + 1):
        for a, per in in_offs.items():
            for k, offs in per.items():
                s_ = src(L, a)
                if s_[0] == "in":
                    in_rd.setdefault(s_[1], {}).setdefault(
                        q_of(L, k), set()).update(offs)
                else:
                    cmp_rd.setdefault(ring_of[s_], {}).setdefault(
                        q_of(L, k), set()).update(offs)
        for b, per in pr.cmp_offs.items():
            for k, offs in per.items():
                cmp_rd.setdefault(ring_of[("in", L, b)], {}).setdefault(
                    q_of(L, k), set()).update(offs)
    for t_, per in cmp_rd.items():
        wlo, whi = reg[tiles[t_]]
        for q, offs in per.items():
            for o in offs:
                for d in range(ns):
                    if reg[q][0][d] - o[d] > wlo[d] \
                            or reg[q][1][d] + o[d] > whi[d]:
                        raise YaskException(
                            f"K4 stream arm: sub-stage {q} reads ring "
                            f"{t_} at {o} past what sub-stage {tiles[t_]} "
                            "computes")

    # the inputs' reach around the plane tile (and the outer windows) and
    # which take a ring
    reach, raw, need = {}, {}, {}
    for a, per in in_rd.items():
        reach[a] = [[0, 0] for _ in range(ns)]
        raw[a] = [[0, 0] for _ in range(3)]
        need[a] = False
        for q, offs in per.items():
            lo, hi = reg[q]
            for o in offs:
                for d in range(ns):
                    reach[a][d][0] = max(reach[a][d][0], lo[d] - o[d])
                    reach[a][d][1] = max(reach[a][d][1], hi[d] + o[d])
                    if d < 3:
                        raw[a][d][0] = max(raw[a][d][0], -o[d])
                        raw[a][d][1] = max(raw[a][d][1], o[d])
                    if o[d] or (not subs[q % nsub].scratch
                                and (lo[d] or hi[d])):
                        need[a] = True
    # a ring per staged (var, ring slot): past three dims every input of
    # it (one per outer offset) reads that ring, which is fetched through
    # the input at outer offset 0
    groups: Dict[tuple, List[int]] = {}
    for a in sorted(in_rd):
        if list(geoms[inputs[a][0]].domain_dims) == dims:
            groups.setdefault(inputs[a], []).append(a)
    members: Dict[int, List[int]] = {}
    for key, ms in groups.items():
        if any(need[a] for a in ms):
            members[in_idx(key[0], key[1], zero_o) if no else ms[0]] = ms
    tiled = sorted(members)
    halos = {r: tuple(tuple(max(reach[a][d][i] for a in ms) for i in (0, 1))
                      for d in range(3)) for r, ms in members.items()}
    ohalos = {r: [tuple(max(reach[a][3 + j][i] for a in ms) for i in (0, 1))
                  for j in range(no)] for r, ms in members.items()}

    def offsets(per):
        return {q: (-min(o[0] for o in offs), max(o[0] for o in offs))
                for q, offs in per.items()}

    def merged(ms):
        """The slot-0 read offsets of a ring's inputs, per reader."""
        out: Dict[int, Tuple[int, int]] = {}
        for a in ms:
            for q, (lo, hi) in offsets(in_rd[a]).items():
                o = out.get(q, (lo, hi))
                out[q] = (max(o[0], lo), max(o[1], hi))
        return out
    plan = stages_stream_plan(
        halos, {r: merged(members[r]) for r in tiled},
        [(tuple(lo), tuple(hi)) for lo, hi in reg], tiles,
        [offsets(cmp_rd[t_]) for t_ in range(len(tiles))],
        [program.sizes[d] for d in dims[no:]], esize, smem_limit,
        stream_tiles or STAGES_STREAM_TILES,
        in_nreads={r: {q: sum(len(in_rd[a].get(q, ())) for a in members[r])
                       for q in set().union(*(in_rd[a] for a in members[r]))}
                   for r in tiled},
        cmp_nreads=[{q: len(o) for q, o in cmp_rd[t_].items()}
                    for t_ in range(len(tiles))],
        ws_limit=WS_STAGES_BLOCK_BYTES, by_cells=True,
        outer_n=[program.sizes[d] for d in dims[:no]], in_ohalos=ohalos)
    if plan is None:
        return None, ("skew_fallback", f"the computed rings of {arm} "
                      f"exceed {smem_limit} bytes of shared memory and "
                      f"{WS_STAGES_BLOCK_BYTES} bytes of workspace per block "
                      "at every plane tile (ROADMAP.md A5)")

    # the outputs: per written var a tensor per level of the group's newest
    # min(K, S), as emit_trapezoid lists them
    k4_outputs, out_levels, out_of = [], [], {}
    for w in pt.outputs:
        nback = min(K, geoms[w].num_slots)
        for L in range(K - nback + 1, K + 1):
            for sk in slices:
                if sk[0] == w:
                    out_of[(sk, L)] = len(k4_outputs)
            k4_outputs.append(w)
            out_levels.append(L)

    def scratch(sk):
        return geoms[sk[0]].is_scratch

    stage_out, stage_cmp, bodies = [], [], []
    for L in range(1, K + 1):
        for k, vals in enumerate(pt.stage_vars):
            stage_out.append([out_of.get((sk, L), -1)
                              if not scratch(sk) and k == last[sk] else -1
                              for sk in vals])
            stage_cmp.append([
                ring_of[("in", L, pr.cmp_of[(sk, k)])]
                if (sk, k) in pr.cmp_of else
                ring_of.get(("x", L, sk), -1)
                if not scratch(sk) and k == last[sk] else -1
                for sk in vals])

            def at(m, L=L):
                a = int(m.group(1))
                s_ = src(L, a)
                offs = ", ".join(m.group(i) for i in (2, 3, 4))
                if s_[0] == "in":
                    return f"rd.template at<{s_[1]}>({offs})"
                # an earlier level's ring, at the input's outer offset
                offs += "".join(f", {o}" for o in in_outer[a])
                return f"rd.template cmp<{ring_of[s_]}>({offs})"

            # this level's rings first, then the inputs (some of which
            # become earlier levels' rings)
            lines = [_AT_READ.sub(at, _CMP_READ.sub(
                lambda m, L=L: "rd.template cmp<"
                f"{ring_of[('in', L, int(m.group(1)))]}>(", ln))
                for ln in pt.stage_lines[k]]
            bodies.append([f"{_IND}const int t = t0 + "
                           f"({(L - 1) * ana.step_dir});", f"{_IND}(void)t;"]
                          + lines)

    dim_of = {s_: d for d, s_ in pt.slot_of.items()}
    tabs = [_table("tiled_input", tiled),
            "    YT_HD static constexpr int tile_of(int a) { return "
            + "".join(f"a == {a} ? {k} : " for k, r in enumerate(tiled)
                      for a in sorted(set(members[r]) | {r}))
            + "-1; }"]
    for s_ in range(3):
        tabs.append(_table(f"halo_lo{s_}", [halos[a][s_][0] for a in tiled],
                           "0"))
        tabs.append(_table(f"halo_hi{s_}", [halos[a][s_][1] for a in tiled],
                           "0"))
    for s_ in range(3):
        for side, fn in ((0, "alloc_lo"), (1, "alloc_hi")):
            tabs.append(_table(f"{fn}{s_}", [
                geoms[inputs[a][0]].pads[dim_of[s_]][side] for a in tiled],
                "0"))
    tabs.append(_table2("out_pad", [[
        geoms[n].pads[dim_of[s_]][side] for s_ in range(ns)
        for side in (0, 1)] for n in k4_outputs], "0"))
    for s_ in range(3):
        tabs.append(_table(f"sub_lo{s_}", [lo[s_] for lo, _hi in reg], "0"))
        tabs.append(_table(f"sub_hi{s_}", [hi[s_] for _lo, hi in reg], "0"))
        tabs.append(_table(f"clip_lo{s_}", [subs[q % nsub].clip_lo[s_]
                                            for q in range(len(reg))], "0"))
        tabs.append(_table(f"clip_hi{s_}", [subs[q % nsub].clip_hi[s_]
                                            for q in range(len(reg))], "0"))
    if no:
        # the outer dims: the window per dim, each sub-stage's region and
        # clip there, each ring's outer halo and its var's pads, each
        # input's outer offset (a read of its ring there)
        tabs.append(_table("ss_wo", list(plan.outer_tile), "1"))
        tabs.append(_table2("sub_olo", [lo[3:] for lo, _hi in reg], "0"))
        tabs.append(_table2("sub_ohi", [hi[3:] for _lo, hi in reg], "0"))
        tabs.append(_table2("oclip_lo", [subs[q % nsub].clip_lo[3:]
                                         for q in range(len(reg))], "0"))
        tabs.append(_table2("oclip_hi", [subs[q % nsub].clip_hi[3:]
                                         for q in range(len(reg))], "0"))
        tabs.append(_table2("halo_olo", [[lo for lo, _hi in ohalos[a]]
                                         for a in tiled], "0"))
        tabs.append(_table2("halo_ohi", [[hi for _lo, hi in ohalos[a]]
                                         for a in tiled], "0"))
        for side, fn in ((0, "alloc_olo"), (1, "alloc_ohi")):
            tabs.append(_table2(fn, [[geoms[inputs[a][0]].pads[dim_of[3 + j]]
                                      [side] for j in range(no)]
                                     for a in tiled], "0"))
        tabs.append(_table2("in_dw", [list(o) for o in in_outer], "0"))
    tabs.append(_table("cmp_sub", tiles, "0"))
    tabs.append(_table("stage_nv", [len(v) for v in stage_out], "0"))
    tabs.append(_table2("stage_out", stage_out))
    tabs.append(_table2("stage_cmp", stage_cmp))
    tabs.append(_table("ss_lag", plan.lags, "0"))
    tabs.append(_table("ss_rlo", [plan.in_reach[a][0] for a in tiled], "0"))
    tabs.append(_table("ss_rhi", [plan.in_reach[a][1] for a in tiled], "0"))
    tabs.append(_table("ss_depth", [plan.in_depths[a] for a in tiled], "1"))
    tabs.append(_table("ss_ring", [plan.in_offsets.get(a, 0) for a in tiled],
                       "0"))
    if plan.placed:
        tabs.append(_table("ss_glob", [int(plan.in_place[a] == "global")
                                       for a in tiled], "0"))
    tabs.append(_table("ss_clo", plan.cmp_lo, "0"))
    tabs.append(_table("ss_cdepth", plan.cmp_depths, "1"))
    tabs.append(_table("ss_cring", plan.cmp_offsets, "0"))
    ws_enum = f", SS_WS_ELEMS = {plan.ws_elems}" if plan.placed else ""
    if no:
        ws_enum += f", NOUTER = {no}"
    stages_src = "\n".join(
        f"        if constexpr (Q == {q}) {{\n"
        + "\n".join("    " + ln for ln in lines) + "\n        }"
        for q, lines in enumerate(bodies))
    real_t = {2: "yt::bf16_t", 4: "float", 8: "double"}[esize]
    # the point functions' results: float at bfloat16
    out_t = "float" if esize == 2 else "real_t"
    text = f"""struct {struct} {{
    typedef {real_t} real_t;
    enum {{ NIN = {len(inputs)}, NOUT = {len(k4_outputs)}, NTILED = {len(tiled)},
           LEVELS = {K}, NSTAGES = {len(reg)}, NCMP = {len(tiles)},
           MAXV = {max(len(v) for v in pt.stage_vars)},
           T0 = 1, T1 = {plan.tile[0]}, T2 = {plan.tile[1]},
           SS_T1 = {plan.tile[0]}, SS_T2 = {plan.tile[1]}, SS_NT = {plan.threads}, SS_MIN = {plan.per_sm}, SS_P = {plan.prefetch}, SS_W = {plan.warm}, SS_ELEMS = {plan.smem_elems}{ws_enum} }};
{chr(10).join(tabs)}

    template <int Q, class RD>
    YT_HD static inline void stage(const RD& rd, const int* g, const int* n,
                                   const int t0, {out_t}* out) {{
        (void)rd; (void)g; (void)n; (void)t0; (void)out;
{stages_src}
    }}
}};
"""
    nscr = sum(u.scratch for u in subs)
    common = dict(
        inputs=inputs, outputs=k4_outputs, tiled=tiled,
        tile=(1,) + tuple(plan.tile), smem_bytes=plan.smem_bytes,
        halos=halos, stages=nsub, computed=names, scratch_stages=nscr,
        reach={a: tuple(tuple(x) for x in raw.get(a, [[0, 0]] * 3))
               for a in range(len(inputs))},
        sub_regions=[(tuple(lo), tuple(hi)) for lo, hi in reg],
        in_misc=[()] * len(inputs),
        out_slices=[(i, ()) for i in range(len(k4_outputs))],
        stages_stream=plan, outer=no,
        in_outer=list(in_outer) if no else [])
    if struct != "TrapSpec":
        return KernelSpec(name=struct, source=text, **common), None
    name = "trap_stream_" + hashlib.sha256(text.encode()).hexdigest()[:12]
    place = ""
    if plan.placed:
        place = (f"\n// Rings past shared memory: {plan.ws_elems} elements per "
                 "resident block in a workspace, "
                 f"{sum(p == 'global' for p in plan.in_place.values())} "
                 "staged input(s) read from their allocations.")
    if no:
        place += ("\n// Outer windows of "
                  f"{'x'.join(map(str, plan.outer_tile))} in "
                  f"{', '.join(dims[:no])}.")
    src = (f"// Emitted by yask_tpu_torch.ops.cuda_emit for solution\n"
           f"// '{program.soln.get_name()}': K4's stream arm, one {K}-step "
           f"group per launch, the\n// {K} levels' {nsub} sub-stage(s) each "
           f"({nscr} of scratch vars) lagged along slot 0,\n// "
           f"{plan.tile[0]}x{plan.tile[1]} plane tiles by {plan.threads} "
           f"threads, solo and member-batched\n// (see "
           f"ops/fused_stencil.py).{place}\n"
           f"#include \"stream_stages.cuh\"\n\n"
           f"{text}\nYT_TRAP_STREAM_ENTRIES({name}, TrapSpec)\n")
    lags = [plan.lags[q_of(L, 0):q_of(L, nsub)] for L in range(1, K + 1)]
    trap = {"K": K, "trap_dims": list(trap_dims), "arm": "stream",
            "block": {d: block[d] for d in dims[:-1]},
            "threads": plan.threads, "sub_stages": nsub,
            "scratch_stages": nscr, "out_levels": out_levels,
            "level_lags": lags,
            "level_growth": [grow[L] for L in range(1, K + 1)],
            "stage_widths": TilePlan(program, K,
                                     trap_dims=trap_dims).stage_widths()}
    return KernelSpec(name=name, source=src, trap=trap, **common), None


def resolve_trapezoid(program, K: int, trapezoid=None,
                      block: Dict[str, int] = None,
                      reasons: List[Dict] = None,
                      smem_limit: int = SMEM_LIMIT, skew=False,
                      stream_tiles=None):
    """The trapezoid resolution of ``build_pallas_chunk``
    (pallas_stencil.py:812-930, :1415-1432) for one K-step group of
    ``program``: ``False`` = off, ``None`` = auto (the TilePlan gate),
    ``True`` = force the eligible dims, a list = force exactly those.
    Returns K4's :class:`KernelSpec`, or None when the group runs on K1;
    appends the reason records (``trapezoid_forced``, ``_engaged``,
    ``_gate_rejected``, ``_ineligible``, ``_fallback``, ``_diamond``).
    Auto falls back and forced raises where the reference's does: no
    eligible dim (K < 2, radius 0, a partial-dim written var), a block
    that does not divide the span or lies under the band floor, pads that
    do not hold the diamond windows.  K4 takes every arm K6 takes: several
    stages, scratch vars, rewrites, misc dims, element size 2 and more
    than three domain dims (the outer ones uniform window dims); level
    buffers past ``smem_limit`` go to a device-memory workspace.

    ``skew`` is the stream-arm request (``-skew``: None, auto, the
    context's default; False, ``-no-skew``; True, forced, raising where it
    cannot run).  Where it is not False and :func:`emit_trap_stream`
    takes the solution, the group is one launch of K4's stream arm (its
    spec's ``trap["arm"]`` is ``"stream"``, reason ``trapezoid_stream``
    with the plan; ``stream_tiles`` replaces its ladder of plane tiles,
    and rings past ``smem_limit`` go past shared memory); elsewhere the
    two-phase passes, each ``trapezoid_diamond`` record naming why the
    stream arm does not run (``stream_cause``)."""
    from yask_tpu_torch.ops.tile_planner import TilePlan, plan_blocks
    if reasons is None:
        reasons = []
    if trapezoid is False or (isinstance(trapezoid, (list, tuple, set,
                                                     frozenset))
                              and not trapezoid):
        return None
    forced = trapezoid is not None
    ana = program.ana
    lead = list(ana.domain_dims[:-1])
    sizes = program.sizes
    elig = trapezoid_eligible_dims(program, K)

    def infeasible(cause, dims):
        if forced:
            raise YaskException(f"trapezoid tiling infeasible: {cause}")
        reasons.append({"code": "trapezoid_fallback", "cause": cause,
                        "from_dims": list(dims)})
        return None

    if forced:
        want = (list(elig) if trapezoid is True
                else [d for d in lead if d in set(trapezoid)])
        bad = [d for d in want if d not in elig]
        if trapezoid is not True and len(want) != len(set(trapezoid)):
            bad += sorted(set(trapezoid) - set(want))
        if bad or not want:
            raise YaskException(
                f"trapezoid tiling needs K >= 2, radius > 0 in each dim "
                f"(only lead[-2:] can tile), and all written vars spanning "
                f"every domain dim; got K={K}, "
                f"requested={want or trapezoid}, eligible={elig}")
        trap_dims = want
        reasons.append({"code": "trapezoid_forced", "dims": list(trap_dims)})
    elif elig:
        def cost(tp):
            mb = tp.min_block() or {}
            blk = plan_blocks(program, K, min_block=mb,
                              margin_override=tp.margin_override())
            if any(blk.get(d, 0) < m for d, m in mb.items()):
                return float("inf")
            u, comp, fetch = tp.volumes(blk)
            cores = TilePlan.PARALLEL_CORES if tp.trap_dims else 1
            return (comp / cores + fetch) / max(u, 1)
        c_uni = cost(TilePlan(program, K))
        c_trp = cost(TilePlan(program, K, trap_dims=elig))
        det = (f"trap {c_trp:.2f} vs uniform {c_uni:.2f}, skew inf (K "
               f"levels per launch are ROADMAP.md A4b) (cells/useful cell, "
               f"compute/"
               f"{TilePlan.PARALLEL_CORES} + fetch, per-variant planned "
               "blocks)")
        code = ("trapezoid_engaged" if c_trp < c_uni
                else "trapezoid_gate_rejected")
        for d in elig:
            reasons.append({"code": code, "dim": d, "detail": det})
        if code != "trapezoid_engaged":
            return None
        trap_dims = list(elig)
    else:
        for d in lead:
            reasons.append({"code": "trapezoid_ineligible", "dim": d,
                            "detail": "ineligible (K<2, radius 0, or "
                                      "partial-dim written vars)"})
        return None

    tp = TilePlan(program, K, trap_dims=trap_dims)
    if block is None:
        block = plan_blocks(program, K, min_block=tp.min_block(),
                            margin_override=tp.margin_override())
    else:
        block = {d: min(block.get(d, 8), sizes[d]) for d in lead}
    for d in trap_dims:
        floor_b = tp.min_block()[d]
        if sizes[d] % block[d]:
            return infeasible(f"block {block[d]} does not divide span "
                              f"{sizes[d]} in '{d}'", trap_dims)
        if block[d] < floor_b:
            return infeasible(f"block {block[d]} < band floor {floor_b} "
                              f"in '{d}'", trap_dims)
    cause = ("skew_disabled", "skew=False requested (-no-skew)")
    if skew is not False:
        spec, cause = emit_trap_stream(program, K, trap_dims, block,
                                       smem_limit, stream_tiles)
        if spec is not None:
            reasons.append({"code": "trapezoid_stream",
                            "kernel": "trap_stream",
                            "detail": trap_stream_detail(spec)})
            return spec
        if skew is True:
            raise YaskException(f"K4's stream arm (skew) infeasible: "
                                f"{cause[1]}")
    try:
        spec = emit_trapezoid(program, K, trap_dims, block, smem_limit)
    except YaskException as e:
        return infeasible(str(e), trap_dims)
    for dia in spec.trap["diamond"]:
        reasons.append({"code": "trapezoid_diamond", "dim": dia["dim"],
                        "band": dia["band"], "nbounds": dia["nbounds"],
                        "stride": dia["stride"],
                        "stream_cause": f"{cause[0]}: {cause[1]}"})
    return spec


def trap_stream_detail(spec: KernelSpec) -> str:
    """The ``trapezoid_stream`` reason's account of K4's stream arm: one
    launch per group, the plane tile (and outer window past three domain
    dims) and threads, each level's lags, the
    rings (depths and where they lie), the staged and computed cells per
    useful point, the segments."""
    rec = spec.stages_stream.record()
    tr = spec.trap
    per_level, mean = trap_stream_cells(spec)
    outer = (f", outer window {rec['outer_window']}"
             if "outer_window" in rec else "")
    return (f"one launch per {tr['K']}-step group: K6's stream arm over the "
            f"{tr['K']} levels' {tr['sub_stages']} sub-stage(s) each, plane "
            f"tile {rec['plane_tile']}{outer} by {rec['threads']} threads, "
            "prefetch "
            f"{rec['prefetch']}, lags per level {tr['level_lags']}, rings "
            f"{rec['ring_depths']} planes (computed "
            f"{rec['computed_ring_depths']}), {rec['smem_bytes']} B, "
            f"{rec['segments']} segment(s) of {rec['segment_planes']} planes, "
            f"{rec['staged_per_point']} staged cells per point, computed "
            f"cells per point per level {per_level} ({mean} x the useful)"
            f"{_placement(rec)}")


def trap_stream_cells(spec: KernelSpec):
    """K4's stream arm's computed cells per useful point: per level (the
    mean over its sub-stages) and over the group."""
    pts = spec.stages_stream.computed_per_point
    ns, K = spec.trap["sub_stages"], spec.trap["K"]
    return ([round(sum(pts[i * ns:(i + 1) * ns]) / ns, 4) for i in range(K)],
            round(sum(pts) / (K * ns), 4))
