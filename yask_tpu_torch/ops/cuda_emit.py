"""Emit a solution's per-point update as CUDA C++ (the counterpart of
``_TileEval`` in ``yask_tpu/ops/pallas_stencil.py``).

Pallas traces ``_TileEval`` per solution; the port does what YASK itself
does and prints C++ per solution.  :func:`emit` turns an analyzed solution
into one ``Spec`` struct:

* one stage: ``Spec::point(rd, g, n, t, out)`` — a ``__host__
  __device__`` inline function computing every written var at one point
  (K1 and K7 run it).  It prints the same terms in the same order as
  ``StepProgram._eval`` (and ``_TileEval.eval``), one statement per
  distinct ``skey()``, which is the common-subexpression elimination their
  memos do.  Reads go through ``rd.template at<A>(o...)``; the tile
  machinery in ``csrc/fused_step.cuh`` supplies ``rd``.
* several stages (K6): ``Spec::stage<K>(rd, g, n, t, out)``, one point
  function per stage with the same CSE and typing.  A read at step offset
  ``+step_dir`` of a var an earlier stage wrote reads that stage's
  computed tile (``rd.template cmp<B>(o...)``), not an input.  Stage K is
  computed over the block expanded by the read widths of the stages after
  it (``SolutionAnalysis.stage_read_widths``, as ``build_pallas_chunk``
  shrinks its regions stage by stage), so the input halos grow to match.
  A *pushed* var (:func:`push_eligible_vars`) lives only in its shared-
  memory tile: no input, no output.
* compile-time tables the machinery reads: which inputs ride shared memory
  (those of full-dim vars read at a spatial offset, or over an expanded
  region) and their halos, the tile extents, and for K6 the stage
  expansions and the computed tiles.

Value types follow the plain version's (PyTorch's) promotion, so the
kernel rounds where the tensors do: a tensor op with a Python scalar runs
at the tensor's dtype, scalar-only subtrees run in double, a domain index
is an ``int32`` tensor, and ``/`` on integers is true division.  Solution
dims map onto the last of three slots (``x, y, z`` → slots 0, 1, 2; a 2-D
``x, y`` → slots 1, 2), slot 2 being the contiguous minor dim.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from yask_tpu_torch.utils.exceptions import YaskException
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
#: the loop inside each thread.
_TILE_LADDER = ((8, 8, 64), (4, 8, 64), (2, 8, 64), (1, 8, 64),
                (1, 4, 64), (1, 2, 64), (1, 1, 64), (1, 1, 32))

_C_TYPES = {"R": "real_t", "I": "int", "i": "int", "d": "double",
            "B": "bool", "b": "bool"}
_IND = " " * 8   # statement indent inside Spec::point


def fused_applicable(program) -> Tuple[bool, str]:
    """Can the emitter print this solution?  1-3 domain dims, fp32/fp64,
    no scratch vars, no misc dims or misc-index values, written vars over
    every domain dim, each written in one stage.  Any number of stages."""
    import numpy as np
    ana = program.ana
    nd = len(ana.domain_dims)
    if not 1 <= nd <= 3:
        return False, f"needs 1-3 domain dims, has {nd}"
    if np.dtype(program.dtype).name not in ("float32", "float64"):
        return False, (f"dtype {np.dtype(program.dtype).name} (the kernel "
                       "takes float32 and float64)")
    for v in program.soln.get_vars():
        if v.is_scratch():
            return False, (f"scratch var '{v.get_name()}' (scratch "
                           "emission is ROADMAP.md A3)")
        if any(d.type == IndexType.MISC for d in v.get_dims()):
            return False, (f"misc-dim var '{v.get_name()}' (misc emission "
                           "is ROADMAP.md A3)")
        if v.is_written and v.domain_dim_names() != list(ana.domain_dims):
            return False, (f"written var '{v.get_name()}' does not span "
                           "every domain dim in solution order (ROADMAP.md "
                           "A3)")
    for eq in ana.eqs:
        if uses_misc_index(eq.rhs, eq.cond, eq.step_cond):
            return False, "misc index used as a value (ROADMAP.md A3)"
    stages_of: Dict[str, set] = {}
    for stage in ana.stages:
        for part in stage.parts:
            for eq in part.eqs:
                stages_of.setdefault(eq.lhs.var_name(), set()).add(
                    stage.index)
    for name, ss in stages_of.items():
        if len(ss) > 1:
            return False, (f"var '{name}' is written in {len(ss)} stages "
                           "(a rewrite in a later stage is ROADMAP.md A3)")
    return True, "ok"


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
    outputs: List[str]             # written var per output array
    tiled: List[int]               # input indices staged in smem
    tile: Tuple[int, int, int]     # points per block in slots 0, 1, 2
    smem_bytes: int
    halos: Dict[int, Tuple[Tuple[int, int], ...]] = field(
        default_factory=dict)      # tiled input → per-slot (lo, hi)
    stages: int = 1                # > 1: K6 (entry `name` runs them all)
    push_vars: List[str] = field(default_factory=list)
    push_reasons: List[Dict] = field(default_factory=list)
    computed: List[str] = field(default_factory=list)  # K6's stage tiles
    push_smem_bytes: int = 0       # shared memory of the pushed tiles


def _hexf(v: float) -> str:
    """Exact C++17 hex-float literal of a Python float."""
    if v != v or v in (float("inf"), float("-inf")):
        raise YaskException(f"non-finite constant {v} in a stencil")
    return f"({float(v).hex()})"


class _Printer:
    """Post-order printer of one stage's equations with structural CSE;
    the inputs, their reach and the computed tiles are shared by all the
    stages of a solution."""

    def __init__(self, program, slot_of: Dict[str, int]):
        self.prog = program
        self.ana = program.ana
        self.slot_of = slot_of          # solution dim → slot
        self.lines: List[str] = []
        self.memo: Dict[tuple, Tuple[str, str]] = {}
        self.inputs: List[Tuple[str, int]] = []
        self.in_index: Dict[Tuple[str, int], int] = {}
        # (input index) → per-slot left/right reach of the tile: the read
        # offsets plus the current stage's expansion
        self.reach: Dict[int, List[List[int]]] = {}
        # (input index) → per-slot left/right read offsets alone (what the
        # padded array holds around the domain)
        self.raw: Dict[int, List[List[int]]] = {}
        self.expand = [0, 0, 0]         # the current stage's expansion
        self.cmp_of: Dict[str, int] = {}      # var → computed tile
        self.cmp_expand: List[List[int]] = []  # computed tile → expansion
        self.nvals = 0

    def begin_stage(self, expand: List[int]) -> None:
        self.lines = []
        self.memo = {}
        self.expand = list(expand)

    def input_of(self, var: str, ring_idx: int) -> int:
        key = (var, ring_idx)
        if key not in self.in_index:
            self.in_index[key] = len(self.inputs)
            self.inputs.append(key)
            self.reach[self.in_index[key]] = [[0, 0] for _ in range(3)]
            self.raw[self.in_index[key]] = [[0, 0] for _ in range(3)]
        return self.in_index[key]

    def _note_reach(self, a: int, offs: List[int]) -> None:
        for s_, o in enumerate(offs):
            e = self.expand[s_]
            lo_hi = self.reach[a][s_]
            lo_hi[0] = max(lo_hi[0], e - o)
            lo_hi[1] = max(lo_hi[1], e + o)
            raw = self.raw[a][s_]
            raw[0] = max(raw[0], -o)
            raw[1] = max(raw[1], o)

    def base_read(self, name: str) -> str:
        """The evicted slot's value at the current point (the base of a
        conditional write)."""
        a = self.input_of(name, 0)
        self._note_reach(a, [0, 0, 0])
        return f"rd.template at<{a}>(0, 0, 0)"

    def _new(self, kind: str, text: str) -> Tuple[str, str]:
        name = f"v{self.nvals}"
        self.nvals += 1
        self.lines.append(f"{_IND}const {_C_TYPES[kind]} {name} = {text};")
        return name, kind

    # -- typing (PyTorch promotion with weak Python scalars) -------------

    @staticmethod
    def _cast(x: Tuple[str, str], kind: str) -> str:
        text, k = x
        if k == kind or (k in "Ii" and kind in "Ii"):
            return text
        return f"({_C_TYPES[kind]})({text})"

    def _arith(self, op: str, a, b) -> Tuple[str, str]:
        ka, kb = a[1], b[1]
        if "R" in (ka, kb) or ("I" in (ka, kb) and "d" in (ka, kb)):
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
            return self._new(k, f"{fn}({x}, {y})")
        return self._new(k, f"{x} {op} {y}")

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
                raise YaskException(
                    f"misc index '{e.name}' as a value is not emitted yet "
                    "(ROADMAP.md A3)")
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
            k = "d" if all(a[1] in "di" for a in args) else "R"
            r = self._new(k, f"yt::f_{e.name}("
                          + ", ".join(self._cast(a, k) for a in args) + ")")
        elif isinstance(e, CompExpr):
            a = ev(e.lhs)
            b = ev(e.rhs)
            kinds = (a[1], b[1])
            if "R" in kinds or ("I" in kinds and "d" in kinds):
                k = "R"
            elif "d" in kinds:
                k = "d"
            else:
                k = "i"
            tensor = "R" in kinds or "I" in kinds
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
        g = self.prog.geoms[name]
        so = p.step_offset()
        offs = [0, 0, 0]
        for d, o in p.domain_offsets().items():
            offs[self.slot_of[d]] = o
        if g.has_step and g.is_written:
            s = so if so is not None else 0
            if s == self.ana.step_dir:
                return self._computed_read(name, offs)
            idx = g.num_slots - 1 + s * self.ana.step_dir
            if not 0 <= idx < g.num_slots:
                raise YaskException(
                    f"step offset {s} of '{name}' outside its allocation "
                    f"{g.alloc}")
        else:
            idx = 0
        a = self.input_of(name, idx)
        self._note_reach(a, offs)
        return self._new("R", f"rd.template at<{a}>({offs[0]}, {offs[1]}, "
                              f"{offs[2]})")

    def _computed_read(self, name: str, offs: List[int]) -> Tuple[str, str]:
        """A same-step read of an earlier stage's output: its tile."""
        if name not in self.cmp_of:
            raise YaskException(
                f"same-step read of '{name}' before a stage computed it")
        b = self.cmp_of[name]
        for s_, o in enumerate(offs):
            if self.expand[s_] + abs(o) > self.cmp_expand[b][s_]:
                raise YaskException(
                    f"same-step read of '{name}' at offset {o} reaches past "
                    "its stage's computed region")
        return self._new("R", f"rd.template cmp<{b}>({offs[0]}, {offs[1]}, "
                              f"{offs[2]})")


def _stage_expansions(ana, slot_of) -> List[List[int]]:
    """Per stage, per slot: how far past the block its region reaches —
    the sum of the read widths of the stages after it."""
    widths = []
    for reads in ana.stage_read_widths():
        w = [0, 0, 0]
        for vv in reads.values():
            for d, (lo, hi) in vv.items():
                w[slot_of[d]] = max(w[slot_of[d]], lo, hi)
        widths.append(w)
    return [[sum(w[s_] for w in widths[k + 1:]) for s_ in range(3)]
            for k in range(len(widths))]


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


def emit(program, push=False) -> KernelSpec:
    """Print ``program`` as a CUDA C++ kernel source: K1's (and K7's)
    entries for one stage, K6's for several.  ``push`` is the
    :func:`resolve_push` request."""
    import numpy as np
    ok, why = fused_applicable(program)
    if not ok:
        raise YaskException(
            f"solution '{program.soln.get_name()}' cannot use the fused "
            f"kernel: {why}; use -mode torch")
    ana = program.ana
    dims = list(ana.domain_dims)
    slot_of = {d: 3 - len(dims) + i for i, d in enumerate(dims)}
    pushed, push_reasons = resolve_push(program, push)
    nst = len(ana.stages)
    expand = _stage_expansions(ana, slot_of)
    # vars some stage reads at +step_dir: their stage keeps a tile of them
    computed_reads = set()
    for eq in ana.eqs:
        pv = PointVisitor()
        for e in (eq.rhs, eq.cond, eq.step_cond):
            if e is not None:
                e.accept(pv)
        for p in pv.points:
            g = program.geoms[p.var_name()]
            if g.has_step and g.is_written \
                    and p.step_offset() == ana.step_dir:
                computed_reads.add(p.var_name())

    pr = _Printer(program, slot_of)
    outputs: List[str] = []
    stage_lines: List[List[str]] = []
    stage_vars: List[List[str]] = []
    computed: List[str] = []
    computed_stage: List[int] = []
    for k, stage in enumerate(ana.stages):
        pr.begin_stage(expand[k])
        names: List[str] = []
        for part in stage.parts:
            for eq in part.eqs:
                name = eq.lhs.var_name()
                if name not in names:
                    names.append(name)
                    if name not in pushed:
                        outputs.append(name)
                # one stage writes its vars straight into the outputs
                j = outputs.index(name) if nst == 1 else names.index(name)
                val = pr.ev(eq.rhs)
                sel = None
                if eq.cond is not None:
                    sel = pr.ev(eq.cond)
                if eq.step_cond is not None:
                    sc = pr.ev(eq.step_cond)
                    sel = sc if sel is None else (f"({sel[0]} && {sc[0]})",
                                                  "B")
                v = pr._cast(val, "R")
                if sel is None:
                    pr.lines.append(f"{_IND}out[{j}] = {v};")
                else:
                    # unselected points keep the evicted slot's value, as
                    # where(mask, val, base) does in the plain version
                    if not any(ln.startswith(f"{_IND}out[{j}] = ")
                               for ln in pr.lines):
                        pr.lines.insert(0, f"{_IND}out[{j}] = "
                                           f"{pr.base_read(name)};")
                    pr.lines.append(f"{_IND}if ({sel[0]}) out[{j}] = {v};")
        # every written var must be set at every point: an unconditional
        # eq or a base copy precedes any conditional one
        for name in names:
            j = outputs.index(name) if nst == 1 else names.index(name)
            if not any(ln.startswith(f"{_IND}out[{j}] = ")
                       for ln in pr.lines):
                raise YaskException(f"output '{name}' is never assigned")
        stage_lines.append(pr.lines)
        stage_vars.append(names)
        for name in names:
            if name in computed_reads:
                pr.cmp_of[name] = len(computed)
                pr.cmp_expand.append(list(expand[k]))
                computed.append(name)
                computed_stage.append(k)

    full = set(dims)
    esize = np.dtype(program.dtype).itemsize
    tiled = [a for a, (var, _s) in enumerate(pr.inputs)
             if set(program.geoms[var].domain_dims) == full
             and any(lo or hi for lo, hi in pr.reach[a])]
    halos = {a: tuple(tuple(x) for x in pr.reach[a]) for a in tiled}
    used = [s_ in slot_of.values() for s_ in range(3)]

    def cells(t3, lo_hi):
        c = 1
        for s_ in range(3):
            c *= t3[s_] + lo_hi[s_][0] + lo_hi[s_][1]
        return c

    def cmp_cells(t3, b):
        e = expand[computed_stage[b]]
        return cells(t3, [(e[s_], e[s_]) for s_ in range(3)])

    tile = None
    for cand in _TILE_LADDER:
        t3 = tuple(c if used[s_] else 1 for s_, c in enumerate(cand))
        smem = (sum(cells(t3, halos[a]) for a in tiled)
                + sum(cmp_cells(t3, b) for b in range(len(computed))))
        if smem * esize <= SMEM_LIMIT:
            tile = t3
            break
    if tile is None:
        raise YaskException(
            f"the shared-memory tiles of '{program.soln.get_name()}' do "
            f"not fit {SMEM_LIMIT} bytes even at the smallest tile")

    real_t = "float" if esize == 4 else "double"
    tabs = []
    offs = 0
    tile_off = []
    for a in tiled:
        tile_off.append(offs)
        offs += cells(tile, halos[a])
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

    if nst == 1:
        body = stage_lines[0]
        stem = hashlib.sha256(
            ("\n".join(body) + repr((tiled, halos, tile, real_t,
                                     len(pr.inputs), len(outputs))))
            .encode()).hexdigest()[:12]
        name = f"fused_step_{stem}"
        src = f"""// Emitted by yask_tpu_torch.ops.cuda_emit for solution
// '{program.soln.get_name()}': one sub-step of K1, and of K7 over N members
// (see ops/fused_stencil.py).
#include "fused_step.cuh"

struct Spec {{
    typedef {real_t} real_t;
    enum {{ NIN = {len(pr.inputs)}, NOUT = {len(outputs)}, NTILED = {len(tiled)},
           T0 = {tile[0]}, T1 = {tile[1]}, T2 = {tile[2]}, SMEM_ELEMS = {offs} }};
{chr(10).join(tabs)}

    template <class RD>
    YT_HD static inline void point(const RD& rd, const int* g, const int* n,
                                   const int t, real_t* out) {{
        (void)g; (void)n; (void)t;
{chr(10).join(body)}
    }}
}};

YT_FUSED_STEP_ENTRY({name}, Spec)
YT_FUSED_BATCHED_ENTRY({name}_batched, Spec)
"""
        return KernelSpec(name=name, source=src, inputs=list(pr.inputs),
                          outputs=outputs, tiled=tiled, tile=tile,
                          smem_bytes=offs * esize, halos=halos,
                          push_reasons=push_reasons)

    # ---- K6: several stages per launch ---------------------------------
    in_elems = offs
    cmp_off = []
    for b in range(len(computed)):
        cmp_off.append(offs)
        offs += cmp_cells(tile, b)
    push_elems = sum(cmp_cells(tile, b) for b, n in enumerate(computed)
                     if n in pushed)
    raw = {a: pr.raw[a] for a in tiled}
    for s_ in range(3):
        tabs.append(_table(f"reach_lo{s_}", [raw[a][s_][0] for a in tiled],
                           "0"))
        tabs.append(_table(f"reach_hi{s_}", [raw[a][s_][1] for a in tiled],
                           "0"))
    for s_ in range(3):
        tabs.append(_table(f"expand{s_}", [e[s_] for e in expand], "0"))
    tabs.append(_table("cmp_offset", cmp_off, "0"))
    tabs.append(_table("cmp_stage", computed_stage, "0"))
    tabs.append(_table("stage_nv", [len(n) for n in stage_vars], "0"))
    tabs.append(_table2("stage_out", [
        [outputs.index(n) if n in outputs else -1 for n in names]
        for names in stage_vars]))
    tabs.append(_table2("stage_cmp", [
        [computed.index(n) if n in computed else -1 for n in names]
        for names in stage_vars]))
    stages_src = "\n".join(
        f"        if constexpr (K == {k}) {{\n"
        + "\n".join("    " + ln for ln in lines) + "\n        }"
        for k, lines in enumerate(stage_lines))
    maxv = max(len(n) for n in stage_vars)
    stem = hashlib.sha256(
        ("\n".join("\n".join(ln) for ln in stage_lines)
         + repr((tiled, halos, raw, tile, real_t, len(pr.inputs), outputs,
                 expand, computed, stage_vars))).encode()).hexdigest()[:12]
    name = f"fused_stages_{stem}"
    src = f"""// Emitted by yask_tpu_torch.ops.cuda_emit for solution
// '{program.soln.get_name()}': one sub-step of K6, {nst} stages per launch
// (see ops/fused_stencil.py); pushed vars: {', '.join(pushed) or 'none'}.
#include "fused_step.cuh"

struct Spec {{
    typedef {real_t} real_t;
    enum {{ NIN = {len(pr.inputs)}, NOUT = {len(outputs)}, NTILED = {len(tiled)},
           T0 = {tile[0]}, T1 = {tile[1]}, T2 = {tile[2]}, SMEM_ELEMS = {offs},
           IN_ELEMS = {in_elems}, NSTAGES = {nst}, NCMP = {len(computed)},
           MAXV = {maxv} }};
{chr(10).join(tabs)}

    template <int K, class RD>
    YT_HD static inline void stage(const RD& rd, const int* g, const int* n,
                                   const int t, real_t* out) {{
        (void)rd; (void)g; (void)n; (void)t; (void)out;
{stages_src}
    }}
}};

YT_FUSED_STAGES_ENTRY({name}, Spec)
"""
    return KernelSpec(name=name, source=src, inputs=list(pr.inputs),
                      outputs=outputs, tiled=tiled, tile=tile,
                      smem_bytes=offs * esize, halos=halos, stages=nst,
                      push_vars=list(pushed), push_reasons=push_reasons,
                      computed=computed, push_smem_bytes=push_elems * esize)
