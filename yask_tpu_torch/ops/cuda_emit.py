"""Emit a solution's per-point update as CUDA C++ (the counterpart of
``_TileEval`` in ``yask_tpu/ops/pallas_stencil.py``).

Pallas traces ``_TileEval`` per solution; the port does what YASK itself
does and prints C++ per solution.  :func:`emit` turns an analyzed,
single-stage solution into one ``Spec`` struct:

* ``Spec::point(rd, g, n, t, out)`` — a ``__host__ __device__`` inline
  function computing every written var at one point.  It prints the same
  terms in the same order as ``StepProgram._eval`` (and ``_TileEval.eval``),
  one statement per distinct ``skey()``, which is the common-subexpression
  elimination their memos do.  Reads go through ``rd.template at<A>(o...)``;
  the tile machinery in ``csrc/fused_step.cuh`` supplies ``rd``.
* compile-time tables the machinery reads: which inputs ride shared memory
  (those of full-dim vars read at a spatial offset) and their halos, and
  the tile extents.

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
    SubExpr,
    VarPoint,
    uses_misc_index,
)

#: Shared memory one block may use on Hopper (227 KB).
SMEM_LIMIT = 232448
#: Tile extents (points per block) tried in order until the shared-memory
#: tiles fit; slot 2 is the minor dim (one thread per point), slot 1 the
#: other thread dim, slot 0 the loop inside each thread.
_TILE_LADDER = ((8, 8, 64), (4, 8, 64), (2, 8, 64), (1, 8, 64),
                (1, 4, 64), (1, 2, 64), (1, 1, 64), (1, 1, 32))

_C_TYPES = {"R": "real_t", "I": "int", "i": "int", "d": "double",
            "B": "bool", "b": "bool"}
_IND = " " * 8   # statement indent inside Spec::point


def fused_applicable(program) -> Tuple[bool, str]:
    """Can the emitter print this solution?  In this slice: 1-3 domain
    dims, one stage, no scratch vars, no misc dims or misc-index values,
    written vars over every domain dim, fp32/fp64."""
    import numpy as np
    ana = program.ana
    nd = len(ana.domain_dims)
    if not 1 <= nd <= 3:
        return False, f"needs 1-3 domain dims, has {nd}"
    if len(ana.stages) != 1:
        return False, (f"{len(ana.stages)} stages (multi-stage emission "
                       "is ROADMAP.md A3)")
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
                           "every domain dim in solution order")
    for eq in ana.eqs:
        if uses_misc_index(eq.rhs, eq.cond, eq.step_cond):
            return False, "misc index used as a value (ROADMAP.md A3)"
    return True, "ok"


@dataclass
class KernelSpec:
    """What the wrapper needs to call an emitted kernel."""
    name: str                      # C entry point of K1 / library stem;
                                   # K7's is name + "_batched"
    source: str                    # the emitted .cu
    inputs: List[Tuple[str, int]]  # (var, ring slot) per input array
    outputs: List[str]             # written var per output array
    tiled: List[int]               # input indices staged in smem
    tile: Tuple[int, int, int]     # points per block in slots 0, 1, 2
    smem_bytes: int
    halos: Dict[int, Tuple[Tuple[int, int], ...]] = field(
        default_factory=dict)      # tiled input → per-slot (lo, hi)


def _hexf(v: float) -> str:
    """Exact C++17 hex-float literal of a Python float."""
    if v != v or v in (float("inf"), float("-inf")):
        raise YaskException(f"non-finite constant {v} in a stencil")
    return f"({float(v).hex()})"


class _Printer:
    """Post-order printer of one stage's equations with structural CSE."""

    def __init__(self, program, slot_of: Dict[str, int]):
        self.prog = program
        self.ana = program.ana
        self.slot_of = slot_of          # solution dim → slot
        self.lines: List[str] = []
        self.memo: Dict[tuple, Tuple[str, str]] = {}
        self.inputs: List[Tuple[str, int]] = []
        self.in_index: Dict[Tuple[str, int], int] = {}
        # (input index) → per-slot max left/right read offsets
        self.reach: Dict[int, List[List[int]]] = {}
        self.nvals = 0

    def input_of(self, var: str, ring_idx: int) -> int:
        key = (var, ring_idx)
        if key not in self.in_index:
            self.in_index[key] = len(self.inputs)
            self.inputs.append(key)
            self.reach[self.in_index[key]] = [[0, 0] for _ in range(3)]
        return self.in_index[key]

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
        if g.has_step and g.is_written:
            s = so if so is not None else 0
            if s == self.ana.step_dir:
                raise YaskException(
                    f"same-step read of '{name}' (multi-stage emission is "
                    "ROADMAP.md A3)")
            idx = g.num_slots - 1 + s * self.ana.step_dir
            if not 0 <= idx < g.num_slots:
                raise YaskException(
                    f"step offset {s} of '{name}' outside its allocation "
                    f"{g.alloc}")
        else:
            idx = 0
        a = self.input_of(name, idx)
        offs = [0, 0, 0]
        for d, o in p.domain_offsets().items():
            offs[self.slot_of[d]] = o
        for s_, o in enumerate(offs):
            lo_hi = self.reach[a][s_]
            lo_hi[0] = max(lo_hi[0], -o)
            lo_hi[1] = max(lo_hi[1], o)
        return self._new("R", f"rd.template at<{a}>({offs[0]}, {offs[1]}, "
                              f"{offs[2]})")


def emit(program) -> KernelSpec:
    """Print ``program``'s single stage as a CUDA C++ kernel source."""
    import numpy as np
    ok, why = fused_applicable(program)
    if not ok:
        raise YaskException(
            f"solution '{program.soln.get_name()}' cannot use the fused "
            f"kernel: {why}; use -mode torch")
    ana = program.ana
    dims = list(ana.domain_dims)
    slot_of = {d: 3 - len(dims) + i for i, d in enumerate(dims)}
    pr = _Printer(program, slot_of)

    outputs: List[str] = []
    body_out: List[str] = []
    for part in ana.stages[0].parts:
        for eq in part.eqs:
            name = eq.lhs.var_name()
            if name not in outputs:
                outputs.append(name)
            o = outputs.index(name)
            val = pr.ev(eq.rhs)
            sel = None
            if eq.cond is not None:
                sel = pr.ev(eq.cond)
            if eq.step_cond is not None:
                sc = pr.ev(eq.step_cond)
                sel = sc if sel is None else (f"({sel[0]} && {sc[0]})", "B")
            v = pr._cast(val, "R")
            if sel is None:
                pr.lines.append(f"{_IND}out[{o}] = {v};")
            else:
                # unselected points keep the evicted slot's value, as
                # where(mask, val, base) does in the plain version
                if name not in body_out:
                    base = pr.input_of(name, 0)
                    pr.lines.insert(0, f"{_IND}out[{o}] = rd.template "
                                       f"at<{base}>(0, 0, 0);")
                pr.lines.append(f"{_IND}if ({sel[0]}) out[{o}] = {v};")
            body_out.append(name)
    # every output must be written at every point: an unconditional eq
    # or a base copy precedes any conditional one
    for o, name in enumerate(outputs):
        if not any(ln.startswith(f"{_IND}out[{o}] = ") for ln in pr.lines):
            raise YaskException(f"output '{name}' is never assigned")

    full = set(dims)
    esize = np.dtype(program.dtype).itemsize
    tiled = [a for a, (var, _s) in enumerate(pr.inputs)
             if set(program.geoms[var].domain_dims) == full
             and any(lo or hi for lo, hi in pr.reach[a])]
    halos = {a: tuple(tuple(x) for x in pr.reach[a]) for a in tiled}
    used = [s_ in slot_of.values() for s_ in range(3)]
    tile = None
    for cand in _TILE_LADDER:
        t3 = tuple(c if used[s_] else 1 for s_, c in enumerate(cand))
        smem = 0
        for a in tiled:
            cells = 1
            for s_ in range(3):
                cells *= t3[s_] + halos[a][s_][0] + halos[a][s_][1]
            smem += cells * esize
        if smem <= SMEM_LIMIT:
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
        cells = 1
        for s_ in range(3):
            cells *= tile[s_] + halos[a][s_][0] + halos[a][s_][1]
        offs += cells
    # compile-time tables as constexpr functions (usable in device code)
    def table(fn, rows, default="-1"):
        body = " : ".join(f"k == {i} ? {v}" for i, v in enumerate(rows))
        return (f"    YT_HD static constexpr int {fn}(int k) "
                f"{{ return {body + ' : ' if rows else ''}{default}; }}")
    tabs.append(table("tiled_input", tiled))
    tabs.append(table("tile_offset", tile_off, "0"))
    for s_ in range(3):
        tabs.append(table(f"halo_lo{s_}", [halos[a][s_][0] for a in tiled],
                          "0"))
        tabs.append(table(f"halo_hi{s_}", [halos[a][s_][1] for a in tiled],
                          "0"))
    tabs.append("    YT_HD static constexpr int tile_of(int a) { return "
                + "".join(f"a == {a} ? {k} : " for k, a in enumerate(tiled))
                + "-1; }")

    stem = hashlib.sha256(
        ("\n".join(pr.lines) + repr((tiled, halos, tile, real_t,
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
{chr(10).join(pr.lines)}
    }}
}};

YT_FUSED_STEP_ENTRY({name}, Spec)
YT_FUSED_BATCHED_ENTRY({name}_batched, Spec)
"""
    return KernelSpec(name=name, source=src, inputs=list(pr.inputs), outputs=outputs, tiled=tiled,
                      tile=tile, smem_bytes=offs * esize, halos=halos)
