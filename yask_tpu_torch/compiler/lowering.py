"""Lowering: analyzed solutions → step programs on PyTorch tensors.

Counterpart of ``yask_tpu/compiler/lowering.py``.  The same evaluator runs
a whole step of an analyzed solution, array op by array op, under one of
two array backends:

* :class:`NumpyOps` — eager numpy, the independent validation oracle
  (``-mode ref``; a copy of the reference package's ``NumpyOps``);
* :class:`TorchOps` — eager PyTorch on an explicit ``torch.device``
  (``-mode torch``, the counterpart of the reference's ``jit`` path, and
  the plain version the fused CUDA kernel is held against).

Representation choices carried over unchanged:

* **Ring-buffer state.** A var with step dim and step-alloc ``A`` is a list
  of ``A`` padded arrays holding steps ``[t-A+1 … t]``; writing step
  ``t+1`` replaces the evicted oldest slot.
* **Padded storage + static slices.** Arrays carry left/right pads ≥ halo;
  every stencil read is a static slice of a padded array.  Pads hold
  zeros in every mode.
* **Masked writes.** Sub-domain/step conditions lower to ``where`` against
  the evicted slot's contents.
* **Scratch vars** are materialized per step over the domain expanded by
  their write-halo and die at step end.

What differs from the reference package: :class:`VarGeom` applies no
Mosaic lane/sublane round-up (there is no TPU tiling to satisfy), so the
port's padded shapes differ from ``yask_tpu``'s and cross-package
comparisons read interiors only; and the program dtype stays a numpy dtype
(``np.dtype(torch.float32)`` raises) — :func:`torch_dtype` derives the
tensor dtype where tensors are allocated.  Numpy has no bfloat16 without
the ``ml_dtypes`` package, which the port does not use: at element size 2
the program dtype is :data:`BFLOAT16`, numpy's uint16 (the storage) tagged
in its metadata.

bfloat16 arithmetic follows ``yask_tpu``'s (JAX's weak scalars), the
same on every device: an op on bfloat16 values runs in float and rounds
its result once to bfloat16; a Python scalar (a constant, the step or a
misc index) that meets a bfloat16 value is rounded to bfloat16 first,
and an int32 domain index is converted to bfloat16; an op on indices and
scalars alone gives float32, which wins over bfloat16.  PyTorch's own
bf16 ops give no single rule for scalars (on the CPU a scalar added to a
bf16 tensor is rounded to bf16 first, a multiplier stays float; on the
card both stay float), so the evaluator rounds such a scalar itself
(:meth:`StepProgram._bf16_op`).  On iso3dfd r=2 this gives ``yask_tpu``
jit's bits; keeping the constants in float leaves 2613 cells outside
(3e-2, 3e-2) of them after 2 steps from ``init_solution_vars``.  The
fused kernel prints the same rule (``ops/cuda_emit.py``).  The numpy
oracle holds bfloat16 values in float32 arrays and rounds each op's
float32 result.
"""

from __future__ import annotations

import math
import operator
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from yask_tpu_torch.utils.exceptions import YaskException
from yask_tpu_torch.utils.idx_tuple import IdxTuple
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
)
from yask_tpu_torch.compiler.analysis import SolutionAnalysis, Part


# ---------------------------------------------------------------------------
# array-backend adapters
# ---------------------------------------------------------------------------


class ArrayOps:
    """Minimal array-op surface needed by the evaluator."""

    name = "abstract"

    def update(self, arr, idx, val):
        raise NotImplementedError

    def index_array(self, start: int, stop: int, dtype):
        raise NotImplementedError

    def where(self, c, a, b):
        raise NotImplementedError

    def broadcast_to(self, v, shape):
        raise NotImplementedError

    def full(self, shape, val, dtype):
        raise NotImplementedError

    def func(self, name: str, args):
        raise NotImplementedError

    def logical(self, op: str, a, b=None):
        raise NotImplementedError

    def asdtype(self, v, dtype):
        raise NotImplementedError

    def permute(self, v, perm):
        raise NotImplementedError


#: The program dtype at element size 2: numpy's uint16 (bfloat16's
#: storage) tagged ``yt_dtype: bfloat16`` in its metadata.
BFLOAT16 = np.dtype(np.uint16, metadata={"yt_dtype": "bfloat16"})


def is_bfloat16(dtype) -> bool:
    """Is ``dtype`` the port's bfloat16 program dtype?"""
    md = np.dtype(dtype).metadata
    return bool(md) and md.get("yt_dtype") == "bfloat16"


def dtype_name(dtype) -> str:
    """The program dtype's name: ``bfloat16`` for :data:`BFLOAT16`."""
    return "bfloat16" if is_bfloat16(dtype) else np.dtype(dtype).name


def round_bf16(a):
    """The values of ``a`` rounded to the nearest bfloat16 (ties to
    even), as float32: what ``torch.Tensor.to(torch.bfloat16)`` keeps of a
    float32, without a bfloat16 numpy dtype.  NaN stays NaN."""
    f = np.array(a, dtype=np.float32)
    u = f.view(np.uint32).astype(np.uint64)
    r = ((u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000).astype(np.uint32)
    return np.where(np.isnan(f), f, r.view(np.float32))


def host_dtype(dtype):
    """The numpy dtype of a host array of the program dtype: float32
    holding bfloat16 values for :data:`BFLOAT16`."""
    return np.float32 if is_bfloat16(dtype) else dtype


class NumpyOps(ArrayOps):
    """Eager numpy execution — the independent validation oracle (the role
    of the reference's scalar ``run_ref`` context, ``context.cpp:46``)."""

    name = "numpy"

    def __init__(self):
        import numpy as np
        self.np = np
        try:
            from scipy.special import erf as _erf
        except ImportError:  # pragma: no cover
            _erf = np.vectorize(math.erf)
        self._funcs = {
            "sqrt": np.sqrt, "cbrt": np.cbrt, "fabs": np.abs,
            "erf": _erf, "exp": np.exp, "log": np.log,
            "atan": np.arctan, "sin": np.sin, "cos": np.cos,
            "tan": np.tan, "asin": np.arcsin, "acos": np.arccos,
            "pow": np.power, "max": np.maximum, "min": np.minimum,
        }

    def update(self, arr, idx, val):
        out = arr.copy()
        out[idx] = val
        return out

    def index_array(self, start, stop, dtype):
        return self.np.arange(start, stop, dtype=self.np.int32)

    def where(self, c, a, b):
        return self.np.where(c, a, b)

    def broadcast_to(self, v, shape):
        return self.np.broadcast_to(v, shape)

    def full(self, shape, val, dtype):
        return self.np.full(shape, val, dtype=host_dtype(dtype))

    def func(self, name, args):
        # numpy promotes float32 scalars/arrays to float64 in some funcs;
        # the caller casts the final value to the program dtype
        return self._funcs[name](*args)

    def logical(self, op, a, b=None):
        if op == "and":
            return self.np.logical_and(a, b)
        if op == "or":
            return self.np.logical_or(a, b)
        return self.np.logical_not(a)

    def asdtype(self, v, dtype):
        if is_bfloat16(dtype):
            return round_bf16(v)
        return self.np.asarray(v, dtype=dtype)

    def permute(self, v, perm):
        return v.transpose(perm)

    def is_bf16(self, v) -> bool:
        """Does ``v`` hold bfloat16 values (a float32 array here)?"""
        return isinstance(v, self.np.ndarray) and v.dtype == self.np.float32

    def round_bf16(self, v):
        """One bfloat16 op's result: a float32 array rounded."""
        return round_bf16(v) if self.is_bf16(v) else v


def torch_dtype(dtype):
    """The tensor dtype for a program's numpy dtype (float32/float64,
    float16, and :data:`BFLOAT16`)."""
    import torch
    name = dtype_name(dtype)
    table = {"float32": torch.float32, "float64": torch.float64,
             "float16": torch.float16, "bfloat16": torch.bfloat16}
    if name not in table:
        raise YaskException(f"no tensor dtype for program dtype '{name}'")
    return table[name]


def _is_scalar(v) -> bool:
    return isinstance(v, (bool, int, float))


class TorchOps(ArrayOps):
    """Eager PyTorch on one ``torch.device``: the counterpart of the
    reference's ``JnpOps``.  Values are tensors on ``device`` or Python
    scalars (constants, the step index); a scalar combines with a tensor
    at the tensor's dtype, as JAX's weak types and numpy do."""

    name = "torch"

    def __init__(self, device):
        import torch
        self.torch = torch
        self.device = torch.device(device)
        self._funcs = {
            "sqrt": torch.sqrt, "cbrt": self._cbrt, "fabs": torch.abs,
            "erf": torch.erf, "exp": torch.exp, "log": torch.log,
            "atan": torch.atan, "sin": torch.sin, "cos": torch.cos,
            "tan": torch.tan, "asin": torch.asin, "acos": torch.acos,
            "pow": torch.pow, "max": torch.maximum, "min": torch.minimum,
        }

    def _cbrt(self, x):
        # torch has no cbrt: sign(x)·|x|^(1/3) (a few ulps from np.cbrt)
        return self.torch.sign(x) * self.torch.abs(x).pow(1.0 / 3.0)

    def _tensor(self, v, like=None):
        if not _is_scalar(v):
            return v
        dt = like.dtype if like is not None and not _is_scalar(like) \
            else None
        return self.torch.as_tensor(v, dtype=dt, device=self.device)

    def update(self, arr, idx, val):
        out = arr.clone()
        out[idx] = val
        return out

    def index_array(self, start, stop, dtype):
        return self.torch.arange(start, stop, dtype=self.torch.int32,
                                 device=self.device)

    def where(self, c, a, b):
        if _is_scalar(c):
            return a if c else b
        return self.torch.where(c, self._tensor(a, b), self._tensor(b, a))

    def broadcast_to(self, v, shape):
        return self.torch.broadcast_to(self._tensor(v), tuple(shape))

    def full(self, shape, val, dtype):
        return self.torch.full(tuple(shape), val, dtype=torch_dtype(dtype),
                               device=self.device)

    def func(self, name, args):
        if all(_is_scalar(a) for a in args):
            # a function of constants stays a Python float (double), as a
            # constant subtree does in the emitted kernel
            import numpy as np
            return float(NumpyOps()._funcs[name](
                *[np.float64(a) for a in args]))
        if len(args) == 2:
            a, b = args
            if name == "pow" and _is_scalar(b):
                return self.torch.pow(a, b)
            args = (self._tensor(a, b), self._tensor(b, a))
        return self._funcs[name](*args)

    def logical(self, op, a, b=None):
        t = self.torch
        if op == "not":
            return (not a) if _is_scalar(a) else t.logical_not(a)
        if _is_scalar(a) and _is_scalar(b):
            return (a and b) if op == "and" else (a or b)
        a, b = self._tensor(a), self._tensor(b)
        return t.logical_and(a, b) if op == "and" else t.logical_or(a, b)

    def asdtype(self, v, dtype):
        td = torch_dtype(dtype)
        if _is_scalar(v):
            return self.torch.tensor(v, dtype=td, device=self.device)
        if not isinstance(v, self.torch.Tensor):
            v = self.torch.as_tensor(v)
        return v.to(device=self.device, dtype=td)

    def permute(self, v, perm):
        return v.permute(*perm)

    def is_bf16(self, v) -> bool:
        return isinstance(v, self.torch.Tensor) \
            and v.dtype == self.torch.bfloat16

    def round_bf16(self, v):
        """One bfloat16 op's result: PyTorch's bf16 ops already compute
        in float and round once."""
        return v


# ---------------------------------------------------------------------------
# var geometry
# ---------------------------------------------------------------------------


class VarGeom:
    """Array geometry for one var: axis order, pads, step allocation —
    the lowered analog of the reference's per-var halo/pad/alloc geometry
    (``yk_var.hpp`` geometry accessors).  Unlike ``yask_tpu``'s VarGeom it
    applies no Mosaic lane/sublane round-up: pads are halo + write-halo +
    requested extra pad, rounded only to ``pad_multiple``."""

    def __init__(self, var, ana: SolutionAnalysis, sizes: IdxTuple,
                 extra_pad: Dict[str, Tuple[int, int]],
                 pad_multiple: Optional[Dict[str, int]] = None):
        self.var = var
        self.name = var.get_name()
        self.has_step = var.step_dim() is not None
        self.alloc = var.get_step_alloc_size() if self.has_step else 1
        self.is_written = var.is_written
        self.is_scratch = var.is_scratch()

        # Physical axis order: misc axes first, then domain axes in
        # declared order, step dim removed (step → list position) — the
        # reference package's layout, kept so the two packages index alike.
        self.axes: List[Tuple[str, str]] = []  # (dim name, kind)
        doms: List[Tuple[str, str]] = []
        for d in var.get_dims():
            if d.type == IndexType.STEP:
                continue
            if d.type.value == "misc":
                self.axes.append((d.name, d.type.value))
            else:
                doms.append((d.name, d.type.value))
        self.axes += doms

        self.domain_dims = [n for n, k in self.axes if k == "domain"]
        self.misc_lo: Dict[str, int] = {}
        self.misc_ext: Dict[str, int] = {}
        self.shape: List[int] = []
        self.origin: Dict[str, int] = {}   # pad_left per domain dim
        self.pads: Dict[str, Tuple[int, int]] = {}

        wh = ana.scratch_write_halo.get(self.name, {})
        for n, k in self.axes:
            if k == "domain":
                hl, hr = var.halo.get(n, (0, 0))
                el, er = extra_pad.get(n, (0, 0))
                wl, wr = wh.get(n, (0, 0))
                pl, pr = hl + wl + el, hr + wr + er
                mult = (pad_multiple or {}).get(n, 1)
                if mult > 1:
                    pr += (-(sizes[n] + pl + pr)) % mult
                self.pads[n] = (pl, pr)
                self.origin[n] = pl
                self.shape.append(sizes[n] + pl + pr)
            else:  # misc
                lo, hi = var.misc_range.get(n, (0, 0))
                self.misc_lo[n] = lo
                ext = hi - lo + 1
                self.misc_ext[n] = ext
                self.shape.append(ext)

    @property
    def num_slots(self) -> int:
        """Ring slots allocated in state: write-back-optimized alloc for
        written step vars, one slot otherwise."""
        return self.alloc if (self.has_step and self.is_written) else 1

    def axis_of(self, dim: str) -> int:
        for i, (n, _) in enumerate(self.axes):
            if n == dim:
                return i
        raise YaskException(f"var '{self.name}' has no dim '{dim}'")


# ---------------------------------------------------------------------------
# step program
# ---------------------------------------------------------------------------


class StepProgram:
    """An executable step function for fixed domain sizes.

    ``state`` is ``{var_name: [array, ...]}`` where the list is the
    step-ring (oldest→newest; length = step-alloc; length 1 for stepless
    vars). ``step(state, t)`` returns the new state after one step.
    ``ops`` picks the array backend; the default is the numpy oracle.
    """

    def __init__(self, csol: "CompiledSolution", sizes: IdxTuple,
                 extra_pad: Optional[Dict[str, Tuple[int, int]]] = None,
                 ops: Optional[ArrayOps] = None,
                 pad_multiple: Optional[Dict[str, int]] = None,
                 rank_offset: Optional[Dict[str, int]] = None,
                 global_sizes: Optional[IdxTuple] = None):
        self.csol = csol
        ana = self.ana = csol.ana
        self.soln = csol.soln
        self.sizes = sizes.copy()
        self.ops = ops or NumpyOps()
        self.dtype = csol.dtype
        # bfloat16 arithmetic (see the module docstring and _bf16_op)
        self._bf16 = is_bfloat16(self.dtype)
        extra_pad = extra_pad or {}
        # Local-interior origin in global coordinates (0 on one device; a
        # shard's offset in the shard modes, the reference's rank offsets,
        # setup.cpp:169): index values and first/last-domain conditions
        # are global.
        self.rank_offset = dict(
            rank_offset or {d: 0 for d in ana.domain_dims})
        gsz = global_sizes if global_sizes is not None else sizes
        self.global_first = {d: 0 for d in ana.domain_dims}
        self.global_last = {d: gsz[d] - 1 for d in ana.domain_dims}

        self.geoms: Dict[str, VarGeom] = {}
        for v in self.soln.get_vars():
            self.geoms[v.get_name()] = VarGeom(v, self.ana, sizes, extra_pad,
                                               pad_multiple)

        # Stage read widths (the dirty-width analog of the reference's
        # per-var dirty flags; see SolutionAnalysis.stage_read_widths).
        self.stage_reads_split = self.ana.stage_read_widths_split()
        self.stage_reads = []
        for kinds in self.stage_reads_split:
            reads: Dict[str, Dict[str, Tuple[int, int]]] = {}
            for kind in ("ring", "computed"):
                for vname, widths in kinds[kind].items():
                    entry = reads.setdefault(vname, {})
                    for d, (l, r) in widths.items():
                        cl, cr = entry.get(d, (0, 0))
                        entry[d] = (max(cl, l), max(cr, r))
            self.stage_reads.append(reads)

    # -- state construction ------------------------------------------------

    def alloc_state(self, init: Optional[Dict[str, object]] = None):
        """Allocate the state dict; arrays zero-filled unless ``init``
        provides full padded arrays or callables(shape)->array."""
        import numpy as np
        state: Dict[str, List[object]] = {}
        for name, g in self.geoms.items():
            if g.is_scratch:
                continue
            arrs = []
            for _ in range(g.num_slots):
                if init and name in init:
                    a = init[name]
                    a = a(tuple(g.shape)) if callable(a) else np.asarray(a)
                    if tuple(a.shape) != tuple(g.shape):
                        raise YaskException(
                            f"init for '{name}' has shape {a.shape}, "
                            f"expected {tuple(g.shape)}")
                    arrs.append(self.ops.asdtype(a, self.dtype))
                else:
                    arrs.append(self.ops.full(tuple(g.shape), 0.0, self.dtype))
            state[name] = arrs
        return state

    def hbm_bytes_per_point(self, fuse_steps: int = 1,
                            block: Optional[Dict[str, int]] = None
                            ) -> Tuple[float, float]:
        """Modeled device-memory traffic per interior point per STEP as
        ``(read_bytes, write_bytes)`` — the roofline yardstick next to
        est-FLOPS (reference reads/writes-per-point report,
        ``soln_apis.cpp:536-551``): a step reads each live (var, ring-slot)
        array once and writes each produced slot once.  ``fuse_steps`` /
        ``block`` model a K-fused tile with halo overlap on the blocked lead
        dims (the reference package's model without its skew term)."""
        import numpy as np
        esize = np.dtype(self.dtype).itemsize
        dompts = 1
        for d in self.ana.domain_dims:
            dompts *= self.sizes[d]
        K = max(1, fuse_steps)
        rad = self.ana.fused_step_radius()
        lead = self.ana.domain_dims[:-1]
        rd = 0.0
        wr = 0.0
        for name, g in self.geoms.items():
            if g.is_scratch:
                continue
            cells = 1
            for ext in g.shape:
                cells *= ext
            ov = 1.0
            if block:
                num = den = 1.0
                for d in lead:
                    if d in g.domain_dims and block.get(d):
                        num *= block[d] + 2 * rad.get(d, 0) * K
                        den *= block[d]
                ov = num / max(den, 1.0)
            rd += g.num_slots * cells * ov
            if g.is_written:
                wr += min(K, g.num_slots) * cells
        return (esize * rd / (dompts * K), esize * wr / (dompts * K))

    # -- expression evaluation --------------------------------------------

    def _region_shape(self, region: Dict[str, Tuple[int, int]]) -> Tuple[int, ...]:
        return tuple(region[d][1] - region[d][0] for d in self.ana.domain_dims)

    def _read_point(self, p: VarPoint, region, state, computed, scratch_vals):
        """Slice a var access over ``region`` (coords relative to the local
        interior origin) into an array broadcast over the region shape."""
        g = self.geoms[p.var_name()]
        ofs = p.domain_offsets()
        misc = p.misc_vals()
        so = p.step_offset()

        if g.is_scratch:
            if p.var_name() not in scratch_vals:
                raise YaskException(
                    f"scratch var '{p.var_name()}' read before written")
            arr, sc_origin = scratch_vals[p.var_name()]
        else:
            ring = state[p.var_name()]
            if so is not None and g.has_step and g.is_written \
                    and so == self.ana.step_dir:
                # Reading the value being computed this step.
                if p.var_name() in computed:
                    arr = computed[p.var_name()]
                else:
                    raise YaskException(
                        f"'{p.var_name()}' read at the written step before "
                        "any equation computed it (ordering bug)")
            elif g.has_step and g.is_written:
                s = so if so is not None else 0
                # ring holds steps [t-A+1 .. t]; offset s ≤ 0 → index A-1+s
                # (mirrored for negative step_dir).
                idx = len(ring) - 1 + s * self.ana.step_dir
                if not (0 <= idx < len(ring)):
                    raise YaskException(
                        f"step offset {s} of '{p.var_name()}' outside its "
                        f"allocation {g.alloc}")
                arr = ring[idx]
            else:
                arr = ring[0]
            sc_origin = None

        idxs = []
        for n, kind in g.axes:
            if kind == "misc":
                idxs.append(misc[n] - g.misc_lo[n])
            else:
                a, b = region[n]
                o = ofs.get(n, 0)
                base = sc_origin[n] if sc_origin is not None else g.origin[n]
                lo = base + a + o
                hi = base + b + o
                if lo < 0 or hi > g.shape[g.axis_of(n)]:
                    raise YaskException(
                        f"read of '{p.var_name()}' dim {n} offset {o} over "
                        f"[{a},{b}) exceeds padded array (pad too small)")
                idxs.append(slice(lo, hi))
        out = arr[tuple(idxs)]

        # Broadcast into solution domain-dim order over the region.
        tgt_shape = self._region_shape(region)
        var_ddims = [n for n, k in g.axes if k == "domain"]
        if var_ddims != self.ana.domain_dims:
            present = [d for d in self.ana.domain_dims if d in var_ddims]
            perm = [var_ddims.index(d) for d in present]
            if perm != list(range(len(perm))):
                out = self.ops.permute(out, perm)
            shape = []
            for d in self.ana.domain_dims:
                if d in var_ddims:
                    shape.append(region[d][1] - region[d][0])
                else:
                    shape.append(1)
            out = out.reshape(tuple(shape))
            out = self.ops.broadcast_to(out, tgt_shape)
        return out

    def _bf16_scalars(self, args):
        """``args`` of one op with each Python scalar rounded to bfloat16
        where a bfloat16 value is among them (JAX's weak scalars)."""
        if not any(self.ops.is_bf16(a) for a in args):
            return args
        return [float(round_bf16(a)) if _is_scalar(a) else a for a in args]

    def _bf16_op(self, f, a, b):
        """One binary op of bfloat16 arithmetic: its scalars rounded to
        bfloat16 where they meet a bfloat16 value, the op in float, its
        bfloat16 result rounded once."""
        a, b = self._bf16_scalars([a, b])
        return self.ops.round_bf16(f(a, b))

    def _eval(self, e: Expr, region, t, state, computed, scratch_vals, memo):
        # Structural memo key: common subexpressions are evaluated once per
        # part even across equations (the reference's CSE pass,
        # ExprUtils.hpp:77, done here as hash-consing at eval time).
        key = e.skey()
        if key in memo:
            return memo[key]
        ops = self.ops
        ev = lambda x: self._eval(x, region, t, state, computed,
                                  scratch_vals, memo)
        op2 = self._bf16_op if self._bf16 else (lambda f, a, b: f(a, b))
        if isinstance(e, ConstExpr):
            r = e.value
        elif isinstance(e, IndexExpr):
            if e.type == IndexType.STEP:
                r = t
            elif e.type == IndexType.DOMAIN:
                a, b = region[e.name]
                iarr = ops.index_array(a, b, None)
                shape = [1] * len(self.ana.domain_dims)
                ax = self.ana.domain_dims.index(e.name)
                shape[ax] = b - a
                r = iarr.reshape(tuple(shape)) + self.rank_offset[e.name]
            else:
                # A misc index used as a VALUE is the current equation's
                # pinned LHS misc index — a per-equation constant. Never
                # memoized: the same node appears in sibling equations with
                # different LHS bindings.
                mv = getattr(self, "_cur_misc", None) or {}
                if e.name not in mv:
                    raise YaskException(
                        f"misc index '{e.name}' used as a value outside "
                        "an equation that pins it on the LHS")
                return mv[e.name]
        elif isinstance(e, FirstIndexExpr):
            r = self.global_first[e.dim.name]
        elif isinstance(e, LastIndexExpr):
            r = self.global_last[e.dim.name]
        elif isinstance(e, VarPoint):
            r = self._read_point(e, region, state, computed, scratch_vals)
        elif isinstance(e, NegExpr):
            r = -ev(e.arg)
        elif isinstance(e, AddExpr):
            r = ev(e.args[0])
            for a in e.args[1:]:
                r = op2(operator.add, r, ev(a))
        elif isinstance(e, MultExpr):
            r = ev(e.args[0])
            for a in e.args[1:]:
                r = op2(operator.mul, r, ev(a))
        elif isinstance(e, SubExpr):
            r = op2(operator.sub, ev(e.lhs), ev(e.rhs))
        elif isinstance(e, DivExpr):
            r = op2(operator.truediv, ev(e.lhs), ev(e.rhs))
        elif isinstance(e, ModExpr):
            r = op2(operator.mod, ev(e.lhs), ev(e.rhs))
        elif isinstance(e, FuncExpr):
            from yask_tpu_torch.compiler.expr import paired_func_eval
            args = [ev(a) for a in e.args]
            func = ops.func
            if self._bf16:
                args = self._bf16_scalars(args)
                func = lambda name, xs: ops.round_bf16(ops.func(name, xs))
            r = paired_func_eval(func, e, args, memo,
                                 getattr(self.ana, "sincos_args", ()))
        elif isinstance(e, CompExpr):
            a, b = ev(e.lhs), ev(e.rhs)
            if self._bf16:
                a, b = self._bf16_scalars([a, b])
            r = {"==": lambda: a == b, "!=": lambda: a != b,
                 "<": lambda: a < b, "<=": lambda: a <= b,
                 ">": lambda: a > b, ">=": lambda: a >= b}[e.op]()
        elif isinstance(e, AndExpr):
            r = ops.logical("and", ev(e.lhs), ev(e.rhs))
        elif isinstance(e, OrExpr):
            r = ops.logical("or", ev(e.lhs), ev(e.rhs))
        elif isinstance(e, NotExpr):
            r = ops.logical("not", ev(e.arg))
        else:  # pragma: no cover
            raise YaskException(f"cannot evaluate node {type(e).__name__}")
        memo[key] = r
        return r

    # -- equation / part / stage evaluation -------------------------------

    def _interior_region(self) -> Dict[str, Tuple[int, int]]:
        return {d: (0, self.sizes[d]) for d in self.ana.domain_dims}

    def _to_var_layout(self, val, g: VarGeom, region):
        """Convert a value computed in solution domain-dim order over
        ``region`` into the target var's own axis order, dropping dims the
        var lacks (the RHS must be constant along those — index 0 taken)
        and permuting when the var declares its dims in another order."""
        shape = self._region_shape(region)
        val = self.ops.broadcast_to(val, shape)
        sol = self.ana.domain_dims
        var_dd = g.domain_dims
        if var_dd == sol:
            return val
        idx = tuple(slice(None) if d in var_dd else 0 for d in sol)
        val = val[idx]
        present = [d for d in sol if d in var_dd]
        perm = [present.index(d) for d in var_dd]
        if perm != list(range(len(perm))):
            val = self.ops.permute(val, perm)
        return val

    def _eval_part(self, part: Part, t, state, computed, scratch_vals,
                   over: Optional[Dict[str, Tuple[int, int]]] = None):
        """Evaluate a part; ``over`` restricts evaluation to a sub-region
        in interior coordinates (it may reach into the pads) — the core/
        shell split of the shard modes (reference ``MpiSection``,
        ``context.hpp:789-833``) and the box of K5's plain version."""
        ops = self.ops
        base_region = over if over is not None else self._interior_region()
        if part.is_scratch:
            # Evaluate over the region expanded by the write-halo.
            for eq in part.eqs:
                self._cur_misc = eq.lhs.misc_vals()
                g = self.geoms[eq.lhs.var_name()]
                wh = self.ana.scratch_write_halo.get(g.name, {})
                region = {}
                for d in self.ana.domain_dims:
                    wl, wr = wh.get(d, (0, 0))
                    if d in g.domain_dims:
                        a, b = base_region[d]
                        region[d] = (a - wl, b + wr)
                    else:
                        region[d] = (0, 1)
                memo: Dict = {}
                val = self._eval(eq.rhs, region, t, state, computed,
                                 scratch_vals, memo)
                val = self._to_var_layout(
                    ops.asdtype(val, self.dtype), g, region)
                if eq.cond is not None:
                    mask = self._eval(eq.cond, region, t, state, computed,
                                      scratch_vals, memo)
                    mask = self._to_var_layout(mask, g, region)
                    old = scratch_vals.get(g.name)
                    base = old[0] if old else \
                        ops.full(val.shape, 0.0, self.dtype)
                    val = ops.where(mask, val, base)
                origin = {d: -region[d][0] for d in self.ana.domain_dims
                          if d in g.domain_dims}
                scratch_vals[g.name] = (val, origin)
            return

        region = base_region
        # One memo across the whole part: no eq in a part reads a var the
        # part writes, so cached reads stay valid.  Exception: misc-index-
        # as-value expressions evaluate differently per equation.
        from yask_tpu_torch.compiler.expr import uses_misc_index
        part_misc = any(uses_misc_index(eq.rhs, eq.cond, eq.step_cond)
                        for eq in part.eqs)
        memo: Dict = {}
        for eq in part.eqs:
            if part_misc:
                memo = {}
            self._cur_misc = eq.lhs.misc_vals()
            name = eq.lhs.var_name()
            g = self.geoms[name]
            ring = state[name]
            base_arr = computed.get(name, ring[0])  # evicted slot is base
            val = self._eval(eq.rhs, region, t, state, computed,
                             scratch_vals, memo)
            val = self._to_var_layout(ops.asdtype(val, self.dtype), g, region)

            idxs = []
            misc = eq.lhs.misc_vals()
            for n, kind in g.axes:
                if kind == "misc":
                    idxs.append(misc[n] - g.misc_lo[n])
                else:
                    a, b = region[n]
                    idxs.append(slice(g.origin[n] + a, g.origin[n] + b))

            cond_mask = None
            if eq.cond is not None:
                cond_mask = self._eval(eq.cond, region, t, state, computed,
                                       scratch_vals, memo)
            if eq.step_cond is not None:
                sc = self._eval(eq.step_cond, region, t, state, computed,
                                scratch_vals, memo)
                cond_mask = sc if cond_mask is None else \
                    ops.logical("and", cond_mask, sc)
            if cond_mask is not None:
                old_val = base_arr[tuple(idxs)]
                mask = self._to_var_layout(cond_mask, g, region)
                val = ops.where(mask, val, old_val)

            computed[name] = ops.update(base_arr, tuple(idxs), val)

    def eval_stage(self, stage_idx: int, t, state, computed, scratch_vals,
                   over: Optional[Dict[str, Tuple[int, int]]] = None):
        """Evaluate one stage in place on (computed, scratch_vals);
        ``over`` restricts it to a sub-region."""
        for part in self.ana.stages[stage_idx].parts:
            self._eval_part(part, t, state, computed, scratch_vals,
                            over=over)

    def rotate(self, state, computed):
        """The state after a step: each computed var's value rotated into
        its ring (a stepless var replaced)."""
        new_state: Dict[str, List[object]] = {}
        for name, ring in state.items():
            g = self.geoms[name]
            if name in computed:
                if g.has_step:
                    new_state[name] = list(ring[1:]) + [computed[name]]
                else:
                    new_state[name] = [computed[name]]
            else:
                new_state[name] = list(ring)
        return new_state

    def step(self, state, t, halo_hook: Optional[Callable] = None):
        """Advance the solution by one step; returns the new state.
        ``halo_hook(stage_idx, state, computed)`` is called before each
        stage (the seam a distributed runtime injects its exchange into)."""
        computed: Dict[str, object] = {}
        scratch_vals: Dict[str, Tuple[object, Dict[str, int]]] = {}
        for si in range(len(self.ana.stages)):
            if halo_hook is not None:
                state, computed = halo_hook(si, state, computed)
            self.eval_stage(si, t, state, computed, scratch_vals)
        return self.rotate(state, computed)


class CompiledSolution:
    """An analyzed solution ready to plan (what the reference's generated
    ``.so`` is: the thing ``yk_factory::new_solution`` instantiates).

    Holds the analysis and a numpy dtype; :meth:`plan` binds domain
    sizes/pads and returns a :class:`StepProgram`.
    """

    def __init__(self, soln, analysis: SolutionAnalysis,
                 dtype: Optional[object] = None):
        import numpy as np
        self.soln = soln
        self.ana = analysis
        if dtype is None:
            eb = soln.get_settings().elem_bytes
            if eb not in (2, 4, 8):
                raise YaskException(f"unsupported elem_bytes {eb}")
            dtype = {2: BFLOAT16, 4: np.float32, 8: np.float64}[eb]
        # a bfloat16 numpy dtype of another package counts as the port's
        self.dtype = BFLOAT16 if dtype_name(dtype) == "bfloat16" \
            else np.dtype(dtype)

    def plan(self, sizes: IdxTuple, ops: Optional[ArrayOps] = None,
             extra_pad: Optional[Dict[str, Tuple[int, int]]] = None,
             pad_multiple: Optional[Dict[str, int]] = None,
             rank_offset: Optional[Dict[str, int]] = None,
             global_sizes: Optional[IdxTuple] = None) -> StepProgram:
        """A :class:`StepProgram` over local ``sizes``; a shard passes its
        ``rank_offset`` and the ``global_sizes`` (the reference's
        lowering.py:813-826)."""
        for d in self.ana.domain_dims:
            if not sizes.has_dim(d):
                raise YaskException(f"domain size for dim '{d}' not given")
        return StepProgram(self, sizes, extra_pad=extra_pad, ops=ops,
                           pad_multiple=pad_multiple,
                           rank_offset=rank_offset,
                           global_sizes=global_sizes)
