"""Stencil-equation expression AST.

TPU-native counterpart of the reference's expression layer
(``src/compiler/lib/Expr.hpp:96-730``, ``Expr.cpp``): numeric and boolean
expression nodes built via operator overloading, index expressions
(step/domain/misc), var access points, math functions, and the ``EQUALS``
equation former with optional domain/step conditions.

Differences from the reference are deliberate TPU-first choices:

* nodes are immutable and hashable by structure, so common-subexpression
  elimination is a dictionary, not a visitor pass;
* the AST lowers to traced JAX computations, so there is no printer-oriented
  string plumbing in the nodes themselves.
"""

from __future__ import annotations

import enum
from typing import Dict, List, Optional, Sequence, Tuple, Union

from yask_tpu_torch.utils.exceptions import YaskException

Number = Union[int, float]


class IndexType(enum.Enum):
    """Kind of a solution index (``yc_index_node`` kinds in the reference:
    ``new_step_index``/``new_domain_index``/``new_misc_index``,
    ``yask_compiler_api.hpp``)."""
    STEP = "step"
    DOMAIN = "domain"
    MISC = "misc"


# ---------------------------------------------------------------------------
# base classes
# ---------------------------------------------------------------------------


class Expr:
    """Base of all AST nodes. Immutable; structural equality and hashing.

    NOTE: on NumExpr, Python ``==`` is overloaded to *build a comparison
    node* (for conditions), so structural identity must never go through
    ``==`` of children. :func:`structural_key` produces a primitives-only
    key; ``same()`` and ``__hash__`` use it, making nodes safe as dict/set
    keys (the basis of CSE).
    """

    __slots__ = ("_skey",)

    def _key(self) -> tuple:
        raise NotImplementedError

    @staticmethod
    def _to_skey(v):
        if isinstance(v, Expr):
            return v.skey()
        if isinstance(v, tuple):
            return tuple(Expr._to_skey(x) for x in v)
        return v

    def skey(self) -> tuple:
        """Fully-recursive structural key made only of primitives."""
        k = getattr(self, "_skey", None)
        if k is None:
            k = (type(self).__name__,) + tuple(
                self._to_skey(c) for c in self._key())
            object.__setattr__(self, "_skey", k)
        return k

    def __eq__(self, other):
        return NotImplemented

    def same(self, other) -> bool:
        """Structural equality (the reference's ``Expr::is_same``)."""
        return isinstance(other, Expr) and self.skey() == other.skey()

    def __hash__(self):
        return hash(self.skey())

    def accept(self, visitor: "ExprVisitor"):
        raise NotImplementedError

    def get_children(self) -> Sequence["Expr"]:
        return ()

    def format_simple(self) -> str:
        """Structural rendering (the printers' infix form arrives with
        the port of ``compiler/printers.py``)."""
        return str(self.skey())

    def clone_ast(self) -> "Expr":
        """Deep clone of this AST (``yc_expr_node::clone_ast``).  Vars
        are identities (storage declarations, not AST nodes) and stay
        shared — ``Var.__deepcopy__`` returns self."""
        import copy
        return copy.deepcopy(self)

    def get_num_nodes(self) -> int:
        """Total node count of this subtree
        (``yc_expr_node::get_num_nodes``)."""
        return 1 + sum(c.get_num_nodes() for c in self.get_children())

    def __repr__(self):
        return f"<{type(self).__name__} {self.format_simple()}>"


def _coerce_num(v) -> "NumExpr":
    if isinstance(v, NumExpr):
        return v
    if isinstance(v, (int, float)):
        return ConstExpr(v)
    raise YaskException(f"cannot use {v!r} in a stencil expression")


class NumExpr(Expr):
    """Numeric-valued expression; operator overloading builds the AST
    (reference ``Expr.cpp:407-442`` operator definitions)."""

    __slots__ = ()

    # arithmetic -----------------------------------------------------------
    def __add__(self, other):
        return AddExpr.make([self, _coerce_num(other)])

    def __radd__(self, other):
        return AddExpr.make([_coerce_num(other), self])

    def __sub__(self, other):
        return SubExpr(self, _coerce_num(other))

    def __rsub__(self, other):
        return SubExpr(_coerce_num(other), self)

    def __mul__(self, other):
        return MultExpr.make([self, _coerce_num(other)])

    def __rmul__(self, other):
        return MultExpr.make([_coerce_num(other), self])

    def __truediv__(self, other):
        return DivExpr(self, _coerce_num(other))

    def __rtruediv__(self, other):
        return DivExpr(_coerce_num(other), self)

    def __neg__(self):
        return NegExpr(self)

    def __pow__(self, other):
        return FuncExpr("pow", (self, _coerce_num(other)))

    def __mod__(self, other):
        return ModExpr(self, _coerce_num(other))

    # comparisons → boolean AST (for sub-domain/step conditions) ----------
    def __eq__(self, other):  # type: ignore[override]
        return CompExpr("==", self, _coerce_num(other))

    def __ne__(self, other):  # type: ignore[override]
        return CompExpr("!=", self, _coerce_num(other))

    def __lt__(self, other):
        return CompExpr("<", self, _coerce_num(other))

    def __le__(self, other):
        return CompExpr("<=", self, _coerce_num(other))

    def __gt__(self, other):
        return CompExpr(">", self, _coerce_num(other))

    def __ge__(self, other):
        return CompExpr(">=", self, _coerce_num(other))

    __hash__ = Expr.__hash__


# ---------------------------------------------------------------------------
# leaf nodes
# ---------------------------------------------------------------------------


class ConstExpr(NumExpr):
    """Floating-point constant (reference ``ConstExpr``)."""

    __slots__ = ("value",)

    def __init__(self, value: Number):
        object.__setattr__(self, "value", float(value))

    def _key(self):
        return (self.value,)

    def get_value(self) -> float:
        return self.value

    def set_value(self, val) -> None:
        """Mutate the constant (``yc_const_number_node::set_value``).
        Only safe BEFORE the node is registered in an equation: skeys
        (the CSE identities) are cached on first use."""
        object.__setattr__(self, "value", float(val))
        object.__setattr__(self, "_skey", None)

    def accept(self, visitor):
        return visitor.visit_const(self)


class IndexExpr(NumExpr):
    """A solution index (step/domain/misc dim), usable both as a var
    subscript and as a numeric value in equations (reference ``IndexExpr``)."""

    __slots__ = ("name", "type")

    def __init__(self, name: str, index_type: IndexType):
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "type", index_type)

    def _key(self):
        return (self.name, self.type)

    def accept(self, visitor):
        return visitor.visit_index(self)


class FirstIndexExpr(NumExpr):
    """Runtime-bound first valid domain index in a dim
    (``yc_node_factory::new_first_domain_index``)."""

    __slots__ = ("dim",)

    def __init__(self, dim: IndexExpr):
        if dim.type != IndexType.DOMAIN:
            raise YaskException(
                f"first_domain_index requires a domain index, got '{dim.name}'")
        object.__setattr__(self, "dim", dim)

    def _key(self):
        return (self.dim.name,)

    def accept(self, visitor):
        return visitor.visit_first_index(self)


class LastIndexExpr(NumExpr):
    """Runtime-bound last valid domain index in a dim
    (``yc_node_factory::new_last_domain_index``)."""

    __slots__ = ("dim",)

    def __init__(self, dim: IndexExpr):
        if dim.type != IndexType.DOMAIN:
            raise YaskException(
                f"last_domain_index requires a domain index, got '{dim.name}'")
        object.__setattr__(self, "dim", dim)

    def _key(self):
        return (self.dim.name,)

    def accept(self, visitor):
        return visitor.visit_last_index(self)


# ---------------------------------------------------------------------------
# compound numeric nodes
# ---------------------------------------------------------------------------


class NegExpr(NumExpr):
    """Unary negation (reference ``UnaryNumExpr`` '-')"""

    __slots__ = ("arg",)

    def __init__(self, arg: NumExpr):
        object.__setattr__(self, "arg", _coerce_num(arg))

    def _key(self):
        return (self.arg,)

    def get_children(self):
        return (self.arg,)

    def accept(self, visitor):
        return visitor.visit_neg(self)


class CommutativeExpr(NumExpr):
    """N-ary commutative op (reference ``CommutativeExpr``); subclasses fix
    the operator. ``make`` flattens nested same-op nodes and folds consts."""

    __slots__ = ("args",)
    OP = "?"
    IDENT = 0.0

    def __init__(self, args: Sequence[NumExpr]):
        object.__setattr__(self, "args", tuple(_coerce_num(a) for a in args))

    def get_operands(self):
        """``yc_commutative_number_node::get_operands``."""
        return list(self.args)

    def get_num_operands(self) -> int:
        return len(self.args)

    def add_operand(self, arg) -> None:
        """Append an operand (pre-registration only, like
        ``set_value``)."""
        object.__setattr__(self, "args", self.args + (_coerce_num(arg),))
        object.__setattr__(self, "_skey", None)

    @classmethod
    def make(cls, args: Sequence[NumExpr]) -> NumExpr:
        flat: List[NumExpr] = []
        const_val: Optional[float] = None
        for a in args:
            a = _coerce_num(a)
            if type(a) is cls:
                flat.extend(a.args)
            elif isinstance(a, ConstExpr):
                const_val = a.value if const_val is None else \
                    cls._fold(const_val, a.value)
            else:
                flat.append(a)
        if const_val is not None and (const_val != cls.IDENT or not flat):
            flat.append(ConstExpr(const_val))
        if len(flat) == 1:
            return flat[0]
        return cls(flat)

    @classmethod
    def _fold(cls, a: float, b: float) -> float:
        raise NotImplementedError

    def _key(self):
        return (self.OP, self.args)

    def get_children(self):
        return self.args


class AddExpr(CommutativeExpr):
    __slots__ = ()
    OP = "+"
    IDENT = 0.0

    @classmethod
    def _fold(cls, a, b):
        return a + b

    def accept(self, visitor):
        return visitor.visit_add(self)


class MultExpr(CommutativeExpr):
    __slots__ = ()
    OP = "*"
    IDENT = 1.0

    @classmethod
    def _fold(cls, a, b):
        return a * b

    def accept(self, visitor):
        return visitor.visit_mult(self)


class SubExpr(NumExpr):
    __slots__ = ("lhs", "rhs")

    def __init__(self, lhs: NumExpr, rhs: NumExpr):
        object.__setattr__(self, "lhs", _coerce_num(lhs))
        object.__setattr__(self, "rhs", _coerce_num(rhs))

    def _key(self):
        return (self.lhs, self.rhs)

    def get_children(self):
        return (self.lhs, self.rhs)

    def accept(self, visitor):
        return visitor.visit_sub(self)


class DivExpr(NumExpr):
    __slots__ = ("lhs", "rhs")

    def __init__(self, lhs: NumExpr, rhs: NumExpr):
        object.__setattr__(self, "lhs", _coerce_num(lhs))
        object.__setattr__(self, "rhs", _coerce_num(rhs))

    def _key(self):
        return (self.lhs, self.rhs)

    def get_children(self):
        return (self.lhs, self.rhs)

    def accept(self, visitor):
        return visitor.visit_div(self)


class ModExpr(NumExpr):
    __slots__ = ("lhs", "rhs")

    def __init__(self, lhs: NumExpr, rhs: NumExpr):
        object.__setattr__(self, "lhs", _coerce_num(lhs))
        object.__setattr__(self, "rhs", _coerce_num(rhs))

    def _key(self):
        return (self.lhs, self.rhs)

    def get_children(self):
        return (self.lhs, self.rhs)

    def accept(self, visitor):
        return visitor.visit_mod(self)


#: Math functions supported by the DSL (reference ``Expr.cpp`` FuncExpr set).
FUNC_NAMES = frozenset({
    "sqrt", "cbrt", "fabs", "erf", "exp", "log", "atan",
    "sin", "cos", "tan", "asin", "acos", "pow", "max", "min",
})


class FuncExpr(NumExpr):
    """Math function call (reference ``FuncExpr``)."""

    __slots__ = ("name", "args")

    def __init__(self, name: str, args: Sequence[NumExpr]):
        if name not in FUNC_NAMES:
            raise YaskException(f"unknown stencil function '{name}'")
        object.__setattr__(self, "name", name)
        object.__setattr__(self, "args", tuple(_coerce_num(a) for a in args))

    def _key(self):
        return (self.name, self.args)

    def get_children(self):
        return self.args

    def accept(self, visitor):
        return visitor.visit_func(self)


def _make_func1(name: str):
    def fn(x):
        return FuncExpr(name, (_coerce_num(x),))
    fn.__name__ = name
    fn.__doc__ = f"Build a '{name}' node (reference math-function operator)."
    return fn


sqrt = _make_func1("sqrt")
cbrt = _make_func1("cbrt")
fabs = _make_func1("fabs")
erf = _make_func1("erf")
exp = _make_func1("exp")
log = _make_func1("log")
atan = _make_func1("atan")
sin = _make_func1("sin")
cos = _make_func1("cos")
tan = _make_func1("tan")


def pow_fn(x, y):
    return FuncExpr("pow", (_coerce_num(x), _coerce_num(y)))


def max_fn(x, y):
    return FuncExpr("max", (_coerce_num(x), _coerce_num(y)))


def min_fn(x, y):
    return FuncExpr("min", (_coerce_num(x), _coerce_num(y)))


# ---------------------------------------------------------------------------
# var access points
# ---------------------------------------------------------------------------


def decompose_index_arg(arg) -> Tuple[Optional[str], int]:
    """Reduce a var-subscript expression to ``(index_name | None, offset)``.

    The DSL restricts subscripts to ``index ± const`` for step/domain dims
    and plain consts for misc dims (reference LHS/RHS access rules enforced
    in ``Eqs.cpp:364-470``); this helper normalizes the sugar produced by
    operator overloading (``t+1`` → AddExpr(IndexExpr, ConstExpr)).
    """
    if isinstance(arg, (int, float)):
        return None, int(arg)
    if isinstance(arg, ConstExpr):
        return None, int(arg.value)
    if isinstance(arg, IndexExpr):
        return arg.name, 0
    if isinstance(arg, AddExpr):
        name = None
        ofs = 0
        for a in arg.args:
            if isinstance(a, IndexExpr):
                if name is not None:
                    raise YaskException(
                        f"var subscript uses two indices: {arg.format_simple()}")
                name = a.name
            elif isinstance(a, ConstExpr):
                ofs += int(a.value)
            else:
                raise YaskException(
                    f"unsupported var subscript: {arg.format_simple()}")
        return name, ofs
    if isinstance(arg, SubExpr):
        if isinstance(arg.lhs, IndexExpr) and isinstance(arg.rhs, ConstExpr):
            return arg.lhs.name, -int(arg.rhs.value)
        raise YaskException(
            f"unsupported var subscript: {arg.format_simple()}")
    if isinstance(arg, NegExpr) and isinstance(arg.arg, ConstExpr):
        return None, -int(arg.arg.value)
    raise YaskException(
        f"unsupported var subscript: {arg!r} (must be 'index ± const' "
        "or a constant for misc dims)")


class VarPoint(NumExpr):
    """One access to a var at given index offsets (reference ``VarPoint``,
    ``src/compiler/lib/VarPoint.hpp:34``).

    ``offsets`` maps each of the var's dim names to either an int offset
    relative to its index (step/domain dims) or an absolute int (misc dims).
    """

    __slots__ = ("var", "offsets")

    def __init__(self, var, args: Sequence):
        from yask_tpu_torch.compiler.var import Var  # local to avoid cycle
        if not isinstance(var, Var):
            raise YaskException("VarPoint needs a Var")
        dims = var.get_dims()
        if len(args) != len(dims):
            raise YaskException(
                f"var '{var.get_name()}' has {len(dims)} dims "
                f"but was accessed with {len(args)} subscripts")
        offsets: Dict[str, int] = {}
        for dim, arg in zip(dims, args):
            name, ofs = decompose_index_arg(arg)
            if dim.type == IndexType.MISC:
                if name is not None:
                    raise YaskException(
                        f"misc dim '{dim.name}' of var '{var.get_name()}' "
                        "must be accessed with a constant index")
            else:
                if name is None:
                    raise YaskException(
                        f"dim '{dim.name}' of var '{var.get_name()}' must be "
                        f"accessed via its index (e.g. '{dim.name}+1')")
                if name != dim.name:
                    raise YaskException(
                        f"dim '{dim.name}' of var '{var.get_name()}' accessed "
                        f"with wrong index '{name}'")
            offsets[dim.name] = ofs
        object.__setattr__(self, "var", var)
        object.__setattr__(self, "offsets", offsets)

    # -- accessors ---------------------------------------------------------

    def get_var(self):
        return self.var

    def var_name(self) -> str:
        return self.var.get_name()

    def step_offset(self) -> Optional[int]:
        sd = self.var.step_dim()
        return self.offsets[sd.name] if sd is not None else None

    def domain_offsets(self) -> Dict[str, int]:
        return {d.name: self.offsets[d.name]
                for d in self.var.get_dims() if d.type == IndexType.DOMAIN}

    def misc_vals(self) -> Dict[str, int]:
        return {d.name: self.offsets[d.name]
                for d in self.var.get_dims() if d.type == IndexType.MISC}

    def _key(self):
        return (self.var.get_name(), tuple(sorted(self.offsets.items())))

    def accept(self, visitor):
        return visitor.visit_var_point(self)

    # -- equation former ---------------------------------------------------

    def EQUALS(self, rhs) -> "EqualsExpr":
        """Form an equation writing this point (reference ``EQUALS`` macro /
        ``operator EQUALS``, ``VarPoint.hpp:219``). The equation is
        automatically registered with the var's solution, as in the
        reference."""
        eq = EqualsExpr(self, _coerce_num(rhs))
        soln = self.var.get_solution()
        if soln is not None:
            soln._register_eq(eq)
        return eq

    def __lshift__(self, rhs) -> "EqualsExpr":
        """``lhs << rhs`` sugar for :meth:`EQUALS`."""
        return self.EQUALS(rhs)


# ---------------------------------------------------------------------------
# boolean nodes (sub-domain & step conditions)
# ---------------------------------------------------------------------------


class BoolExpr(Expr):
    """Boolean-valued expression for conditions (reference bool exprs used by
    ``IF_DOMAIN``/``IF_STEP``)."""

    __slots__ = ()

    def __and__(self, other):
        return AndExpr(self, other)

    def __or__(self, other):
        return OrExpr(self, other)

    def __invert__(self):
        return NotExpr(self)


class CompExpr(BoolExpr):
    __slots__ = ("op", "lhs", "rhs")
    OPS = {"==", "!=", "<", "<=", ">", ">="}

    def __init__(self, op: str, lhs: NumExpr, rhs: NumExpr):
        if op not in self.OPS:
            raise YaskException(f"bad comparison op {op}")
        object.__setattr__(self, "op", op)
        object.__setattr__(self, "lhs", _coerce_num(lhs))
        object.__setattr__(self, "rhs", _coerce_num(rhs))

    def _key(self):
        return (self.op, self.lhs, self.rhs)

    def get_children(self):
        return (self.lhs, self.rhs)

    def accept(self, visitor):
        return visitor.visit_comp(self)

    def __bool__(self):
        # Guard against Python `==` being used where `same()` was meant.
        raise YaskException(
            "a stencil comparison is an AST node, not a Python bool; "
            "use it as an IF_DOMAIN/IF_STEP condition")


class AndExpr(BoolExpr):
    __slots__ = ("lhs", "rhs")

    def __init__(self, lhs: BoolExpr, rhs: BoolExpr):
        object.__setattr__(self, "lhs", lhs)
        object.__setattr__(self, "rhs", rhs)

    def _key(self):
        return (self.lhs, self.rhs)

    def get_children(self):
        return (self.lhs, self.rhs)

    def accept(self, visitor):
        return visitor.visit_and(self)


class OrExpr(BoolExpr):
    __slots__ = ("lhs", "rhs")

    def __init__(self, lhs: BoolExpr, rhs: BoolExpr):
        object.__setattr__(self, "lhs", lhs)
        object.__setattr__(self, "rhs", rhs)

    def _key(self):
        return (self.lhs, self.rhs)

    def get_children(self):
        return (self.lhs, self.rhs)

    def accept(self, visitor):
        return visitor.visit_or(self)


class NotExpr(BoolExpr):
    __slots__ = ("arg",)

    def __init__(self, arg: BoolExpr):
        object.__setattr__(self, "arg", arg)

    def _key(self):
        return (self.arg,)

    def get_children(self):
        return (self.arg,)

    def accept(self, visitor):
        return visitor.visit_not(self)


# ---------------------------------------------------------------------------
# equations
# ---------------------------------------------------------------------------


class EqualsExpr(Expr):
    """An equation: ``lhs_point EQUALS rhs [IF_DOMAIN cond] [IF_STEP cond]``
    (reference ``EqualsExpr``, ``VarPoint.hpp:219``)."""

    __slots__ = ("lhs", "rhs", "cond", "step_cond")

    def __init__(self, lhs: VarPoint, rhs: NumExpr,
                 cond: Optional[BoolExpr] = None,
                 step_cond: Optional[BoolExpr] = None):
        if not isinstance(lhs, VarPoint):
            raise YaskException("LHS of EQUALS must be a var access point")
        object.__setattr__(self, "lhs", lhs)
        object.__setattr__(self, "rhs", _coerce_num(rhs))
        object.__setattr__(self, "cond", cond)
        object.__setattr__(self, "step_cond", step_cond)

    def get_lhs(self) -> VarPoint:
        return self.lhs

    def get_rhs(self) -> NumExpr:
        return self.rhs

    def get_cond(self) -> Optional[BoolExpr]:
        return self.cond

    def set_cond(self, cond: Optional[BoolExpr]) -> None:
        """``yc_equation_node::set_cond`` (mutating form of IF_DOMAIN).
        An explicit ``None`` REMOVES the condition (reference
        ``yc_node_api.hpp:207``: nullptr clears)."""
        self._replace(cond=cond)

    def set_step_cond(self, cond: Optional[BoolExpr]) -> None:
        """Like :meth:`set_cond` for the step condition; ``None``
        removes it."""
        self._replace(step_cond=cond)

    def IF_DOMAIN(self, cond: BoolExpr) -> "EqualsExpr":
        """Attach a sub-domain condition (reference ``IF_DOMAIN``). Mutates
        registration in place by replacing this eq in the solution."""
        return self._replace(cond=cond)

    def IF_STEP(self, cond: BoolExpr) -> "EqualsExpr":
        """Attach a step condition (reference ``IF_STEP``)."""
        return self._replace(step_cond=cond)

    _KEEP = object()  # sentinel: "leave this condition unchanged"

    def _replace(self, cond=_KEEP, step_cond=_KEEP) -> "EqualsExpr":
        new = EqualsExpr(self.lhs, self.rhs,
                         self.cond if cond is EqualsExpr._KEEP else cond,
                         self.step_cond if step_cond is EqualsExpr._KEEP
                         else step_cond)
        soln = self.lhs.var.get_solution()
        if soln is not None:
            soln._replace_eq(self, new)
        return new

    def _key(self):
        return (self.lhs, self.rhs, self.cond, self.step_cond)

    def get_children(self):
        out = [self.lhs, self.rhs]
        if self.cond is not None:
            out.append(self.cond)
        if self.step_cond is not None:
            out.append(self.step_cond)
        return tuple(out)

    def accept(self, visitor):
        return visitor.visit_equals(self)


# ---------------------------------------------------------------------------
# visitors
# ---------------------------------------------------------------------------


class ExprVisitor:
    """Base visitor; default behavior visits children (reference
    ``ExprVisitor``, ``src/compiler/lib/Visitor.hpp``)."""

    def _visit_children(self, node: Expr):
        res = None
        for c in node.get_children():
            res = c.accept(self)
        return res

    def visit_const(self, node: ConstExpr):
        return None

    def visit_index(self, node: IndexExpr):
        return None

    def visit_first_index(self, node: FirstIndexExpr):
        return None

    def visit_last_index(self, node: LastIndexExpr):
        return None

    def visit_neg(self, node: NegExpr):
        return self._visit_children(node)

    def visit_add(self, node: AddExpr):
        return self._visit_children(node)

    def visit_mult(self, node: MultExpr):
        return self._visit_children(node)

    def visit_sub(self, node: SubExpr):
        return self._visit_children(node)

    def visit_div(self, node: DivExpr):
        return self._visit_children(node)

    def visit_mod(self, node: ModExpr):
        return self._visit_children(node)

    def visit_func(self, node: FuncExpr):
        return self._visit_children(node)

    def visit_var_point(self, node: VarPoint):
        return None

    def visit_comp(self, node: CompExpr):
        return self._visit_children(node)

    def visit_and(self, node: AndExpr):
        return self._visit_children(node)

    def visit_or(self, node: OrExpr):
        return self._visit_children(node)

    def visit_not(self, node: NotExpr):
        return self._visit_children(node)

    def visit_equals(self, node: EqualsExpr):
        return self._visit_children(node)


class PointVisitor(ExprVisitor):
    """Collects all var access points in an expression tree (used throughout
    analysis; reference's ``PointVisitor`` in ``Eqs.cpp``)."""

    def __init__(self):
        self.points: List[VarPoint] = []

    def visit_var_point(self, node: VarPoint):
        self.points.append(node)


class CounterVisitor(ExprVisitor):
    """Counts ops and points for FLOP/memory estimates (reference
    ``CounterVisitor``, ``ExprUtils.hpp``). ``sincos_args`` holds the
    structural keys of arguments whose sin AND cos both occur — the
    pair is charged one transcendental (reference ``PairingVisitor``,
    ``ExprUtils.hpp:137``; the cos half rides the sin visit)."""

    def __init__(self, sincos_args=None):
        self.num_ops = 0
        self.num_reads = 0
        self.num_writes = 0
        self.num_paired = 0
        self._sincos = sincos_args or set()

    def visit_neg(self, node):
        self.num_ops += 1
        return self._visit_children(node)

    def visit_add(self, node):
        self.num_ops += len(node.args) - 1
        return self._visit_children(node)

    def visit_mult(self, node):
        self.num_ops += len(node.args) - 1
        return self._visit_children(node)

    def visit_sub(self, node):
        self.num_ops += 1
        return self._visit_children(node)

    def visit_div(self, node):
        self.num_ops += 1
        return self._visit_children(node)

    def visit_mod(self, node):
        self.num_ops += 1
        return self._visit_children(node)

    def visit_func(self, node):
        if node.name == "cos" and node.args[0].skey() in self._sincos:
            self.num_paired += 1   # charged on the paired sin visit
        else:
            self.num_ops += 1
        return self._visit_children(node)

    def visit_var_point(self, node):
        self.num_reads += 1

    def visit_equals(self, node):
        self.num_writes += 1
        node.rhs.accept(self)
        if node.cond is not None:
            node.cond.accept(self)
        if node.step_cond is not None:
            node.step_cond.accept(self)


def count_points(expr: Expr) -> List[VarPoint]:
    v = PointVisitor()
    expr.accept(v)
    return v.points


def uses_misc_index(*exprs) -> bool:
    """True when any expression reads a MISC index as a value (its value
    is the equation's pinned LHS misc index — constant per equation, so
    eval memos must not be shared across equations)."""
    class _MV(ExprVisitor):
        found = False

        def visit_index(self, node):
            if node.type == IndexType.MISC:
                self.found = True

    v = _MV()
    for e in exprs:
        if e is not None:
            e.accept(v)
    return v.found


def used_domain_dims(*exprs) -> set:
    """Names of domain dims an expression's VALUE can vary along: via
    domain-index values or var-point reads (a read varies along every
    domain dim of its var).  ``first/last_domain_index`` are run-time
    constants and do not count."""
    names: set = set()

    class _DV(ExprVisitor):
        def visit_index(self, node):
            if node.type == IndexType.DOMAIN:
                names.add(node.name)

        def visit_var_point(self, node):
            names.update(node.get_var().domain_dim_names())

    v = _DV()
    for e in exprs:
        if e is not None:
            e.accept(v)
    return names


def paired_func_eval(ops_func, e: "FuncExpr", args, memo, sincos_args):
    """Evaluate a FuncExpr with sin/cos pairing: when the argument's sin
    AND cos both occur in the solution (``SolutionAnalysis.sincos_args``,
    reference ``PairingVisitor`` ``ExprUtils.hpp:137``), the partner is
    materialized under its own CSE key in this same visit. THE single
    definition — both the XLA and Pallas eval dispatchers call this, so
    pairing semantics cannot drift between backends."""
    r = ops_func(e.name, args)
    if e.name in ("sin", "cos") and e.args[0].skey() in sincos_args:
        partner = "cos" if e.name == "sin" else "sin"
        pk = FuncExpr(partner, e.args).skey()
        if pk not in memo:
            memo[pk] = ops_func(partner, args)
    return r
