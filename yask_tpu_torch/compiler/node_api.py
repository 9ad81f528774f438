"""Node-factory API for building ASTs without operator overloading.

Counterpart of ``yc_node_factory`` (``include/aux/yc_node_api.hpp``,
``yask_compiler_api.hpp``): every expression kind is constructible through an
explicit factory method, which is the surface third-party front-ends (and the
reference's Python API tests) use.
"""

from __future__ import annotations

from typing import Optional, Sequence

from yask_tpu_torch.compiler.expr import (
    AddExpr,
    AndExpr,
    BoolExpr,
    CompExpr,
    ConstExpr,
    DivExpr,
    EqualsExpr,
    FirstIndexExpr,
    FuncExpr,
    IndexExpr,
    IndexType,
    LastIndexExpr,
    ModExpr,
    MultExpr,
    NegExpr,
    NotExpr,
    NumExpr,
    OrExpr,
    SubExpr,
    VarPoint,
    _coerce_num,
)


class yc_node_factory:
    """Explicit AST-node factory (``yc_node_factory``)."""

    # ---- indices ---------------------------------------------------------

    def new_step_index(self, name: str) -> IndexExpr:
        return IndexExpr(name, IndexType.STEP)

    def new_domain_index(self, name: str) -> IndexExpr:
        return IndexExpr(name, IndexType.DOMAIN)

    def new_misc_index(self, name: str) -> IndexExpr:
        return IndexExpr(name, IndexType.MISC)

    def new_first_domain_index(self, dim: IndexExpr) -> FirstIndexExpr:
        return FirstIndexExpr(dim)

    def new_last_domain_index(self, dim: IndexExpr) -> LastIndexExpr:
        return LastIndexExpr(dim)

    # ---- numeric nodes ---------------------------------------------------

    def new_const_number_node(self, val) -> ConstExpr:
        return ConstExpr(val)

    def new_negate_node(self, arg) -> NumExpr:
        return NegExpr(_coerce_num(arg))

    def new_add_node(self, lhs, rhs) -> NumExpr:
        return AddExpr.make([_coerce_num(lhs), _coerce_num(rhs)])

    def new_subtract_node(self, lhs, rhs) -> NumExpr:
        return SubExpr(_coerce_num(lhs), _coerce_num(rhs))

    def new_multiply_node(self, lhs, rhs) -> NumExpr:
        return MultExpr.make([_coerce_num(lhs), _coerce_num(rhs)])

    def new_divide_node(self, lhs, rhs) -> NumExpr:
        return DivExpr(_coerce_num(lhs), _coerce_num(rhs))

    def new_mod_node(self, lhs, rhs) -> NumExpr:
        return ModExpr(_coerce_num(lhs), _coerce_num(rhs))

    def new_math_func_node(self, name: str, args: Sequence) -> FuncExpr:
        return FuncExpr(name, [_coerce_num(a) for a in args])

    # ---- boolean nodes ---------------------------------------------------

    def new_equals_node(self, lhs, rhs) -> CompExpr:
        return CompExpr("==", _coerce_num(lhs), _coerce_num(rhs))

    def new_not_equals_node(self, lhs, rhs) -> CompExpr:
        return CompExpr("!=", _coerce_num(lhs), _coerce_num(rhs))

    def new_less_than_node(self, lhs, rhs) -> CompExpr:
        return CompExpr("<", _coerce_num(lhs), _coerce_num(rhs))

    def new_greater_than_node(self, lhs, rhs) -> CompExpr:
        return CompExpr(">", _coerce_num(lhs), _coerce_num(rhs))

    def new_not_less_than_node(self, lhs, rhs) -> CompExpr:
        return CompExpr(">=", _coerce_num(lhs), _coerce_num(rhs))

    def new_not_greater_than_node(self, lhs, rhs) -> CompExpr:
        return CompExpr("<=", _coerce_num(lhs), _coerce_num(rhs))

    def new_and_node(self, lhs: BoolExpr, rhs: BoolExpr) -> AndExpr:
        return AndExpr(lhs, rhs)

    def new_or_node(self, lhs: BoolExpr, rhs: BoolExpr) -> OrExpr:
        return OrExpr(lhs, rhs)

    def new_not_node(self, arg: BoolExpr) -> NotExpr:
        return NotExpr(arg)

    # ---- equations -------------------------------------------------------

    def new_equation_node(self, lhs: VarPoint, rhs,
                          cond: Optional[BoolExpr] = None) -> EqualsExpr:
        """Build an equation and register it with the LHS var's solution
        (matches the reference's auto-registration behavior)."""
        eq = EqualsExpr(lhs, _coerce_num(rhs), cond)
        soln = lhs.var.get_solution()
        if soln is not None:
            soln._register_eq(eq)
        return eq

    # ---- var-point builders + v2 aliases (yc_node_api.hpp) ------------

    def new_number_node(self, val) -> NumExpr:
        """Coerce a Python number (or pass through a node) —
        ``yc_node_factory::new_number_node`` / the ``yc_number_any_arg``
        conversions."""
        return _coerce_num(val)

    def new_var_point(self, var, index_exprs) -> VarPoint:
        """Access point from explicit index expressions
        (``new_var_point``)."""
        return var(*index_exprs)

    def new_relative_var_point(self, var, dim_offsets) -> VarPoint:
        """Access point from integer offsets relative to each of the
        var's declared dims (``new_relative_var_point``)."""
        args = []
        for d, o in zip(var.get_dims(), dim_offsets):
            args.append(d + int(o) if int(o) != 0 else d)
        return var(*args)

    new_grid_point = new_var_point
    new_relative_grid_point = new_relative_var_point
