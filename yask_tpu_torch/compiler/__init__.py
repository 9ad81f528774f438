"""Stencil DSL compiler: AST → analysis → PyTorch/CUDA lowering.

The DSL and analysis are copies of ``yask_tpu.compiler`` (the port keeps
its own copies and imports nothing of the JAX package); ``lowering``
executes an analyzed solution on PyTorch tensors, and ``ops.cuda_emit``
prints its per-point update as CUDA C++.
"""

from yask_tpu_torch.compiler.expr import (
    ConstExpr,
    IndexExpr,
    IndexType,
    NumExpr,
    VarPoint,
    EqualsExpr,
)
from yask_tpu_torch.compiler.var import Var
from yask_tpu_torch.compiler.solution import yc_solution, yc_factory
from yask_tpu_torch.compiler.solution_base import (
    yc_solution_base,
    yc_solution_with_radius_base,
    register_solution,
    get_registered_solutions,
)
from yask_tpu_torch.compiler.node_api import yc_node_factory

__all__ = [
    "ConstExpr", "IndexExpr", "IndexType", "NumExpr", "VarPoint",
    "EqualsExpr", "Var", "yc_solution", "yc_factory", "yc_solution_base",
    "yc_solution_with_radius_base", "register_solution",
    "get_registered_solutions", "yc_node_factory",
]
