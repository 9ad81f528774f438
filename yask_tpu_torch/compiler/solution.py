"""Compiler-side solution: the ``yc_solution`` / ``yc_factory`` API.

Counterpart of the reference's ``yc_solution``
(``include/yask_compiler_api.hpp:409-575``, impl
``src/compiler/lib/Solution.cpp``): owns indices, vars, and equations; runs
the analysis pipeline (``analyze_solution``, ``Solution.cpp:127-160``); and
"outputs" the solution for a target. Where the reference emits C++ source
text per target (``Solution.cpp:241-259``), the TPU targets here produce a
:class:`~yask_tpu_torch.compiler.lowering.CompiledSolution` executing as
PyTorch tensors and hand-written CUDA kernels.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from yask_tpu_torch.utils.exceptions import YaskException
from yask_tpu_torch.utils.idx_tuple import IdxTuple
from yask_tpu_torch.compiler.expr import (
    BoolExpr,
    EqualsExpr,
    IndexExpr,
    IndexType,
    NumExpr,
    VarPoint,
    _coerce_num,
)
from yask_tpu_torch.compiler.var import Var


#: Supported lowering/output targets. The first group are TPU lowerings; the
#: second group are debug text formats mirroring the reference's
#: pseudo/dot printers (``Solution.cpp:241-259``).
TPU_TARGETS = ("tpu", "jnp", "pallas")
TEXT_TARGETS = ("pseudo", "pseudo-long", "dot", "dot-lite", "povray",
                "py-api")
ALL_TARGETS = TPU_TARGETS + TEXT_TARGETS


class CompilerSettings:
    """Compiler knobs (reference ``CompilerSettings``,
    ``src/compiler/lib/Settings.hpp:39-75``). Vectorization/prefetch options
    become tile-planning hints for the Pallas backend; options that have no
    TPU meaning are accepted and recorded for API parity."""

    def __init__(self):
        self.target: str = "tpu"
        self.elem_bytes: int = 4            # -elem-bytes {4|8}
        self.fold: IdxTuple = IdxTuple()    # -fold x=8,y=128 style tile hints
        self.cluster: IdxTuple = IdxTuple()  # accepted; unused on TPU
        self.do_cse: bool = True            # -[no]-cse
        self.do_pairs: bool = True          # -[no]-pair-funcs (sincos etc.)
        self.max_expr_size: int = 0         # accepted; XLA does its own CSE
        self.step_alloc: int = 0            # -step-alloc override (0 = auto)
        self.min_buffer_len: int = 0
        self.bundle_scratch: bool = True


class yc_solution:
    """A stencil solution being built & compiled (``yc_solution``)."""

    def __init__(self, name: str):
        self._name = name
        self._desc = ""
        self._settings = CompilerSettings()
        self._indices: Dict[str, IndexExpr] = {}
        self._vars: Dict[str, Var] = {}
        self._eqs: List[EqualsExpr] = []
        self._analysis = None  # cached SolutionAnalysis
        # dependency-checker toggle (yc_solution::set_dependency_checker_enabled,
        # yask_compiler_api.hpp:575): when disabled, declared step-race eqs
        # are allowed through.
        self._dep_check = True

    # ---- identity & settings --------------------------------------------

    def get_name(self) -> str:
        return self._name

    def set_name(self, name: str) -> None:
        self._name = name

    def get_description(self) -> str:
        return self._desc or self._name

    def set_description(self, d: str) -> None:
        self._desc = d

    def get_settings(self) -> CompilerSettings:
        return self._settings

    def set_target(self, target: str) -> None:
        if target not in ALL_TARGETS:
            raise YaskException(
                f"unknown target '{target}'; expected one of {ALL_TARGETS}")
        self._settings.target = target

    def get_target(self) -> str:
        return self._settings.target

    def is_target_set(self) -> bool:
        return True

    def set_element_bytes(self, n: int) -> None:
        if n not in (2, 4, 8):
            raise YaskException("element bytes must be 2, 4, or 8")
        self._settings.elem_bytes = n

    def get_element_bytes(self) -> int:
        return self._settings.elem_bytes

    def set_fold_len(self, dim, length: int) -> None:
        """Vector-fold hint: on TPU this biases which dims map onto the
        (sublane, lane) register tile in the Pallas tile planner (SURVEY
        'fold↔(8,128)' note) rather than choosing a SIMD layout."""
        name = dim.name if isinstance(dim, IndexExpr) else str(dim)
        if self._settings.fold.has_dim(name):
            self._settings.fold[name] = length
        else:
            self._settings.fold.add_dim_back(name, length)

    def clear_folding(self) -> None:
        self._settings.fold = IdxTuple()

    def set_cluster_mult(self, dim, mult: int) -> None:
        """Accepted for API parity; XLA unrolling replaces clustering."""
        name = dim.name if isinstance(dim, IndexExpr) else str(dim)
        if self._settings.cluster.has_dim(name):
            self._settings.cluster[name] = mult
        else:
            self._settings.cluster.add_dim_back(name, mult)

    def clear_clustering(self) -> None:
        self._settings.cluster = IdxTuple()

    def set_dependency_checker_enabled(self, enable: bool) -> None:
        self._dep_check = enable

    def is_dependency_checker_enabled(self) -> bool:
        return self._dep_check

    # ---- indices ---------------------------------------------------------

    def _new_index(self, name: str, t: IndexType) -> IndexExpr:
        if name in self._indices:
            existing = self._indices[name]
            if existing.type != t:
                raise YaskException(
                    f"index '{name}' already exists with type "
                    f"{existing.type.value}")
            return existing
        idx = IndexExpr(name, t)
        self._indices[name] = idx
        return idx

    def new_step_index(self, name: str) -> IndexExpr:
        return self._new_index(name, IndexType.STEP)

    def new_domain_index(self, name: str) -> IndexExpr:
        return self._new_index(name, IndexType.DOMAIN)

    def new_misc_index(self, name: str) -> IndexExpr:
        return self._new_index(name, IndexType.MISC)

    def get_indices(self) -> Dict[str, IndexExpr]:
        return dict(self._indices)

    def step_dim_name(self) -> Optional[str]:
        for idx in self._indices.values():
            if idx.type == IndexType.STEP:
                return idx.name
        return None

    def domain_dim_names(self) -> List[str]:
        # Explicit order when set_domain_dims was called; else ordered
        # by first var using them (reference orders by declaration).
        if getattr(self, "_explicit_domain_dims", None):
            return list(self._explicit_domain_dims)
        out: List[str] = []
        for v in self._vars.values():
            for d in v.get_dims():
                if d.type == IndexType.DOMAIN and d.name not in out:
                    out.append(d.name)
        for idx in self._indices.values():
            if idx.type == IndexType.DOMAIN and idx.name not in out:
                out.append(idx.name)
        return out

    def set_domain_dims(self, dims: Sequence[IndexExpr]) -> None:
        """Explicitly declare and ORDER the domain dims
        (``yask_compiler_api.hpp:538``): the order drives memory layout
        (the last one becomes the lane axis), looping, and rank
        layout — and covers solutions where no var carries every dim."""
        names = []
        for d in dims:
            if not isinstance(d, IndexExpr) or d.type != IndexType.DOMAIN:
                raise YaskException(
                    "set_domain_dims takes domain index nodes")
            self._indices.setdefault(d.name, d)
            names.append(d.name)
        self._explicit_domain_dims = names
        self._analysis = None

    def set_step_dim(self, dim: IndexExpr) -> None:
        """Explicitly declare the step dim (``yask_compiler_api.hpp``)."""
        if not isinstance(dim, IndexExpr) or dim.type != IndexType.STEP:
            raise YaskException("set_step_dim takes a step index node")
        self._indices.setdefault(dim.name, dim)

    # ---- vars ------------------------------------------------------------

    def new_var(self, name: str, dims: Sequence[IndexExpr]) -> Var:
        """Create an N-D var (``yc_solution::new_var``)."""
        if name in self._vars:
            raise YaskException(f"duplicate var '{name}'")
        for d in dims:
            if isinstance(d, IndexExpr):
                self._indices.setdefault(d.name, d)
        v = Var(name, dims, solution=self)
        self._vars[name] = v
        return v

    def new_scratch_var(self, name: str, dims: Sequence[IndexExpr]) -> Var:
        """Create a scratch var: storage-only-within-a-step temporary
        (``yc_solution::new_scratch_var``; reference scratch semantics in
        ``Eqs.cpp`` scratch dep chains)."""
        if name in self._vars:
            raise YaskException(f"duplicate var '{name}'")
        v = Var(name, dims, solution=self, is_scratch=True)
        self._vars[name] = v
        return v

    def get_var(self, name: str) -> Var:
        if name not in self._vars:
            raise YaskException(f"no var named '{name}'")
        return self._vars[name]

    def get_vars(self) -> List[Var]:
        return list(self._vars.values())

    def get_num_vars(self) -> int:
        return len(self._vars)

    # ---- equations -------------------------------------------------------

    def _register_eq(self, eq: EqualsExpr) -> None:
        self._eqs.append(eq)
        self._analysis = None

    def _replace_eq(self, old: EqualsExpr, new: EqualsExpr) -> None:
        for i, e in enumerate(self._eqs):
            if e is old:
                self._eqs[i] = new
                self._analysis = None
                return
        # not registered (eq built via node factory w/o auto-registration)
        self._eqs.append(new)
        self._analysis = None

    def add_eq(self, lhs: VarPoint, rhs, cond: Optional[BoolExpr] = None,
               step_cond: Optional[BoolExpr] = None) -> EqualsExpr:
        """Explicitly add an equation (node-factory style)."""
        eq = EqualsExpr(lhs, _coerce_num(rhs), cond, step_cond)
        self._register_eq(eq)
        return eq

    def get_equations(self) -> List[EqualsExpr]:
        return list(self._eqs)

    def get_num_equations(self) -> int:
        return len(self._eqs)

    def clear_equations(self) -> None:
        self._eqs.clear()
        self._analysis = None

    # ---- v2 "grid" aliases + advanced hooks (yask_compiler_api.hpp) --

    new_grid = new_var
    new_scratch_grid = new_scratch_var
    get_grid = get_var
    get_grids = get_vars
    get_num_grids = get_num_vars

    def add_flow_dependency(self, from_eq: EqualsExpr,
                            to_eq: EqualsExpr) -> None:
        """Declare that ``from_eq`` evaluates before ``to_eq``
        (``yask_compiler_api.hpp:657``) — the manual channel when the
        automatic dependency checker is disabled; edges merge into the
        analysis dep graph either way."""
        if not hasattr(self, "_manual_deps"):
            self._manual_deps = []
        self._manual_deps.append((from_eq, to_eq))
        self._analysis = None

    def clear_dependencies(self) -> None:
        """Remove edges added via ``add_flow_dependency``."""
        self._manual_deps = []
        self._analysis = None

    def call_after_new_solution(self, code) -> None:
        """Register code to run right after the KERNEL solution is
        constructed (``yask_compiler_api.hpp:515``).  The reference
        injects a C++ block; here pass a callable taking the kernel
        solution, or a Python source string executed with
        ``kernel_soln`` bound."""
        if not hasattr(self, "_after_new_solution"):
            self._after_new_solution = []
        self._after_new_solution.append(code)

    def call_before_output(self, hook) -> None:
        """Register ``hook(soln, output)`` to run during
        ``output_solution`` after optimization, before writing
        (``yask_compiler_api.hpp:486``)."""
        if not hasattr(self, "_before_output"):
            self._before_output = []
        self._before_output.append(hook)

    # ---- analysis & output ----------------------------------------------

    def analyze(self):
        """Run the analysis pipeline and cache the result (counterpart of
        ``Solution::analyze_solution``, ``Solution.cpp:127-160``)."""
        if self._analysis is None:
            from yask_tpu_torch.compiler.analysis import SolutionAnalysis
            self._analysis = SolutionAnalysis(self)
        return self._analysis

    def compile(self, **kwargs):
        """Lower to an executable :class:`CompiledSolution` for the current
        TPU target (the runtime's entry point into the compiler)."""
        from yask_tpu_torch.compiler.lowering import CompiledSolution
        return CompiledSolution(self, self.analyze(), **kwargs)

    def output_solution(self, output) -> None:
        """Write the solution in the selected target format (counterpart of
        ``yc_solution::output_solution``, ``Solution.cpp:211``). For text
        targets this writes pseudo/dot text; for TPU targets it writes a
        self-contained Python module that rebuilds and compiles the solution
        (the analog of the reference emitting a C++ header)."""
        raise YaskException(
            f"output_solution (target '{self._settings.target}') needs "
            "the port of compiler/printers.py: ROADMAP.md A2 (printers)")

    # ---- CLI parity ------------------------------------------------------

    def apply_command_line_options(self, args) -> List[str]:
        """Apply compiler options from a command line
        (``yc_solution::apply_command_line_options``)."""
        if isinstance(args, str):
            args = args.split()
        from yask_tpu_torch.utils.cli import CommandLineParser

        class _Tgt:
            pass

        tgt = _Tgt()
        tgt.target = self._settings.target
        tgt.elem_bytes = self._settings.elem_bytes
        tgt.fold = ""
        tgt.cse = self._settings.do_cse
        p = CommandLineParser()
        p.add_string_option("target", "Lowering target.", tgt, "target")
        p.add_int_option("elem-bytes", "FP element size.", tgt, "elem_bytes")
        p.add_string_option("fold", "Tile-shape hint, e.g. 'x=8,y=128'.",
                            tgt, "fold")
        p.add_bool_option("cse", "Common-subexpr elimination.", tgt, "cse")
        rest = p.parse_args(list(args))
        self.set_target(tgt.target)
        self.set_element_bytes(tgt.elem_bytes)
        self._settings.do_cse = tgt.cse
        if tgt.fold:
            from yask_tpu_torch.utils.idx_tuple import parse_dim_val_str
            self._settings.fold = parse_dim_val_str(tgt.fold)
        return rest

    def get_command_line_help(self) -> str:
        return ("-target <tpu|jnp|pallas|pseudo|pseudo-long|dot|dot-lite|"
                "py-api>\n-elem-bytes <2|4|8>\n-fold <dim=val,...>\n"
                "-[no-]cse\n")

    def __repr__(self):
        return (f"<yc_solution '{self._name}': {len(self._vars)} vars, "
                f"{len(self._eqs)} eqs>")


class yc_factory:
    """Factory mirroring ``yc_factory`` (``yask_compiler_api.hpp:112``)."""

    def new_solution(self, name: str) -> yc_solution:
        return yc_solution(name)

    def get_version_string(self) -> str:
        from yask_tpu_torch import __version__
        return __version__
