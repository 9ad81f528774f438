"""Stencil variables (the compiler-side ``yc_var``).

Counterpart of the reference's ``Var``/``Vars``/``yc_var_proxy``
(``src/compiler/lib/Var.hpp:45,354``, ``include/yask_compiler_api.hpp:1046``):
an N-D variable over step/domain/misc dims. Calling the var with index
expressions (``u(t+1, x, y, z)``) yields a :class:`VarPoint` access node.

Halo and lifespan bookkeeping recorded here is filled in by equation analysis
(``yask_tpu_torch.compiler.analysis``), mirroring how the reference updates halos
per stage during ``calc_halos`` (``Eqs.cpp:1614``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

from yask_tpu_torch.utils.exceptions import YaskException
from yask_tpu_torch.compiler.expr import IndexExpr, IndexType, VarPoint


class Var:
    """A compiler-side stencil variable (``yc_var``)."""

    def __init__(self, name: str, dims: Sequence[IndexExpr], solution=None,
                 is_scratch: bool = False):
        if not name.isidentifier():
            raise YaskException(f"invalid var name '{name}'")
        seen = set()
        step_seen = False
        for d in dims:
            if not isinstance(d, IndexExpr):
                raise YaskException(
                    f"var '{name}' dim {d!r} is not an index created by "
                    "new_step_index/new_domain_index/new_misc_index")
            if d.name in seen:
                raise YaskException(f"var '{name}' repeats dim '{d.name}'")
            seen.add(d.name)
            if d.type == IndexType.STEP:
                if step_seen:
                    raise YaskException(
                        f"var '{name}' has more than one step dim")
                step_seen = True
        if is_scratch and step_seen:
            raise YaskException(
                f"scratch var '{name}' may not use a step dim "
                "(reference rule, Eqs.cpp LHS checks)")
        self._name = name
        self._dims: Tuple[IndexExpr, ...] = tuple(dims)
        self._soln = solution
        self._is_scratch = is_scratch

        # Filled by analysis (calc_halos / calc_lifespans analogs):
        # halo per domain dim: {dim: (left>=0, right>=0)}
        self.halo: Dict[str, Tuple[int, int]] = {
            d.name: (0, 0) for d in self._dims if d.type == IndexType.DOMAIN}
        # range of misc indices accessed: {dim: (min, max)}
        self.misc_range: Dict[str, Tuple[int, int]] = {
            d.name: (0, 0) for d in self._dims if d.type == IndexType.MISC}
        # step offsets read/written: used for step_alloc
        self._step_alloc: Optional[int] = None  # user override
        self.step_offsets_used: List[int] = []
        # per-step-offset max |domain offset| among reads (for write-back)
        self.step_read_halo: Dict[int, int] = {}
        self.is_read = False
        self.is_written = False

    # ---- identity --------------------------------------------------------

    def __deepcopy__(self, memo):
        # Vars are identities (storage declarations): clone_ast of any
        # expression referencing one keeps pointing at the same var.
        return self

    def get_name(self) -> str:
        return self._name

    def get_solution(self):
        return self._soln

    def is_scratch(self) -> bool:
        return self._is_scratch

    # ---- dims ------------------------------------------------------------

    def get_num_dims(self) -> int:
        return len(self._dims)

    def get_dims(self) -> Tuple[IndexExpr, ...]:
        return self._dims

    def get_dim_names(self) -> List[str]:
        return [d.name for d in self._dims]

    def step_dim(self) -> Optional[IndexExpr]:
        for d in self._dims:
            if d.type == IndexType.STEP:
                return d
        return None

    def domain_dim_names(self) -> List[str]:
        return [d.name for d in self._dims if d.type == IndexType.DOMAIN]

    def misc_dim_names(self) -> List[str]:
        return [d.name for d in self._dims if d.type == IndexType.MISC]

    # ---- access ----------------------------------------------------------

    def __call__(self, *args) -> VarPoint:
        return VarPoint(self, args)

    # ---- halo / alloc bookkeeping ---------------------------------------

    def update_halo(self, dim: str, offset: int) -> None:
        """Grow the halo to cover a read at ``offset`` in ``dim``
        (reference ``Var::update_halo``)."""
        left, right = self.halo[dim]
        if offset < 0:
            left = max(left, -offset)
        else:
            right = max(right, offset)
        self.halo[dim] = (left, right)

    def update_misc_range(self, dim: str, val: int) -> None:
        lo, hi = self.misc_range[dim]
        self.misc_range[dim] = (min(lo, val), max(hi, val))

    def get_halo_sizes(self) -> Dict[str, Tuple[int, int]]:
        return dict(self.halo)

    def max_halo(self) -> int:
        return max((max(l, r) for l, r in self.halo.values()), default=0)

    # ---- step allocation -------------------------------------------------

    def set_step_alloc_size(self, n: int) -> None:
        """Override #step slots kept live (``yc_var::set_step_alloc_size``)."""
        if n < 1:
            raise YaskException("step_alloc must be >= 1")
        self._step_alloc = n

    set_alloc_size = set_step_alloc_size   # v2 name

    def set_dynamic_step_alloc(self, enable: bool) -> None:
        """Accepted for parity (``yc_var::set_dynamic_step_alloc``):
        XLA's static shapes make every ring allocation fixed at prepare
        time, so the flag records intent only."""
        self._dynamic_step_alloc = bool(enable)

    def is_dynamic_step_alloc(self) -> bool:
        return getattr(self, "_dynamic_step_alloc", False)

    def set_prefetch_dist(self, dist: int) -> None:
        """Accepted for parity (``yc_var::set_prefetch_dist``): software
        prefetch is subsumed by the Pallas input-DMA double buffering
        (pipeline_dmas), which streams the next tile while computing."""
        self._prefetch_dist = int(dist)

    def get_prefetch_dist(self) -> int:
        return getattr(self, "_prefetch_dist", 0)

    def min_step_alloc_size(self) -> int:
        """The ring depth this var's step accesses actually NEED,
        ignoring any manual :meth:`set_step_alloc_size` override: the
        span of step offsets used, *minus one* when the extreme read
        offset carries no spatial halo — then its slot doubles as the
        write target, point-wise-safely (the reference's write-back
        optimization; for 2nd-order-in-time stencils like iso3dfd this
        is 2 buffers instead of 3).  The static checker compares a
        manual override against this floor (RING-DEPTH rule)."""
        if self.step_dim() is None:
            return 1
        if not self.step_offsets_used:
            return 2
        hi, lo = max(self.step_offsets_used), min(self.step_offsets_used)
        span = hi - lo + 1
        if span >= 2 and self.is_written:
            # The write sits at the +1 end (forward stepping) or the -1 end
            # (reverse); the extreme *read* offset is the opposite end.
            extreme = lo if hi >= 1 else hi
            if self.step_read_halo.get(extreme, None) == 0:
                span -= 1
        return max(span, 1)

    def get_step_alloc_size(self) -> int:
        """#step slots kept (reference lifespan calc, ``Eqs.cpp:1912``):
        the manual override when set, else :meth:`min_step_alloc_size`."""
        if self._step_alloc is not None:
            return self._step_alloc
        return self.min_step_alloc_size()

    def __repr__(self):
        kind = "scratch " if self._is_scratch else ""
        return (f"<{kind}Var {self._name}"
                f"({', '.join(self.get_dim_names())})>")


# The reference exposes vars to users through `yc_var_proxy`; here the var is
# directly callable, so the proxy is just an alias.
yc_var = Var
