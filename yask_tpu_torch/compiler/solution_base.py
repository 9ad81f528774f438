"""Solution base classes and the stencil registry.

Counterpart of ``yc_solution_base`` / ``yc_solution_with_radius_base`` and the
``REGISTER_SOLUTION`` static-registration mechanism
(``include/aux/yc_solution_api.hpp:57,246``): stencil definitions subclass a
base, implement ``define()``, and register by name so the CLI/harness can
instantiate them (``src/compiler/compiler_main.cpp:181``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Type

from yask_tpu_torch.utils.exceptions import YaskException
from yask_tpu_torch.compiler.node_api import yc_node_factory
from yask_tpu_torch.compiler.solution import yc_factory, yc_solution


_REGISTRY: Dict[str, Type["yc_solution_base"]] = {}


def register_solution(cls: Type["yc_solution_base"]):
    """Class decorator: the Python spelling of ``REGISTER_SOLUTION``.

    Registration is keyed by the name the class passes to the base
    constructor; we instantiate once lazily to learn it, matching the
    reference where construction-time static objects self-register."""
    probe = cls()
    name = probe.get_soln().get_name()
    if name in _REGISTRY:
        raise YaskException(f"duplicate registered solution '{name}'")
    _REGISTRY[name] = cls
    return cls


def get_registered_solutions() -> List[str]:
    """Names of all registered stencils (``compiler_main`` list support)."""
    _ensure_library_loaded()
    return sorted(_REGISTRY)


def create_solution(name: str, radius: Optional[int] = None,
                    **kwargs) -> "yc_solution_base":
    """Instantiate a registered stencil, optionally setting the radius, and
    run its ``define()`` (what ``compiler_main.cpp:181-204`` does)."""
    _ensure_library_loaded()
    if name not in _REGISTRY:
        raise YaskException(
            f"unknown stencil '{name}'; known: {', '.join(sorted(_REGISTRY))}")
    obj = _REGISTRY[name](**kwargs)
    if radius is not None:
        if not isinstance(obj, yc_solution_with_radius_base):
            raise YaskException(f"stencil '{name}' takes no radius")
        if not obj.set_radius(radius):
            raise YaskException(f"invalid radius {radius} for '{name}'")
    obj.run_define()
    return obj


def _ensure_library_loaded() -> None:
    # Importing the library package runs all @register_solution decorators.
    import yask_tpu_torch.stencils  # noqa: F401


class yc_solution_base:
    """Base class for stencil definitions (``yc_solution_base``)."""

    def __init__(self, name: str):
        self._soln = yc_factory().new_solution(name)
        self._nfac = yc_node_factory()
        self._defined = False

    @staticmethod
    def get_registry():
        """Names of registered stencil solutions (the reference's
        ``yc_solution_base::get_registry`` over its static factory
        list)."""
        return get_registered_solutions()

    def __init_subclass__(cls, **kwargs):
        """Wrap each subclass's ``define()`` so ANY successful call —
        including a user calling ``s.define()`` directly before handing
        the object to the runtime — marks the solution defined. This is
        what lets ``run_define`` key purely off the flag/equations
        without re-running ``define()`` (which would raise duplicate-var
        for vars-only solutions) and without mistaking constructor-made
        vars for a completed definition (ADVICE r2: the reference's
        canonical vars-in-constructor pattern must still run define)."""
        super().__init_subclass__(**kwargs)
        if "define" in cls.__dict__:
            import functools
            orig = cls.__dict__["define"]

            @functools.wraps(orig)
            def define(self, *a, **kw):
                r = orig(self, *a, **kw)
                self._defined = True
                return r
            cls.define = define

    def run_define(self) -> None:
        """Run ``define()`` exactly once. Only prior *equations* (or the
        explicit flag) count as already-defined: vars alone must not —
        the reference's canonical pattern creates vars in the
        constructor and equations in ``define()`` (Iso3dfdStencil's
        MAKE_VAR members), and treating those vars as "defined" would
        silently skip ``define()`` and run a no-op solution. Legal
        zero-equation solutions (test_empty family) are covered by the
        flag, set after their (empty-ish) ``define()`` runs."""
        if self._defined or self._soln.get_num_equations() > 0:
            self._defined = True
            return
        self.define()
        self._defined = True

    def get_soln(self) -> yc_solution:
        return self._soln

    def get_node_factory(self) -> yc_node_factory:
        return self._nfac

    def define(self) -> None:
        raise YaskException(
            f"solution '{self._soln.get_name()}' does not define equations")

    # Convenience index/var helpers used heavily by the stencil library.
    def new_step_index(self, name: str):
        return self._soln.new_step_index(name)

    def new_domain_index(self, name: str):
        return self._soln.new_domain_index(name)

    def new_misc_index(self, name: str):
        return self._soln.new_misc_index(name)

    def new_var(self, name, dims):
        return self._soln.new_var(name, dims)

    def new_scratch_var(self, name, dims):
        return self._soln.new_scratch_var(name, dims)

    def first_domain_index(self, dim):
        return self._nfac.new_first_domain_index(dim)

    def last_domain_index(self, dim):
        return self._nfac.new_last_domain_index(dim)


class yc_solution_with_radius_base(yc_solution_base):
    """Radius-parameterized base (``yc_solution_with_radius_base``): the
    radius scales the FD order (order = 2 × radius for center forms)."""

    def __init__(self, name: str, radius: int = 1):
        super().__init__(name)
        self._radius = 0
        self.set_radius(radius)

    def set_radius(self, radius: int) -> bool:
        ok = radius >= 1
        self._radius = max(radius, 1)
        # Changing radius invalidates previously-built equations.
        self._soln.clear_equations()
        return ok

    def get_radius(self) -> int:
        return self._radius
