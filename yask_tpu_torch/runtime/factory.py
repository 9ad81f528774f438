"""Kernel factory: ``yk_factory``.

Counterpart of ``yask_tpu/runtime/factory.py`` (reference ``yk_factory``,
``src/kernel/lib/factory.cpp:36-107``): ``new_env`` picks the devices,
``new_solution`` instantiates a runnable context from a DSL solution
object or a registered stencil name.
"""

from __future__ import annotations

from typing import Optional

from yask_tpu_torch.utils.exceptions import YaskException
from yask_tpu_torch.runtime.env import yk_env
from yask_tpu_torch.runtime.context import StencilContext


class yk_factory:
    def get_version_string(self) -> str:
        from yask_tpu_torch import __version__
        return __version__

    def new_env(self, device=None, devices=None) -> yk_env:
        """An env over every visible CUDA device, or over ``device`` or
        the list ``devices`` when given (repeats allowed; ``"cpu"`` is
        the only way onto the CPU)."""
        return yk_env(device=device, devices=devices)

    def new_solution(self, env: yk_env, source=None, *,
                     stencil: Optional[str] = None,
                     radius: Optional[int] = None,
                     dtype=None) -> StencilContext:
        """Build a runnable solution from ``source`` (a ``yc_solution``,
        ``yc_solution_base`` or ``CompiledSolution``) or from the
        registered ``stencil=`` (+ optional ``radius=``)."""
        if source is None:
            if stencil is None:
                raise YaskException(
                    "new_solution needs a solution object or stencil=")
            from yask_tpu_torch.compiler.solution_base import create_solution
            source = create_solution(stencil, radius=radius)
        return StencilContext(env, source, dtype=dtype)
