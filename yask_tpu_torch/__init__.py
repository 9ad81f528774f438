"""yask_tpu_torch — the PyTorch/CUDA port of yask_tpu, for one NVIDIA H100.

The same ``yc_*`` DSL and ``yk_*`` API as ``yask_tpu`` (which stays the
reference): a solution is built, prepared, run in K-step chunks, read
back, validated and reported through the same calls.  Plain tensor code
is PyTorch; the fused stencil kernel (K1, ``ops/fused_stencil.py``) is
CUDA C++ for ``sm_90a`` written by hand and emitted per solution.

The package imports ``torch`` and numpy, never ``jax`` and nothing of
``yask_tpu``: the modules it shares with the reference are its own
copies.  ``yk_factory().new_env()`` runs on ``cuda:0``; the CPU is used
only on request (``new_env(device="cpu")``).
"""

__version__ = "0.1.0"

from yask_tpu_torch.utils.exceptions import YaskException  # noqa: F401
from yask_tpu_torch.utils.idx_tuple import IdxTuple  # noqa: F401
from yask_tpu_torch.utils.fd_coeff import (  # noqa: F401
    get_center_fd_coefficients,
    get_forward_fd_coefficients,
    get_backward_fd_coefficients,
    get_arbitrary_fd_coefficients,
)
from yask_tpu_torch.utils.cli import CommandLineParser  # noqa: F401

from yask_tpu_torch.compiler.node_api import yc_node_factory  # noqa: F401
from yask_tpu_torch.compiler.solution import yc_factory, yc_solution  # noqa: F401
from yask_tpu_torch.compiler.solution_base import (  # noqa: F401
    yc_solution_base,
    yc_solution_with_radius_base,
    register_solution,
    get_registered_solutions,
)

from yask_tpu_torch.runtime.factory import yk_factory  # noqa: F401


def quick_run(stencil: str, g: int = 64, steps: int = 10, radius=None,
              mode: str = "auto", device=None, **settings):
    """One-liner: build a registered stencil on ``device`` (default
    ``cuda:0``), seq-init its vars, run ``steps`` steps, and return the
    context (read results via ``ctx.get_var(...)`` / ``ctx.get_stats()``).

    >>> ctx = yask_tpu_torch.quick_run("iso3dfd", g=128, steps=20,
    ...                                radius=8, mode="fused")
    """
    fac = yk_factory()
    env = fac.new_env(device=device)
    ctx = fac.new_solution(env, stencil=stencil, radius=radius)
    ctx.apply_command_line_options(f"-g {g}")
    ctx.get_settings().mode = mode
    for k, v in settings.items():
        if not hasattr(ctx.get_settings(), k):
            raise YaskException(f"unknown kernel setting '{k}'")
        setattr(ctx.get_settings(), k, v)
    ctx.prepare_solution()
    from yask_tpu_torch.runtime.init_utils import init_solution_vars
    init_solution_vars(ctx)
    if steps > 0:
        ctx.run_solution(0, steps - 1)
    return ctx
