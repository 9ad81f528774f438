"""Deterministic var initialization for validation/benchmark runs.

A copy of ``yask_tpu/runtime/init_utils.py`` (the harness' ``-init_seed``
pattern, reference ``yask_main.cpp:239-249``): written (state) vars get a
position-dependent sequence; read-only coefficient vars get values near 1
with small variation — safe as divisors and mild as multipliers.  Values
depend on interior coordinates only, so the port and ``yask_tpu`` start
from identical state.  The serving layer's ``sub_sizes`` fill waits for
the port of serving (ROADMAP.md A13).
"""

from __future__ import annotations


def init_solution_vars(ctx, seed: float = 0.05) -> None:
    written = {eq.lhs.var_name() for eq in ctx._soln.get_equations()}
    for i, name in enumerate(sorted(ctx.get_var_names())):
        if name in written:
            ctx.get_var(name).set_elements_in_seq(seed * (1 + i % 3))
        else:
            for slot in range(len(ctx._state[name])):
                ctx._fill_interior(
                    name, slot,
                    lambda xp, n: 1.0 + 0.01 * (
                        xp.arange(n, dtype=xp.float64) % 13))
