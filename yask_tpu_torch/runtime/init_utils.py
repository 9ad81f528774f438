"""Deterministic var initialization for validation/benchmark runs.

A copy of ``yask_tpu/runtime/init_utils.py`` (the harness' ``-init_seed``
pattern, reference ``yask_main.cpp:239-249``): written (state) vars get a
position-dependent sequence; read-only coefficient vars get values near 1
with small variation — safe as divisors and mild as multipliers.  Values
depend on interior coordinates only, so the port and ``yask_tpu`` start
from identical state.

``sub_sizes`` (serve-side shape bucketing) restricts the fill to the
low-corner sub-domain and generates the SAME values a solo context at
those sizes would: the value sequence is laid out over the sub-domain
shape, not the host geometry's, so a bucketed tenant and its solo oracle
start bit-identical.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def _fill_sub_interior(ctx, name: str, value_fn,
                       sub_sizes: Dict[str, int]) -> None:
    """Zero each ring slot, then fill the low-corner sub-interior with
    ``value_fn(xp, n, slot)`` values laid out over the sub-domain shape."""
    g = ctx._program.geoms[name]
    for slot in range(len(ctx._state[name])):
        def fill(a, s=slot):
            idxs, ishape = [], []
            for ax, (dn, kind) in enumerate(g.axes):
                if kind == "domain":
                    size = int(sub_sizes.get(
                        dn, ctx._opts.global_domain_sizes[dn]))
                    idxs.append(slice(g.origin[dn], g.origin[dn] + size))
                    ishape.append(size)
                else:
                    idxs.append(slice(None))
                    ishape.append(a.shape[ax])
            n = int(np.prod(ishape)) if ishape else 1
            out = np.zeros_like(a)
            out[tuple(idxs)] = value_fn(np, n, s).reshape(ishape)
            return out
        ctx._update_state_array(name, slot, fill)


def init_solution_vars(ctx, seed: float = 0.05,
                       sub_sizes: Optional[Dict[str, int]] = None) -> None:
    def coeff(xp, n, _s=0):
        return 1.0 + 0.01 * (xp.arange(n, dtype=xp.float64) % 13)

    written = {eq.lhs.var_name() for eq in ctx._soln.get_equations()}
    for i, name in enumerate(sorted(ctx.get_var_names())):
        if sub_sizes is not None:
            s0 = seed * (1 + i % 3)
            fn = coeff if name not in written else (
                lambda xp, n, s, s0=s0:
                    (xp.arange(n, dtype=xp.float64) % 17 + 1.0)
                    * (s0 * (s + 1)))
            _fill_sub_interior(ctx, name, fn, sub_sizes)
        elif name in written:
            ctx.get_var(name).set_elements_in_seq(seed * (1 + i % 3))
        else:
            for slot in range(len(ctx._state[name])):
                ctx._fill_interior(name, slot, coeff)
