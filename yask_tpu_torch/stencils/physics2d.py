"""2-D physics stencils: wave equation and shallow-water equations.

The port's copy of ``yask_tpu/stencils/physics2d.py``: counterparts of the
reference's ``wave2d`` (``Wave2dStencil.cpp:211``) and ``swe2d``
(``SWE2dStencil.cpp:498``). The SWE uses conservative form with
Lax–Friedrichs fluxes built in *scratch vars* — exercising the scratch-chain
machinery the reference's SWE exercises.  ``wave2d`` runs in every mode
(on a single lead dim, ``x``, under ``-trapezoid``); ``swe2d`` runs
``-mode fused`` on K6, whose scratch arm computes its fluxes and whose
rewrite arm applies its walls.
"""

from __future__ import annotations

from yask_tpu_torch.compiler.solution_base import (
    register_solution,
    yc_solution_base,
    yc_solution_with_radius_base,
)


@register_solution
class Wave2dStencil(yc_solution_with_radius_base):
    """'wave2d': 2-D second-order wave equation, order-2r Laplacian."""

    def __init__(self, name: str = "wave2d", radius: int = 1):
        super().__init__(name, radius)

    def define(self):
        from yask_tpu_torch.utils.fd_coeff import get_center_fd_coefficients
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        u = self.new_var("u", [t, x, y])
        c2 = self.new_var("c2", [x, y])   # (c·dt/h)² per cell

        r = self.get_radius()
        c = get_center_fd_coefficients(2, r)
        lap = 2.0 * c[r] * u(t, x, y)
        for i in range(1, r + 1):
            lap = lap + c[r + i] * (u(t, x - i, y) + u(t, x + i, y)
                                    + u(t, x, y - i) + u(t, x, y + i))
        u(t + 1, x, y).EQUALS(
            2.0 * u(t, x, y) - u(t - 1, x, y) + c2(x, y) * lap)


@register_solution
class SWE2dStencil(yc_solution_base):
    """'swe2d': conservative shallow-water equations (h, hu, hv) with
    Lax–Friedrichs numerical fluxes computed into scratch vars."""

    def __init__(self, name: str = "swe2d"):
        super().__init__(name)

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        h = self.new_var("h", [t, x, y])     # water depth
        hu = self.new_var("hu", [t, x, y])   # x-momentum
        hv = self.new_var("hv", [t, x, y])   # y-momentum
        # dt/dx ratio and gravity baked into coefficient vars
        lam = self.new_var("lam", [])        # dt/dx
        grav = self.new_var("grav", [])      # g

        # Physical fluxes per cell, in scratch vars (computed over the
        # domain + write-halo, consumed at ±1 → exercises scratch chains).
        f_h = self.new_scratch_var("f_h", [x, y])    # = hu
        f_hu = self.new_scratch_var("f_hu", [x, y])  # = hu²/h + g h²/2
        f_hv = self.new_scratch_var("f_hv", [x, y])  # = hu·hv/h
        g_h = self.new_scratch_var("g_h", [x, y])    # = hv
        g_hu = self.new_scratch_var("g_hu", [x, y])  # = hu·hv/h
        g_hv = self.new_scratch_var("g_hv", [x, y])  # = hv²/h + g h²/2

        from yask_tpu_torch.compiler.expr import max_fn
        H = h(t, x, y)
        U = hu(t, x, y)
        V = hv(t, x, y)
        g_ = grav()
        # Guarded depth: ghost cells outside the domain hold h = 0 and
        # would otherwise produce 0/0 in the momentum fluxes; the floor
        # makes boundary fluxes vanish smoothly (open-boundary behavior).
        Hs = max_fn(H, 1.0e-3)
        f_h(x, y).EQUALS(U)
        f_hu(x, y).EQUALS(U * U / Hs + 0.5 * g_ * H * H)
        f_hv(x, y).EQUALS(U * V / Hs)
        g_h(x, y).EQUALS(V)
        g_hu(x, y).EQUALS(U * V / Hs)
        g_hv(x, y).EQUALS(V * V / Hs + 0.5 * g_ * H * H)

        l = lam()

        def lxf(q, fx, gy):
            """Lax–Friedrichs update: average of neighbors minus flux
            differences (the standard conservative LxF form)."""
            avg = 0.25 * (q(t, x - 1, y) + q(t, x + 1, y)
                          + q(t, x, y - 1) + q(t, x, y + 1))
            return (avg
                    - 0.5 * l * (fx(x + 1, y) - fx(x - 1, y))
                    - 0.5 * l * (gy(x, y + 1) - gy(x, y - 1)))

        h(t + 1, x, y).EQUALS(lxf(h, f_h, g_h))
        hu(t + 1, x, y).EQUALS(lxf(hu, f_hu, g_hu))
        hv(t + 1, x, y).EQUALS(lxf(hv, f_hv, g_hv))

        # Reflective walls as sub-domain boundary overrides (the IF_DOMAIN
        # feature the reference's SWE/boundary stencils exercise). The
        # mirror uses the *previous-step* interior neighbor (lagged
        # reflection): same-step mirrors would make boundary equations
        # mutually dependent at var granularity, which the dependency
        # checker rightly rejects as a cycle.
        x0, x1 = self.first_domain_index(x), self.last_domain_index(x)
        y0, y1 = self.first_domain_index(y), self.last_domain_index(y)
        h(t + 1, x, y).EQUALS(h(t, x + 1, y)).IF_DOMAIN(x == x0)
        h(t + 1, x, y).EQUALS(h(t, x - 1, y)).IF_DOMAIN(x == x1)
        hu(t + 1, x, y).EQUALS(-hu(t, x + 1, y)).IF_DOMAIN(x == x0)
        hu(t + 1, x, y).EQUALS(-hu(t, x - 1, y)).IF_DOMAIN(x == x1)
        hv(t + 1, x, y).EQUALS(hv(t, x + 1, y)).IF_DOMAIN(x == x0)
        hv(t + 1, x, y).EQUALS(hv(t, x - 1, y)).IF_DOMAIN(x == x1)
        h(t + 1, x, y).EQUALS(h(t, x, y + 1)).IF_DOMAIN(y == y0)
        h(t + 1, x, y).EQUALS(h(t, x, y - 1)).IF_DOMAIN(y == y1)
        hv(t + 1, x, y).EQUALS(-hv(t, x, y + 1)).IF_DOMAIN(y == y0)
        hv(t + 1, x, y).EQUALS(-hv(t, x, y - 1)).IF_DOMAIN(y == y1)
        hu(t + 1, x, y).EQUALS(hu(t, x, y + 1)).IF_DOMAIN(y == y0)
        hu(t + 1, x, y).EQUALS(hu(t, x, y - 1)).IF_DOMAIN(y == y1)
