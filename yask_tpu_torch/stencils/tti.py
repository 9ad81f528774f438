"""Tilted-transverse-isotropy (TTI) seismic stencil — full formulation.

Counterpart of the reference's largest stencil
(``src/stencils/TTIStencil.cpp:37-62,1944``, the Devito-generated TTI from
the Fletcher–Du–Fowler pseudo-acoustic scheme): two coupled wavefields
``u``/``v`` second-order in time, square-slowness ``m``, boundary damping
``damp``, per-cell dip/azimuth angles ``theta``/``phi``, and Thomsen
parameters ``epsilon``/``delta``.

Where the reference hoists the per-cell trig into precomputed input vars
``ti0..ti3`` and inlines the twice-applied rotated derivative into ~2000
lines of generated expressions, this definition keeps the same computation
*generatively*:

* scratch vars ``ti0..ti3`` hold the per-cell trig (sin/cos of dip and
  azimuth), recomputed by the framework like any scratch stage;
* the rotated first derivative along the symmetry axis
  ``G(f) = sinθ·cosφ·Dx(f) + sinθ·sinφ·Dy(f) + cosθ·Dz(f)``
  is materialized into scratch vars ``gu``/``gv`` and applied twice
  (``Hz = G(G(f))``, reading the scratch with a full halo — the
  scratch-chain-with-halo pattern the reference's generated code walks);
* ``H0 = ∇² − Hz`` (the standard rotated-Laplacian split).

Time update (damped 2nd-order, the reference's ``temp6``/``temp10`` form
with dt = 0.88588, grid spacing h = 20 — derived, not transcribed):

  ``u+·(2m + damp·dt) = (damp·dt − 2m)·u− + 4m·u0
                        + 2dt²·((1+2ε)·H0(u) + √(1+2δ)·Hz(v))``
  ``v+·(2m + damp·dt) = (damp·dt − 2m)·v− + 4m·v0
                        + 2dt²·(√(1+2δ)·H0(u) + Hz(v))``

Supports any radius ≥ 1 (the reference hardcodes spatial order 4 and 8).
"""

from __future__ import annotations

from yask_tpu_torch.utils.fd_coeff import get_center_fd_coefficients
from yask_tpu_torch.compiler.expr import sin, cos, sqrt
from yask_tpu_torch.compiler.solution_base import (
    register_solution,
    yc_solution_with_radius_base,
)

#: Devito-default discretization constants recovered from the reference's
#: generated coefficients (TTIStencil.cpp:289: 1/(0.8858…·damp + 2m);
#: first-derivative weight 2.5e-2 = 1/(2h) ⇒ h = 20).
DT = 0.8858795678228
H = 20.0


@register_solution
class TTIStencil(yc_solution_with_radius_base):
    def __init__(self, name: str = "tti", radius: int = 2):
        super().__init__(name, radius)

    # -- FD building blocks ---------------------------------------------

    def _d1(self, f, pt, dim):
        """Centered first derivative along one axis, order 2r, 1/h."""
        r = self.get_radius()
        c = get_center_fd_coefficients(1, r)
        expr = None
        for i in range(-r, r + 1):
            w = c[r + i] / H
            if w == 0.0:
                continue
            a = dict(pt)
            a[dim] = pt[dim] + i
            term = w * f(*a.values())
            expr = term if expr is None else expr + term
        return expr

    def _d2(self, f, pt, dim):
        """Centered second derivative along one axis, order 2r, 1/h²."""
        r = self.get_radius()
        c = get_center_fd_coefficients(2, r)
        expr = None
        for i in range(-r, r + 1):
            w = c[r + i] / (H * H)
            a = dict(pt)
            a[dim] = pt[dim] + i
            term = w * f(*a.values())
            expr = term if expr is None else expr + term
        return expr

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        z = self.new_domain_index("z")

        u = self.new_var("u", [t, x, y, z])
        v = self.new_var("v", [t, x, y, z])
        m = self.new_var("m", [x, y, z])          # square slowness
        damp = self.new_var("damp", [x, y, z])    # boundary damping
        phi = self.new_var("phi", [x, y, z])      # azimuth
        theta = self.new_var("theta", [x, y, z])  # dip
        dlt = self.new_var("delta", [x, y, z])    # Thomsen δ
        eps = self.new_var("epsilon", [x, y, z])  # Thomsen ε

        # Per-cell trig of the tilt, as scratch temporaries (the
        # reference's hoisted ti0..ti3, TTIStencil.cpp:59-62: ti0=sinθ,
        # ti1=cosφ, ti2=cosθ, ti3=sinφ — recovered from the rotated-
        # derivative pattern ti0·ti1·Dx + ti0·ti3·Dy + ti2·Dz).
        ti0 = self.new_scratch_var("ti0", [x, y, z])
        ti1 = self.new_scratch_var("ti1", [x, y, z])
        ti2 = self.new_scratch_var("ti2", [x, y, z])
        ti3 = self.new_scratch_var("ti3", [x, y, z])
        ti0(x, y, z).EQUALS(sin(theta(x, y, z)))
        ti1(x, y, z).EQUALS(cos(phi(x, y, z)))
        ti2(x, y, z).EQUALS(cos(theta(x, y, z)))
        ti3(x, y, z).EQUALS(sin(phi(x, y, z)))

        pt_t = {"t": t, "x": x, "y": y, "z": z}
        pt = {"x": x, "y": y, "z": z}

        def G_of_field(f):
            """Rotated first derivative of a step var at time t."""
            return (ti0(x, y, z) * ti1(x, y, z) * self._d1(f, pt_t, "x")
                    + ti0(x, y, z) * ti3(x, y, z) * self._d1(f, pt_t, "y")
                    + ti2(x, y, z) * self._d1(f, pt_t, "z"))

        def G_of_scratch(g):
            """Second application: rotated derivative of the scratch
            holding the first application (read with full halo)."""
            return (ti0(x, y, z) * ti1(x, y, z) * self._d1(g, pt, "x")
                    + ti0(x, y, z) * ti3(x, y, z) * self._d1(g, pt, "y")
                    + ti2(x, y, z) * self._d1(g, pt, "z"))

        gu = self.new_scratch_var("gu", [x, y, z])
        gv = self.new_scratch_var("gv", [x, y, z])
        gu(x, y, z).EQUALS(G_of_field(u))
        gv(x, y, z).EQUALS(G_of_field(v))

        def lap(f):
            return (self._d2(f, pt_t, "x") + self._d2(f, pt_t, "y")
                    + self._d2(f, pt_t, "z"))

        hz_u = G_of_scratch(gu)
        hz_v = G_of_scratch(gv)
        h0_u = lap(u) - hz_u

        mm = m(x, y, z)
        dd = damp(x, y, z)
        e = eps(x, y, z)
        sq_d = sqrt(1.0 + 2.0 * dlt(x, y, z))
        inv = 1.0 / (2.0 * mm + dd * DT)
        back = dd * DT - 2.0 * mm
        two_dt2 = 2.0 * DT * DT

        u(t + 1, x, y, z).EQUALS(inv * (
            back * u(t - 1, x, y, z) + 4.0 * mm * u(t, x, y, z)
            + two_dt2 * ((1.0 + 2.0 * e) * h0_u + sq_d * hz_v)))
        v(t + 1, x, y, z).EQUALS(inv * (
            back * v(t - 1, x, y, z) + 4.0 * mm * v(t, x, y, z)
            + two_dt2 * (sq_d * h0_u + hz_v)))
