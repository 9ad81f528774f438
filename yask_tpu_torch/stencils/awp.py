"""AWP-ODC seismic stencils ('awp', 'awp_abc', 'awp_elastic', 'awp_elastic_abc').

Counterpart of the reference's AWP family (``src/stencils/AwpStencil.cpp:
627-876``): staggered velocity–stress seismic propagation with

* Cerjan sponge damping via a 3-D sponge var (the reference supports a
  3-D sponge var or 1-D factors, ``AwpStencil.cpp:34-100`` — the 3-D form
  is the TPU-native layout: separable tapers fold into it at init, and a
  full-dim coefficient rides lane-aligned DMA slabs),
* free-surface boundary equations at the top of the domain expressed as
  ``IF_DOMAIN`` sub-domain conditions (the feature the reference's AWP
  exercises hardest),
* an anelastic ('awp') vs purely elastic ('awp_elastic') stress update —
  the anelastic form adds memory-variable relaxation.
"""

from __future__ import annotations

from yask_tpu_torch.utils.fd_coeff import get_arbitrary_fd_coefficients
from yask_tpu_torch.compiler.solution_base import (
    register_solution,
    yc_solution_base,
)


class AwpBase(yc_solution_base):
    """Shared AWP machinery: staggered 4th-order derivatives + sponge."""

    _ABC = False      # apply Cerjan sponge factors
    _ANELASTIC = True  # include memory-variable relaxation

    def _c(self):
        # 4th-order staggered weights at half points (9/8, -1/24 pattern).
        return get_arbitrary_fd_coefficients(
            1, 0.0, [-1.5, -0.5, 0.5, 1.5])

    def _d(self, var, t, idxs, dim_pos, shift):
        c = self._c()
        expr = None
        for k in range(4):
            off = k - 2 + shift
            args = list(idxs)
            args[dim_pos] = args[dim_pos] + off
            term = c[k] * var(t, *args)
            expr = term if expr is None else expr + term
        return expr

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        z = self.new_domain_index("z")
        d = (x, y, z)
        ax = {"x": 0, "y": 1, "z": 2}

        v = {c: self.new_var(f"vel_{c}", [t, x, y, z]) for c in "xyz"}
        s = {c: self.new_var(f"stress_{c}", [t, x, y, z])
             for c in ("xx", "yy", "zz", "xy", "xz", "yz")}
        rho = self.new_var("rho", [x, y, z])
        lam = self.new_var("lambda_", [x, y, z])
        mu = self.new_var("mu", [x, y, z])
        h = self.new_var("h", [])  # (dt/h) scalar-like var, no domain dims

        if self._ABC:
            sp = self.new_var("sponge", [x, y, z])

            def damp(e):
                return e * sp(x, y, z)
        else:
            def damp(e):
                return e

        if self._ANELASTIC:
            # Memory variables for anelastic attenuation (one per normal
            # stress), relaxed toward the elastic strain each step.
            r_v = {c: self.new_var(f"mem_{c}", [t, x, y, z])
                   for c in ("xx", "yy", "zz")}
            qp = self.new_var("qp", [x, y, z])   # attenuation factor

        dth = h()

        # --- stage 1: velocities -------------------------------------
        for c in "xyz":
            i = ax[c]
            names = {"x": ("xx", "xy", "xz"),
                     "y": ("xy", "yy", "yz"),
                     "z": ("xz", "yz", "zz")}[c]
            div = self._d(s[names[0]], t, d, 0, 1 if c == "x" else 0)
            div = div + self._d(s[names[1]], t, d, 1, 1 if c == "y" else 0)
            div = div + self._d(s[names[2]], t, d, 2, 1 if c == "z" else 0)
            upd = v[c](t, x, y, z) + dth / rho(x, y, z) * div
            v[c](t + 1, x, y, z).EQUALS(damp(upd))

        # --- stage 2: stresses ---------------------------------------
        e = {}
        for c in "xyz":
            for j in "xyz":
                shift = 0 if c == j else 1
                e[(c, j)] = self._d(v[c], t + 1, d, ax[j], shift)
        tr = e[("x", "x")] + e[("y", "y")] + e[("z", "z")]

        # Free-surface boundary at the top z planes (reference free-surface
        # eqs, AwpStencil.cpp:627-876): stresses involving z vanish on the
        # surface; bulk updates apply on the disjoint interior sub-domain.
        last_z = self.last_domain_index(z)

        for c in "xyz":
            cc = c + c
            el = (lam(x, y, z) * tr + 2.0 * mu(x, y, z) * e[(c, c)])
            if self._ANELASTIC:
                # Memory-variable relaxation: r(t+1) = q·(r(t) + el),
                # stress gains (el − r(t+1)) — a standard coarse-grained
                # attenuation form.
                r_v[cc](t + 1, x, y, z).EQUALS(
                    qp(x, y, z) * (r_v[cc](t, x, y, z) + el))
                el = el - r_v[cc](t + 1, x, y, z)
            upd = s[cc](t, x, y, z) + dth * el
            if cc == "zz":
                s[cc](t + 1, x, y, z).EQUALS(damp(upd)) \
                    .IF_DOMAIN(z < last_z)
                s[cc](t + 1, x, y, z).EQUALS(0.0).IF_DOMAIN(z == last_z)
            else:
                s[cc](t + 1, x, y, z).EQUALS(damp(upd))

        for a, b in (("x", "y"), ("x", "z"), ("y", "z")):
            nm = a + b
            upd = (s[nm](t, x, y, z)
                   + dth * mu(x, y, z) * (e[(a, b)] + e[(b, a)]))
            if "z" in nm:
                s[nm](t + 1, x, y, z).EQUALS(damp(upd)) \
                    .IF_DOMAIN(z < last_z - 1)
                s[nm](t + 1, x, y, z).EQUALS(0.0) \
                    .IF_DOMAIN(z >= last_z - 1)
            else:
                s[nm](t + 1, x, y, z).EQUALS(damp(upd))


@register_solution
class AwpStencil(AwpBase):
    _ABC = False
    _ANELASTIC = True

    def __init__(self):
        super().__init__("awp")


@register_solution
class AwpAbcStencil(AwpBase):
    _ABC = True
    _ANELASTIC = True

    def __init__(self):
        super().__init__("awp_abc")


@register_solution
class AwpElasticStencil(AwpBase):
    _ABC = False
    _ANELASTIC = False

    def __init__(self):
        super().__init__("awp_elastic")


@register_solution
class AwpElasticAbcStencil(AwpBase):
    _ABC = True
    _ANELASTIC = False

    def __init__(self):
        super().__init__("awp_elastic_abc")
