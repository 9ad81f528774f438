"""Staggered-grid elastic wave stencils ('ssg', 'fsg').

Counterpart of the reference's elastic families
(``src/stencils/SSGElasticStencil.cpp:195``, ``FSGElasticStencil.cpp:562``,
shared bases in ``ElasticStencil/*.hpp``): velocity–stress formulation on a
staggered grid, two stages per step (stress reads the velocities updated in
the same step — the same-step dependency that forces stage ordering), with
density interpolation at staggered positions.

Derivative weights at half-grid points come from
``get_arbitrary_fd_coefficients`` (Fornberg at x0=0 with samples at
±(k−½)) — the generic form of the reference's hard-coded 9/8, −1/24
staggered coefficients (recovered exactly at radius 2).
"""

from __future__ import annotations

from yask_tpu_torch.utils.fd_coeff import get_arbitrary_fd_coefficients
from yask_tpu_torch.compiler.solution_base import (
    register_solution,
    yc_solution_with_radius_base,
)


class ElasticBase(yc_solution_with_radius_base):
    """Shared helpers (reference ``ElasticStencilBase``)."""

    def _stag_coeffs(self):
        r = self.get_radius()
        pts = [i + 0.5 for i in range(-r, r)]
        return get_arbitrary_fd_coefficients(1, 0.0, pts)

    def _dstag(self, v, t, idxs, dim_pos, shift):
        """Staggered first derivative of var access ``v(t, *idxs)`` along
        the ``dim_pos``-th domain index; ``shift``∈{0,1} selects the
        half-point side (forward-staggered when 1)."""
        c = self._stag_coeffs()
        r = self.get_radius()
        expr = None
        for k in range(2 * r):
            off = k - r + shift  # samples at ±(k-1/2) relative to target
            args = list(idxs)
            args[dim_pos] = args[dim_pos] + off
            term = c[k] * v(t, *args)
            expr = term if expr is None else expr + term
        return expr

    def _avg2(self, m, idxs, dim_pos):
        a = list(idxs)
        a[dim_pos] = a[dim_pos] + 1
        return 0.5 * (m(*idxs) + m(*a))


@register_solution
class SSGElasticStencil(ElasticBase):
    """'ssg': standard staggered-grid isotropic elastic (velocity + 6
    stresses, Lamé parameters λ, μ and density ρ)."""

    def __init__(self, name: str = "ssg", radius: int = 2):
        super().__init__(name, radius)

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        z = self.new_domain_index("z")
        d = (x, y, z)

        v = {c: self.new_var(f"v_{c}", [t, x, y, z]) for c in "xyz"}
        s = {c: self.new_var(f"s_{c}", [t, x, y, z])
             for c in ("xx", "yy", "zz", "xy", "xz", "yz")}
        rho = self.new_var("rho", [x, y, z])
        lam = self.new_var("lambda_", [x, y, z])
        mu = self.new_var("mu", [x, y, z])
        # Time step × grid spacing ratio baked to 1 like the reference
        # (delta_t/h handled by the user scaling the material vars).

        ax = {"x": 0, "y": 1, "z": 2}

        # Stage 1: velocity update v(t+1) = v(t) + (1/ρ̄)·div σ(t).
        # Each velocity component lives at a different staggered position;
        # density is interpolated there (reference interp helpers).
        for c in "xyz":
            i = ax[c]
            buoy = 1.0 / self._avg2(rho, d, i)
            names = {"x": ("xx", "xy", "xz"),
                     "y": ("xy", "yy", "yz"),
                     "z": ("xz", "yz", "zz")}[c]
            div = self._dstag(s[names[0]], t, d, 0, 1 if c == "x" else 0)
            div = div + self._dstag(s[names[1]], t, d, 1,
                                    1 if c == "y" else 0)
            div = div + self._dstag(s[names[2]], t, d, 2,
                                    1 if c == "z" else 0)
            v[c](t + 1, x, y, z).EQUALS(v[c](t, x, y, z) + buoy * div)

        # Stage 2: stress update from strain rates of v(t+1).
        dvv = {}
        for c in "xyz":
            for j in "xyz":
                # derivative of v_c along axis j at the stress position.
                shift = 0 if c == j else 1
                dvv[(c, j)] = self._dstag(v[c], t + 1, d, ax[j], shift)

        tr = dvv[("x", "x")] + dvv[("y", "y")] + dvv[("z", "z")]
        for c in "xyz":
            cc = c + c
            s[cc](t + 1, x, y, z).EQUALS(
                s[cc](t, x, y, z) + lam(x, y, z) * tr
                + 2.0 * mu(x, y, z) * dvv[(c, c)])
        for a, b in (("x", "y"), ("x", "z"), ("y", "z")):
            nm = a + b
            mu_i = self._avg2(mu, d, ax[a])
            s[nm](t + 1, x, y, z).EQUALS(
                s[nm](t, x, y, z)
                + mu_i * (dvv[(a, b)] + dvv[(b, a)]))


@register_solution
class SSG2ElasticStencil(SSGElasticStencil):
    """'ssg2': the reference's v2-base variant of the SSG solution
    (``SSGElastic2Stencil.cpp:160``); same physics, registered separately
    so command lines using either name work."""

    def __init__(self):
        super().__init__("ssg2", radius=2)


@register_solution
class SSGMergedElasticStencil(SSGElasticStencil):
    """'ssg_merged': the merged-equation variant
    (``SSGElastic2Stencil.cpp:169``). On TPU the distinction is moot —
    XLA fuses either form into the same kernels — so this registers the
    same equations under the merged name for CLI parity."""

    def __init__(self):
        super().__init__("ssg_merged", radius=2)


@register_solution
class FSGElasticStencil(ElasticBase):
    """'fsg': fully-staggered anisotropic elastic with an orthorhombic
    stiffness tensor (c11…c66 material vars), the structural analog of the
    reference's FSG family (``FSGElasticStencil.cpp``)."""

    def __init__(self, name: str = "fsg", radius: int = 2):
        super().__init__(name, radius)

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        z = self.new_domain_index("z")
        d = (x, y, z)
        ax = {"x": 0, "y": 1, "z": 2}

        v = {c: self.new_var(f"v_{c}", [t, x, y, z]) for c in "xyz"}
        s = {c: self.new_var(f"s_{c}", [t, x, y, z])
             for c in ("xx", "yy", "zz", "xy", "xz", "yz")}
        rho = self.new_var("rho", [x, y, z])
        C = {nm: self.new_var(f"c{nm}", [x, y, z])
             for nm in ("11", "12", "13", "22", "23", "33",
                        "44", "55", "66")}

        for c in "xyz":
            i = ax[c]
            buoy = 1.0 / self._avg2(rho, d, i)
            names = {"x": ("xx", "xy", "xz"),
                     "y": ("xy", "yy", "yz"),
                     "z": ("xz", "yz", "zz")}[c]
            div = self._dstag(s[names[0]], t, d, 0, 1 if c == "x" else 0)
            div = div + self._dstag(s[names[1]], t, d, 1,
                                    1 if c == "y" else 0)
            div = div + self._dstag(s[names[2]], t, d, 2,
                                    1 if c == "z" else 0)
            v[c](t + 1, x, y, z).EQUALS(v[c](t, x, y, z) + buoy * div)

        e = {}
        for c in "xyz":
            for j in "xyz":
                shift = 0 if c == j else 1
                e[(c, j)] = self._dstag(v[c], t + 1, d, ax[j], shift)

        exx, eyy, ezz = e[("x", "x")], e[("y", "y")], e[("z", "z")]
        s["xx"](t + 1, x, y, z).EQUALS(
            s["xx"](t, x, y, z) + C["11"](x, y, z) * exx
            + C["12"](x, y, z) * eyy + C["13"](x, y, z) * ezz)
        s["yy"](t + 1, x, y, z).EQUALS(
            s["yy"](t, x, y, z) + C["12"](x, y, z) * exx
            + C["22"](x, y, z) * eyy + C["23"](x, y, z) * ezz)
        s["zz"](t + 1, x, y, z).EQUALS(
            s["zz"](t, x, y, z) + C["13"](x, y, z) * exx
            + C["23"](x, y, z) * eyy + C["33"](x, y, z) * ezz)
        s["yz"](t + 1, x, y, z).EQUALS(
            s["yz"](t, x, y, z)
            + C["44"](x, y, z) * (e[("y", "z")] + e[("z", "y")]))
        s["xz"](t + 1, x, y, z).EQUALS(
            s["xz"](t, x, y, z)
            + C["55"](x, y, z) * (e[("x", "z")] + e[("z", "x")]))
        s["xy"](t + 1, x, y, z).EQUALS(
            s["xy"](t, x, y, z)
            + C["66"](x, y, z) * (e[("x", "y")] + e[("y", "x")]))


@register_solution
class FSG2ElasticStencil(FSGElasticStencil):
    """'fsg2': v2-base variant name of the FSG solution
    (``FSGElastic2Stencil.cpp:502``)."""

    def __init__(self):
        super().__init__("fsg2", radius=2)


@register_solution
class FSGElasticABCStencil(ElasticBase):
    """'fsg_abc': FSG with an absorbing-boundary damping coefficient (3-D
    sponge var, the reference's ``AwpStencil.cpp:34-100`` alternative
    form; separable per-dim tapers fold into it at init — the TPU-native
    layout, since a full-dim coefficient rides lane-aligned DMA slabs)."""

    def __init__(self, name: str = "fsg_abc", radius: int = 2):
        super().__init__(name, radius)

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        z = self.new_domain_index("z")
        d = (x, y, z)
        ax = {"x": 0, "y": 1, "z": 2}

        v = {c: self.new_var(f"v_{c}", [t, x, y, z]) for c in "xyz"}
        s = {c: self.new_var(f"s_{c}", [t, x, y, z])
             for c in ("xx", "yy", "zz", "xy", "xz", "yz")}
        rho = self.new_var("rho", [x, y, z])
        C = {nm: self.new_var(f"c{nm}", [x, y, z])
             for nm in ("11", "12", "13", "22", "23", "33",
                        "44", "55", "66")}
        sp = self.new_var("sponge", [x, y, z])

        def damp(expr):
            return expr * sp(x, y, z)

        for c in "xyz":
            i = ax[c]
            buoy = 1.0 / self._avg2(rho, d, i)
            names = {"x": ("xx", "xy", "xz"),
                     "y": ("xy", "yy", "yz"),
                     "z": ("xz", "yz", "zz")}[c]
            div = self._dstag(s[names[0]], t, d, 0, 1 if c == "x" else 0)
            div = div + self._dstag(s[names[1]], t, d, 1,
                                    1 if c == "y" else 0)
            div = div + self._dstag(s[names[2]], t, d, 2,
                                    1 if c == "z" else 0)
            v[c](t + 1, x, y, z).EQUALS(
                damp(v[c](t, x, y, z) + buoy * div))

        e = {}
        for c in "xyz":
            for j in "xyz":
                shift = 0 if c == j else 1
                e[(c, j)] = self._dstag(v[c], t + 1, d, ax[j], shift)

        exx, eyy, ezz = e[("x", "x")], e[("y", "y")], e[("z", "z")]
        s["xx"](t + 1, x, y, z).EQUALS(
            s["xx"](t, x, y, z) + C["11"](x, y, z) * exx
            + C["12"](x, y, z) * eyy + C["13"](x, y, z) * ezz)
        s["yy"](t + 1, x, y, z).EQUALS(
            s["yy"](t, x, y, z) + C["12"](x, y, z) * exx
            + C["22"](x, y, z) * eyy + C["23"](x, y, z) * ezz)
        s["zz"](t + 1, x, y, z).EQUALS(
            s["zz"](t, x, y, z) + C["13"](x, y, z) * exx
            + C["23"](x, y, z) * eyy + C["33"](x, y, z) * ezz)
        s["yz"](t + 1, x, y, z).EQUALS(
            s["yz"](t, x, y, z)
            + C["44"](x, y, z) * (e[("y", "z")] + e[("z", "y")]))
        s["xz"](t + 1, x, y, z).EQUALS(
            s["xz"](t, x, y, z)
            + C["55"](x, y, z) * (e[("x", "z")] + e[("z", "x")]))
        s["xy"](t + 1, x, y, z).EQUALS(
            s["xy"](t, x, y, z)
            + C["66"](x, y, z) * (e[("x", "y")] + e[("y", "x")]))


@register_solution
class FSG2ElasticABCStencil(FSGElasticABCStencil):
    """'fsg2_abc': v2-base name of the FSG ABC variant."""

    def __init__(self):
        super().__init__("fsg2_abc", radius=2)


@register_solution
class FSGMergedElasticStencil(FSG2ElasticStencil):
    """Back-compat alias of fsg2 (reference ``FSGElasticMStencil``,
    ``FSGElastic2Stencil.cpp:510``)."""

    def __init__(self):
        super().__init__()
        self._soln._name = "fsg_merged"


@register_solution
class FSGMergedABCElasticStencil(FSG2ElasticABCStencil):
    """Back-compat alias of fsg2_abc (reference ``FSGABCElasticMStencil``,
    ``FSGElastic2Stencil.cpp:517``)."""

    def __init__(self):
        super().__init__()
        self._soln._name = "fsg_merged_abc"
