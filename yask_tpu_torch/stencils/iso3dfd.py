"""Isotropic acoustic finite-difference stencils ('iso3dfd').

Counterpart of the reference's historical flagship benchmark
(``src/stencils/Iso3dfdStencil.cpp:210,249``): order-``2*radius`` in space,
order-2 in time acoustic wave propagation —

    p(t+1) = 2·p(t) − p(t−1) + v(x,y,z)·∇²p(t)

with the Laplacian built from center FD coefficients
(``get_center_fd_coefficients``, the same public API the reference stencil
calls), and a sponge variant damping reflections near the boundary.
"""

from __future__ import annotations

from yask_tpu_torch.utils.fd_coeff import get_center_fd_coefficients
from yask_tpu_torch.compiler.solution_base import (
    register_solution,
    yc_solution_with_radius_base,
)


class Iso3dfdBase(yc_solution_with_radius_base):
    def _laplacian(self, p, t, x, y, z):
        """Order-2r Laplacian via 2nd-derivative center FD coefficients."""
        r = self.get_radius()
        c = get_center_fd_coefficients(2, r)  # 2r+1 coeffs, c[r] is center
        expr = 3.0 * c[r] * p(t, x, y, z)
        for i in range(1, r + 1):
            ci = c[r + i]  # symmetric: c[r-i] == c[r+i]
            expr = expr + ci * (p(t, x - i, y, z) + p(t, x + i, y, z)
                                + p(t, x, y - i, z) + p(t, x, y + i, z)
                                + p(t, x, y, z - i) + p(t, x, y, z + i))
        return expr


@register_solution
class Iso3dfdStencil(Iso3dfdBase):
    """'iso3dfd': plain second-order-in-time acoustic update."""

    def __init__(self, name: str = "iso3dfd", radius: int = 8):
        super().__init__(name, radius)

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        z = self.new_domain_index("z")
        p = self.new_var("pressure", [t, x, y, z])
        vel = self.new_var("vel", [x, y, z])

        lap = self._laplacian(p, t, x, y, z)
        p(t + 1, x, y, z).EQUALS(
            2.0 * p(t, x, y, z) - p(t - 1, x, y, z)
            + vel(x, y, z) * lap)


@register_solution
class Iso3dfdSpongeStencil(Iso3dfdBase):
    """'iso3dfd_sponge': the same update multiplied by an absorbing-layer
    coefficient (the reference's sponge variant,
    ``Iso3dfdStencil.cpp:249``). The reference supports either 1-D
    per-dim factors or a full 3-D sponge var (``AwpStencil.cpp:34-100``);
    the TPU-native layout is the 3-D form — separable 1-D profiles fold
    into it at init time, and a full-dim coefficient rides the same
    lane-aligned DMA slabs as the field vars instead of forcing a
    pid-dependent lane gather that Mosaic cannot lower."""

    def __init__(self, name: str = "iso3dfd_sponge", radius: int = 8):
        super().__init__(name, radius)

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        z = self.new_domain_index("z")
        p = self.new_var("pressure", [t, x, y, z])
        vel = self.new_var("vel", [x, y, z])
        # Absorbing coefficient (≤1 near boundaries, 1 inside); holds the
        # product of any separable per-dim tapers.
        sp = self.new_var("sponge", [x, y, z])

        lap = self._laplacian(p, t, x, y, z)
        nxt = (2.0 * p(t, x, y, z) - p(t - 1, x, y, z)
               + vel(x, y, z) * lap)
        p(t + 1, x, y, z).EQUALS(nxt * sp(x, y, z))
