"""RTM-like pipeline stages (forward → imaging condition → smoothing).

The port's copy of ``yask_tpu/stencils/rtm.py`` (imports rewritten; the
equations are the same node for node, so both packages analyze them
alike).  The yask reference has no cross-solution composition at all — each
``REGISTER_SOLUTION`` stencil is a closed world.  Real RTM/FWI drivers
(ROADMAP items 2 and 4) chain several solutions per time step: a
forward wavefield propagator, an imaging-condition correlation that
accumulates ``p²`` (the zero-lag autocorrelation proxy used when the
receiver wavefield is the same shot), and a spatial smoothing filter
over the image.  These three stages are the headline chain for
``yask_tpu_torch.ops.pipeline`` — each is an ordinary registered solution
runnable standalone, and the consumer stages declare their upstream
input as a *step-free read-only var* (``fwd_in`` / ``img_in``) that a
:class:`~yask_tpu_torch.ops.pipeline.SolutionPipeline` binding replaces with
the producer's freshly-written field.

Stage shapes (all share ordered domain dims ``x, y, z`` and step ``t``):

* ``rtm_fwd``    — iso3dfd-style order-2r acoustic update (default
  radius 2 keeps the fused chain's margins small); per-stage read
  width r.
* ``rtm_img``    — pointwise ``img += fwd_in²``; read width 0.
* ``rtm_smooth`` — 3-point (radius-1) box average of ``img_in`` per
  dim; read width 1.

Fused analysis of the merged chain therefore has 3 stages with
per-stage widths ``(r, 0, 1)`` and ``fused_step_radius == r + 1``.
"""

from __future__ import annotations

from yask_tpu_torch.utils.fd_coeff import get_center_fd_coefficients
from yask_tpu_torch.compiler.solution_base import (
    register_solution,
    yc_solution_base,
    yc_solution_with_radius_base,
)


@register_solution
class RtmForwardStencil(yc_solution_with_radius_base):
    """'rtm_fwd': acoustic forward propagator (iso3dfd form, small
    default radius — the pipeline flagship wants cheap margins)."""

    def __init__(self, name: str = "rtm_fwd", radius: int = 2):
        super().__init__(name, radius)

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        z = self.new_domain_index("z")
        p = self.new_var("pressure", [t, x, y, z])
        vel = self.new_var("vel", [x, y, z])

        r = self.get_radius()
        c = get_center_fd_coefficients(2, r)  # 2r+1 coeffs, c[r] center
        lap = 3.0 * c[r] * p(t, x, y, z)
        for i in range(1, r + 1):
            ci = c[r + i]
            lap = lap + ci * (p(t, x - i, y, z) + p(t, x + i, y, z)
                              + p(t, x, y - i, z) + p(t, x, y + i, z)
                              + p(t, x, y, z - i) + p(t, x, y, z + i))
        p(t + 1, x, y, z).EQUALS(
            2.0 * p(t, x, y, z) - p(t - 1, x, y, z)
            + vel(x, y, z) * lap)


@register_solution
class RtmImagingStencil(yc_solution_base):
    """'rtm_img': zero-lag imaging condition — accumulate the squared
    source wavefield into the image.  ``fwd_in`` has no step dim: it is
    the pipeline input slot a binding rewires to the producer's
    ``pressure``; standalone it is just a constant field."""

    def __init__(self, name: str = "rtm_img"):
        super().__init__(name)

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        z = self.new_domain_index("z")
        img = self.new_var("img", [t, x, y, z])
        fwd = self.new_var("fwd_in", [x, y, z])

        img(t + 1, x, y, z).EQUALS(
            img(t, x, y, z) + fwd(x, y, z) * fwd(x, y, z))


@register_solution
class RtmImagingPureStencil(yc_solution_base):
    """'rtm_img_pure': NON-accumulating imaging condition — the image
    is the squared source wavefield of the current shot step, with no
    ``img(t)`` self-read.  This is the push-memory flagship variant:
    in the merged chain every read of ``img__img`` is the smoothing
    stage's ``+1`` read, so the fused kernel can PUSH the image tile
    straight into the smoother and skip its HBM round-trip entirely
    (the accumulating ``rtm_img`` ring-reads itself and must keep its
    HBM state).  Physically this is the per-shot correlation before
    stacking — drivers that stack host-side use exactly this form."""

    def __init__(self, name: str = "rtm_img_pure"):
        super().__init__(name)

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        z = self.new_domain_index("z")
        img = self.new_var("img", [t, x, y, z])
        fwd = self.new_var("fwd_in", [x, y, z])

        img(t + 1, x, y, z).EQUALS(fwd(x, y, z) * fwd(x, y, z))


@register_solution
class RtmSmoothStencil(yc_solution_base):
    """'rtm_smooth': 3-point box average of the image per dim (the
    post-imaging low-pass every RTM driver applies).  ``img_in`` is the
    pipeline input slot for the imaging stage's ``img``."""

    def __init__(self, name: str = "rtm_smooth"):
        super().__init__(name)

    def define(self):
        t = self.new_step_index("t")
        x = self.new_domain_index("x")
        y = self.new_domain_index("y")
        z = self.new_domain_index("z")
        sm = self.new_var("smooth", [t, x, y, z])
        img = self.new_var("img_in", [x, y, z])

        expr = None
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for dz in (-1, 0, 1):
                    term = img(x + dx, y + dy, z + dz)
                    expr = term if expr is None else expr + term
        sm(t + 1, x, y, z).EQUALS(expr / 27.0)
