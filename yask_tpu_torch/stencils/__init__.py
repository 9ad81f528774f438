"""Stencil library of the port: importing this package registers its
solutions.  This slice carries ``simple`` (3axis, 9axis, 3plane, cube,
...), ``iso3dfd`` (iso3dfd, iso3dfd_sponge), ``rtm`` (rtm_fwd, rtm_img,
rtm_img_pure, rtm_smooth: the stages of the RTM pipeline) and
``physics2d`` (wave2d, swe2d); the other families of ``yask_tpu.stencils``
are still to port (ROADMAP.md A1)."""

from yask_tpu_torch.stencils import simple  # noqa: F401
from yask_tpu_torch.stencils import iso3dfd  # noqa: F401
from yask_tpu_torch.stencils import rtm  # noqa: F401
from yask_tpu_torch.stencils import physics2d  # noqa: F401
