"""Stencil library of the port: importing this package registers its
solutions, every family of ``yask_tpu.stencils`` with the same names and
equations: ``simple`` (3axis, 9axis, 3plane, cube, ...), ``iso3dfd``
(iso3dfd, iso3dfd_sponge), ``elastic`` (ssg, fsg), ``awp`` (awp, awp_abc,
awp_elastic, awp_elastic_abc), ``tti``, ``physics2d`` (wave2d, swe2d),
``filters`` (box, gaussian), ``rtm`` (rtm_fwd, rtm_img, rtm_img_pure,
rtm_smooth: the stages of the RTM pipeline) and ``test_stencils`` (the
reference's test_* cases)."""

from yask_tpu_torch.stencils import simple  # noqa: F401
from yask_tpu_torch.stencils import iso3dfd  # noqa: F401
from yask_tpu_torch.stencils import elastic  # noqa: F401
from yask_tpu_torch.stencils import awp  # noqa: F401
from yask_tpu_torch.stencils import tti  # noqa: F401
from yask_tpu_torch.stencils import physics2d  # noqa: F401
from yask_tpu_torch.stencils import filters  # noqa: F401
from yask_tpu_torch.stencils import rtm  # noqa: F401
from yask_tpu_torch.stencils import test_stencils  # noqa: F401
