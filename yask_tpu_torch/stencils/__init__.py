"""Stencil library of the port: importing this package registers its
solutions.  This slice carries ``simple`` (3axis, 9axis, 3plane, cube,
...) and ``iso3dfd`` (iso3dfd, iso3dfd_sponge); the other families of
``yask_tpu.stencils`` are still to port (ROADMAP.md A1)."""

from yask_tpu_torch.stencils import simple  # noqa: F401
from yask_tpu_torch.stencils import iso3dfd  # noqa: F401
