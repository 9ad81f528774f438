"""Carry solution state between ``yask_tpu`` and the port, as numpy.

The port's padded shapes differ from ``yask_tpu``'s (no Mosaic round-up),
so state crosses as interiors: per var, the list of ring slots
(oldest → newest), each a numpy array of the var's physical axes (misc
axes first, then domain axes) cut to the interior.  ``yask_tpu``'s
contexts hold the same layout, so a caller that reads their interiors
(``np.asarray(ctx._state[name][slot])[interior]``) can hand them here
unchanged — this module itself imports nothing of ``yask_tpu``.  Misc
axes cross at their full extent.

At element size 2 the interiors cross as float32 arrays: export widens
the bfloat16 state exactly, and import rounds to bfloat16, which keeps a
bfloat16 value exactly.  A bfloat16 numpy array of another package is
widened on import through its own ``astype``, so the port needs no
bfloat16 numpy dtype.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from yask_tpu_torch.utils.exceptions import YaskException
from yask_tpu_torch.runtime.var import _to_numpy


def import_interiors(ctx, interiors: Dict[str, List[np.ndarray]]) -> None:
    """Install ``{var: [ring slots as numpy interiors]}`` into a prepared
    context's padded state (pads stay zero, dtype becomes the
    context's)."""
    ctx._check_prepared()
    for name, slots in interiors.items():
        if name not in ctx._state:
            raise YaskException(f"no var '{name}' in '{ctx.get_name()}'")
        ring = ctx._state[name]
        if len(slots) != len(ring):
            raise YaskException(
                f"var '{name}': {len(slots)} slot(s) given, the ring holds "
                f"{len(ring)}")
        shape = ctx._interior_shape(name)
        for s, vals in enumerate(slots):
            vals = np.asarray(vals)
            if vals.dtype.name == "bfloat16":
                vals = vals.astype(np.float32)
            elif not vals.flags.writeable:    # torch wants its own copy
                vals = vals.copy()
            if vals.shape != shape:
                raise YaskException(
                    f"var '{name}' slot {s}: interior shape {vals.shape}, "
                    f"expected {shape}")
            ctx._fill_interior(name, s, vals)


def export_interiors(ctx) -> Dict[str, List[np.ndarray]]:
    """The context's state as ``{var: [ring slots as numpy interiors]}``."""
    ctx._check_prepared()
    return {name: [np.array(_to_numpy(a[ctx._interior_idx(name)]))
                   for a in ring]
            for name, ring in ctx._state.items()}

