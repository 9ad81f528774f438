"""Where the port writes its run-time evidence by default.

The serve journal, the span trace and the breaker sidecar default to one
directory under the package's ``build/`` (which ``.gitignore`` lists), so
a default path never points at a tracked file of the repository.
``YT_TORCH_STATE_DIR`` moves the directory; each file's own variable
(``YT_SERVE_JOURNAL``, ``YT_TRACE_EVENTS``, ``YT_BREAKER_STATE``) moves
that file alone.  Tests and ``chip_smoke.py`` pass temporary paths.
"""

from __future__ import annotations

import os

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def state_dir() -> str:
    """The default directory for run-time evidence files (created on
    first use; ``YT_TORCH_STATE_DIR`` overrides)."""
    d = os.environ.get("YT_TORCH_STATE_DIR") or os.path.join(
        _PKG, "build", "state")
    os.makedirs(d, exist_ok=True)
    return d
