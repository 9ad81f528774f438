"""Per-run mutable state, hoisted out of :class:`StencilContext`.

A copy of ``yask_tpu/runtime/run_state.py``.  A prepared context owns two
kinds of state with different lifetimes:

* the *solution* side — step program, geometry plan, the fused kernel —
  built once by ``prepare_solution`` and valid for any number of runs;
* the *run* side — the var rings (global, or resident per shard between
  shard-mode runs), the step position, and the run/halo timers — one
  instance per live simulation.

This module is the run side.  ``StencilContext`` keeps the attribute
names (``_state``, ``_cur_step``, …) as delegating properties onto the
active :class:`RunState`, so the whole bundle can be swapped under one
prepared solution.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from yask_tpu_torch.utils.timer import YaskTimer


class RunState:
    """One live simulation's mutable state.

    * ``state`` — dict var → ring (list) of padded arrays, oldest→newest;
    * ``state_on_device`` — whether ``state`` holds tensors on the
      context's device (vs host numpy arrays, while the oracle runs);
    * ``resident`` — after a shard-mode run, ``(layout, per-shard
      states)``: the shards' padded rings, which any host-visible access
      gathers back into ``state`` (``StencilContext._materialize_state``);
      ``state`` is None meanwhile;
    * ``cur_step`` — the next step index a ``run_solution`` continues
      from (var element APIs resolve ring slots against it);
    * ``steps_done`` — steps accumulated since the last ``clear_stats``;
    * ``run_timer`` / ``halo_timer`` — elapsed wall-clock accounting
      (kernel builds stay excluded).
    """

    def __init__(self):
        self.state: Optional[Dict[str, List]] = None
        self.state_on_device = False
        self.resident = None
        self.cur_step = 0
        self.steps_done = 0
        self.run_timer = YaskTimer()
        self.halo_timer = YaskTimer()

    def __repr__(self):
        return (f"<RunState step={self.cur_step} "
                f"alloc={self.state is not None or self.resident is not None}>")
