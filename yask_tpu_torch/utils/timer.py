"""Wall-clock timers for runtime stats.

Counterpart of ``YaskTimer`` (reference ``src/common/common_utils.hpp``):
start/stop accumulation with nesting guard, used by the runtime for per-phase
accounting (run/halo/compile time — ``context.hpp:318-328``).
"""

from __future__ import annotations

import time


class YaskTimer:
    __slots__ = ("_elapsed", "_start", "_running")

    def __init__(self):
        self._elapsed = 0.0
        self._start = 0.0
        self._running = False

    def clear(self) -> None:
        self._elapsed = 0.0
        self._running = False

    def start(self) -> None:
        if self._running:
            return
        self._start = time.perf_counter()
        self._running = True

    def stop(self) -> float:
        if self._running:
            self._elapsed += time.perf_counter() - self._start
            self._running = False
        return self._elapsed

    def get_elapsed_secs(self) -> float:
        if self._running:
            return self._elapsed + (time.perf_counter() - self._start)
        return self._elapsed

    def __enter__(self) -> "YaskTimer":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.stop()
