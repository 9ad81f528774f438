"""Deadlines + retry: ``guarded_call`` and ``deadline``.

Counterpart of ``yask_tpu/resilience/guard.py`` (its killable-subprocess
helpers are not carried).  :func:`deadline` bounds in-process work with a
SIGALRM timer: it interrupts Python-level stalls (injected hangs, polling
loops); a stall inside a CUDA call that never re-enters the interpreter
cannot be preempted this way.

``guarded_call`` composes the whole policy: fault injection at the named
site, the deadline, classification (:func:`~yask_tpu_torch.resilience.
faults.classify`), bounded retry with exponential backoff + jitter for
the retryable kinds, and an optional shared :class:`~yask_tpu_torch.
resilience.faults.Breaker`.
"""

from __future__ import annotations

import random
import signal
import threading
import time
from contextlib import contextmanager
from typing import Optional, Sequence

from yask_tpu_torch.resilience.faults import (Breaker, DeviceHang,
                                              classify, fault_point)

__all__ = ["deadline", "guarded_call"]

#: fault kinds retried by default: the transient ones.  Out-of-memory
#: and build failures are verdicts (retrying re-runs the same doomed
#: build), anomalies are data bugs.
RETRYABLE = ("relay_down", "device_hang")


def _can_alarm() -> bool:
    return (hasattr(signal, "SIGALRM")
            and threading.current_thread() is threading.main_thread())


@contextmanager
def deadline(secs: Optional[float], site: str = "call"):
    """Hard in-process deadline: raises :class:`DeviceHang` when the
    block runs longer than ``secs``.  No-op when ``secs`` is falsy, off
    the main thread, or without SIGALRM (non-Unix)."""
    if not secs or not _can_alarm():
        yield
        return

    def _on_alarm(signum, frame):
        raise DeviceHang(f"deadline of {secs:g}s exceeded at {site}",
                         site=site)

    old_handler = signal.signal(signal.SIGALRM, _on_alarm)
    old_timer = signal.setitimer(signal.ITIMER_REAL, secs)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, *(old_timer or (0.0, 0.0)))
        signal.signal(signal.SIGALRM, old_handler)


def guarded_call(fn, *args, site: str = "call",
                 deadline_secs: Optional[float] = None,
                 retries: int = 0, backoff: float = 0.5,
                 max_backoff: float = 8.0, jitter: float = 0.25,
                 retry_on: Sequence[str] = RETRYABLE,
                 breaker: Optional[Breaker] = None, **kwargs):
    """Run ``fn(*args, **kwargs)`` under the shared fault policy.

    Exceptions are classified into the fault taxonomy; unclassified
    exceptions propagate untouched (a bug in our own code must never
    look like a relay blink).  Classified faults whose kind is in
    ``retry_on`` are retried up to ``retries`` times with exponential
    backoff (+ up to ``jitter`` relative randomization, so a fleet of
    watchers does not re-dial the relay in lockstep); the final fault
    is raised as its taxonomy type with ``.cause`` holding the
    original.  ``breaker`` (when shared across calls) records every
    fault and suppresses further retries once tripped."""
    from yask_tpu_torch.obs.tracer import phase_for_site, span
    attempt = 0
    while True:
        fault = None
        # one span per attempt (named by the fault site, phase derived
        # from it) — retries show as sibling spans, and a classified
        # fault lands in the span's attrs; unclassified exceptions
        # propagate through the span close untouched
        with span(f"guard:{site}", phase=phase_for_site(site),
                  attempt=attempt) as sp:
            try:
                with deadline(deadline_secs, site=site):
                    # inside the deadline: an injected "hang" must be
                    # converted to DeviceHang exactly like a real
                    # stall
                    fault_point(site)
                    out = fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 - classified below
                fault = classify(e, site=site)
                if fault is None:
                    raise
                sp.set(fault=fault.kind)
        if fault is not None:
            tripped = breaker.record(fault) if breaker is not None \
                else False
            if fault.kind in retry_on and attempt < retries \
                    and not tripped:
                delay = min(backoff * (2 ** attempt), max_backoff)
                time.sleep(delay * (1.0 + jitter * random.random()))
                attempt += 1
                continue
            raise fault from (fault.cause or None)
        if breaker is not None:
            breaker.reset()
        return out
