"""Request/response types + the ``YT_SERVE_*`` environment knobs.

Counterpart of ``yask_tpu/serve/api.py``, unchanged in behaviour.  A
:class:`ServeRequest` names a session and an inclusive step range — state
lives server-side in the session's RunState, so a request is an "advance
my simulation and hand back the written interiors" verb, the serving
analog of ``run_solution(first_t, last_t)``.  The response carries the
terminal journal state (``ok`` / ``anomaly`` / ``rejected``), the latency
split (queue / run; kernel build seconds are reported separately), the
batch occupancy the request rode, and the requested written-var
interiors as numpy arrays (bit-identical to a solo ``run_solution``).

Env knobs (all optional):

* ``YT_SERVE_WINDOW_MS``  — micro-batching window (default 5 ms; the
  scheduler waits at most this long after the first pending request for
  co-batchable company);
* ``YT_SERVE_MAX_BATCH``  — occupancy cap per batched execution
  (default 16);
* ``YT_SERVE_DEADLINE``   — per-request deadline seconds passed to
  ``guarded_call`` (default 300; SIGALRM only fires on the main thread,
  so the scheduler's worker thread relies on fault classification);
* ``YT_SERVE_JOURNAL``    — journal path override (serve/journal.py);
* ``YT_SERVE_BUCKETING``  — "0" disables shape-bucket co-batching at
  ``open_session`` (default on; see ``serve/buckets.py``);
* ``YT_SERVE_BUCKETS``    — bucket-ladder rung override (buckets.py).

``yask_tpu``'s overload control (brownout tiers, ``Overloaded``) comes
with the fleet and its load harness (ROADMAP.md A13).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

DEFAULT_WINDOW_MS = 5.0
DEFAULT_MAX_BATCH = 16
DEFAULT_DEADLINE_SECS = 300.0


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def serve_window_secs() -> float:
    """The micro-batching window, seconds (``YT_SERVE_WINDOW_MS``)."""
    return max(0.0, _env_float("YT_SERVE_WINDOW_MS",
                               DEFAULT_WINDOW_MS)) / 1000.0


def serve_max_batch() -> int:
    try:
        n = int(os.environ.get("YT_SERVE_MAX_BATCH", "")
                or DEFAULT_MAX_BATCH)
    except ValueError:
        n = DEFAULT_MAX_BATCH
    return max(1, n)


def serve_deadline_secs() -> float:
    return max(0.0, _env_float("YT_SERVE_DEADLINE",
                               DEFAULT_DEADLINE_SECS))


def serve_bucketing_enabled() -> bool:
    """Shape-bucket co-batching default for ``open_session``
    (``YT_SERVE_BUCKETING``; "0"/"off"/"false" disable)."""
    return os.environ.get("YT_SERVE_BUCKETING", "1").strip().lower() \
        not in ("0", "off", "false", "no")


@dataclass
class ServeRequest:
    """One tenant's "advance my session" request.

    ``outputs`` selects which written vars' newest-slot interiors ride
    the response (empty = all written non-scratch vars);
    ``deadline_secs`` 0 means the server default
    (:func:`serve_deadline_secs`)."""
    session: str
    first_step: int
    last_step: Optional[int] = None
    outputs: Tuple[str, ...] = ()
    deadline_secs: float = 0.0
    #: flush cadence, steps: > 0 asks the scheduler to run the range
    #: in chunks of this many steps, emitting a ``stream`` journal /
    #: wire event at every chunk boundary — and makes the run
    #: PREEMPTIBLE between chunks (short requests interleave).
    #: 0 = single guarded execution over the whole range (v1 shape).
    flush_every: int = 0
    #: carry the partial written interiors on each stream event (off
    #: by default — a stream event is a progress beacon, the payload
    #: is opt-in because extraction costs a device sync per chunk).
    stream_outputs: bool = False
    #: upstream trace id (obs.tracer) — threaded through every journal
    #: row and span this request produces.  "" = none (the scheduler
    #: mints one only when YT_TRACE is on).
    trace: str = ""

    def steps(self) -> Tuple[int, int]:
        last = self.first_step if self.last_step is None \
            else self.last_step
        return int(self.first_step), int(last)


@dataclass
class ServeResponse:
    """The released answer for one request (after sanity gating).

    ``status`` is the journal's terminal state: ``ok`` (released),
    ``anomaly`` (ran to completion but the sanity guards quarantined
    the outputs — they still ride the response, flagged, so the tenant
    sees WHAT happened), ``rejected`` (never produced releasable
    output: unknown session, shutdown, or an unrecoverable fault after
    the degradation ladder was exhausted — ``error`` says why)."""
    rid: str = ""
    session: str = ""
    status: str = "rejected"
    error: str = ""
    #: occupancy of the execution this request rode (1 = ran alone;
    #: >1 = micro-batched).
    batch: int = 0
    #: whether the batch ran as one batched program (K7 in fused mode;
    #: torch-mode members run one after another, batched False).
    batched: bool = False
    #: mode that produced the answer + whether the session was walked
    #: down the degradation ladder to get it.
    mode: str = ""
    degraded: bool = False
    queue_secs: float = 0.0
    run_secs: float = 0.0
    compile_secs: float = 0.0
    cache_hit: str = ""
    #: var → newest-slot interior (numpy), per ``ServeRequest.outputs``.
    outputs: Dict = field(default_factory=dict)
    #: sanity verdict details when status == "anomaly".
    anomaly: Dict = field(default_factory=dict)
    #: the session's structured bucketing verdict (BucketDecision
    #: detail dict; empty for pre-bucketing sessions).
    bucket: Dict = field(default_factory=dict)
    #: how many times this request was preempted between flush chunks
    #: (0 = ran to completion in one scheduling turn).
    preempted: int = 0
    #: stream events flushed for this request, oldest first (each:
    #: {"step": ..., "outputs": {...}?}) — the wire front forwards
    #: them as they happen; the response also keeps them.
    streams: List[Dict] = field(default_factory=list)
    #: the trace id this request ran under ("" when untraced) — the
    #: join key against TRACE_EVENTS.jsonl and the journal.
    trace: str = ""

    @property
    def ok(self) -> bool:
        return self.status == "ok"
