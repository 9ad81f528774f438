"""Device-resident multi-step serving.

Counterpart of ``yask_tpu/serve/resident.py``.  The BatchScheduler pays
per-REQUEST dispatch by design: every request takes the queue lock, waits
the batching window, extracts a rollback snapshot, runs, then copies its
outputs to the host before the next request touches the device.  That is
pure overhead for the bulk pattern: ONE caller holding a work list of
(session, steps) items that only needs every answer at the end.

:class:`ResidentExecutor` keeps state on the device across the whole
queue: items are dispatched back-to-back under one device-lock hold — no
batching window, no per-item snapshot, no per-item host copy — then ONE
``torch.cuda.synchronize`` on each touched context's device retires the
queue and each touched session's outputs are extracted once.  Responses
are bit-identical to per-request dispatch by construction: the executor
calls the same ``run_solution`` on the same per-session RunStates.

:meth:`BatchScheduler.run_resident` delegates here under the SAME device
lock, so resident queues serialize against in-flight request traffic.
Fault surface: the queue entry is a ``fault_point("serve.resident")``,
every item's run rides ``guarded_call`` at the same site, and extracted
outputs pass ``maybe_corrupt("serve.resident")``.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Tuple

from yask_tpu_torch.utils.exceptions import YaskException

#: one work item: (session id, first step, last step)
WorkItem = Tuple[str, int, int]


class ResidentExecutor:
    """Drain a queue of (session, first, last) work items with
    device-resident state and a single end-of-queue sync.

    ``dev_lock`` is the scheduler's ``_dev_lock`` when attached to a
    live server (all context/state access serializes with request
    traffic); standalone use may pass None for a private lock.
    """

    def __init__(self, registry, journal=None, dev_lock=None):
        import threading
        self._registry = registry
        self._journal = journal
        self._dev_lock = dev_lock or threading.RLock()
        self._next_qid = 0

    # ------------------------------------------------------------------

    def _record(self, qid: str, sid: str, event: str, **detail) -> None:
        if self._journal is not None:
            self._journal.record(qid, sid, event, **detail)

    def run_queue(self, items: Sequence[WorkItem],
                  outputs: Sequence[str] = (),
                  deadline_secs: Optional[float] = None) -> Dict[str, Dict]:
        """Run every item in order; return {session id: {"outputs":
        {var: interior array}, "items": n, "run_secs": s}} for each
        TOUCHED session, extracted once after the whole queue retired.

        A session appearing in several items accumulates steps in
        program order (exactly what the same requests through the
        scheduler would do serially); its response reflects the final
        state.  Unknown sessions raise before anything runs — a bulk
        queue is one unit of work, not a best-effort sweep.
        """
        from yask_tpu_torch.resilience.faults import fault_point, maybe_corrupt
        from yask_tpu_torch.resilience.guard import guarded_call
        from yask_tpu_torch.serve.scheduler import extract_outputs

        items = list(items)
        sessions = {}
        for sid, _f, _l in items:
            sessions[str(sid)] = self._registry.session(sid)
        qid = f"q{self._next_qid:04d}"
        self._next_qid += 1

        with self._dev_lock:
            fault_point("serve.resident")
            self._record(qid, "*", "resident_queue",
                         items=len(items),
                         sessions=sorted(sessions))
            t0 = time.perf_counter()
            counts: Dict[str, int] = {}
            for sid, first, last in items:
                sess = sessions[str(sid)]
                ctx = sess.ctx
                prev = ctx.set_run_state(sess.run_state)
                try:
                    guarded_call(ctx.run_solution, int(first),
                                 int(last), site="serve.resident",
                                 deadline_secs=deadline_secs)
                finally:
                    ctx.set_run_state(prev)
                counts[str(sid)] = counts.get(str(sid), 0) + 1
            # the ONE synchronization point for the whole queue: the
            # devices of every touched session retire together (guarded,
            # so a classified device fault surfaces at this site)
            for dev in {sess.ctx.get_device() for sess in sessions.values()}:
                if dev is not None and dev.type == "cuda":
                    import torch
                    guarded_call(torch.cuda.synchronize, dev,
                                 site="serve.resident",
                                 deadline_secs=deadline_secs)
            run_secs = time.perf_counter() - t0

            results: Dict[str, Dict] = {}
            for sid, sess in sessions.items():
                ctx = sess.ctx
                prev = ctx.set_run_state(sess.run_state)
                try:
                    outs = extract_outputs(ctx, tuple(outputs),
                                           sub_sizes=sess.sub_sizes)
                finally:
                    ctx.set_run_state(prev)
                outs = maybe_corrupt("serve.resident", outs)
                results[sid] = {"outputs": outs,
                                "items": counts.get(sid, 0),
                                "run_secs": run_secs}
                self._record(qid, sid, "resident_done",
                             items=counts.get(sid, 0),
                             run_secs=round(run_secs, 6),
                             outputs=sorted(outs))
            return results


def run_per_request(scheduler, items: Sequence[WorkItem],
                    outputs: Sequence[str] = (),
                    timeout: Optional[float] = None) -> Dict[str, Dict]:
    """The per-request-dispatch baseline: the SAME work list pushed
    through ``scheduler.request`` one item at a time (queue + window +
    snapshot + per-item extraction each).  Returns the final response
    per session in the resident result shape, so the two compare like
    with like."""
    from yask_tpu_torch.serve.api import ServeRequest
    results: Dict[str, Dict] = {}
    counts: Dict[str, int] = {}
    for sid, first, last in items:
        resp = scheduler.request(
            ServeRequest(session=str(sid), first_step=int(first),
                         last_step=int(last), outputs=tuple(outputs)),
            timeout=timeout)
        if resp.status not in ("ok", "degraded"):
            raise YaskException(
                f"per-request arm failed on {sid} [{first},{last}]: "
                f"{resp.status}: {resp.error}")
        counts[str(sid)] = counts.get(str(sid), 0) + 1
        results[str(sid)] = {"outputs": resp.outputs,
                             "items": counts[str(sid)],
                             "run_secs": resp.run_secs}
    return results
