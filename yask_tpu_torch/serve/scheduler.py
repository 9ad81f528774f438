"""The request queue + dynamic micro-batching scheduler.

Counterpart of ``yask_tpu/serve/scheduler.py``.  ONE worker thread owns
all device work (tenant threads only enqueue and wait on events), so
run-state swaps on the shared prepared contexts are serialized by
construction.  The loop:

1. take the oldest pending request; wait up to the batching window
   (``YT_SERVE_WINDOW_MS``) for co-batchable company;
2. group requests with the same **batch key** — (profile, session mode,
   ``ctx._fused_variant_key()``, step range) — one request per session,
   up to ``YT_SERVE_MAX_BATCH``, and only when
   :func:`~yask_tpu_torch.runtime.ensemble.ensemble_feasible` says the
   mode batches.  Bucketed sessions share a bucket-rung profile, so
   tenants on DIFFERENT logical domains carry the same key;
3. execute: occupancy > 1 — or ANY bucketed member — runs as ONE
   :class:`~yask_tpu_torch.runtime.ensemble.EnsembleRun` over the
   sessions' own RunStates (in ``fused`` mode one K7 launch per step for
   all of them); occupancy 1 is a ``run_solution`` under the session's
   state.  Both under ``guarded_call`` at the ``serve.run`` fault site.
   A request with ``flush_every > 0`` runs in chunks: a ``stream`` event
   flushes at every chunk boundary (``serve.flush`` site, non-fatal), and
   between chunks the batch YIELDS to any waiting request (``preempted``;
   the continuation re-queues before any same-session pending request);
4. on a classified fault: roll each affected session back to its last
   committed chunk boundary (``extract_snapshot`` before each chunk) and
   walk it down the mode-degradation ladder (``fused`` → ``torch``) over
   the REMAINING steps — a degraded answer, journaled ``degraded``.
   Bucket-hosted sessions never degrade, and neither does a session on
   the card: its fault rejects the request with the fault's kind, so no
   card answer ever comes from the plain version.  A shared breaker bounds
   runaway ladder walks.  An unclassified error (a kernel launch that
   fails, say) rejects the request;
5. release: written interiors (the tenant's SUB-domain for bucketed
   sessions) pass ``maybe_corrupt("serve.respond")`` + the result-sanity
   guards; a failed verdict releases the response flagged ``anomaly``.

Every lifecycle edge is journaled (schema ``yask_tpu.serve/1``).
``guarded_call``'s SIGALRM deadline only arms on the main thread, so on
this worker the deadline relies on fault classification.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from yask_tpu_torch.obs import tracer as obs
from yask_tpu_torch.obs.metrics import Registry
from yask_tpu_torch.runtime.var import _to_numpy
from yask_tpu_torch.serve.api import (ServeRequest, ServeResponse,
                                      serve_deadline_secs, serve_max_batch,
                                      serve_window_secs)
from yask_tpu_torch.serve.journal import ServeJournal
from yask_tpu_torch.serve.registry import Session, SessionRegistry
from yask_tpu_torch.utils.exceptions import YaskException

#: bound on retained latency samples (metrics percentiles).
MAX_SAMPLES = 4096


def extract_outputs(ctx, names: Tuple[str, ...] = (),
                    sub_sizes: Optional[Dict[str, int]] = None) -> Dict:
    """Newest-slot written interiors of the ACTIVE run state, by
    interior coordinates (the same geometry walk as the watchdog scan
    and ``compare_data``) — the response payload, and the oracle-side
    extraction the bit-identity tests compare against.  ``sub_sizes``
    restricts the domain slices to a bucketed tenant's low-corner
    sub-domain, so the payload is shaped exactly like the solo run's."""
    ctx._check_prepared()
    ctx._materialize_state()
    gsz = ctx._opts.global_domain_sizes
    out = {}
    for name, g in ctx._program.geoms.items():
        if names:
            if name not in names:
                continue
        elif not g.is_written or g.is_scratch:
            continue
        idx = tuple(
            slice(g.origin[dn], g.origin[dn]
                  + (int(sub_sizes.get(dn, gsz[dn]))
                     if sub_sizes else gsz[dn]))
            if kind == "domain" else slice(None)
            for dn, kind in g.axes)
        out[name] = np.array(_to_numpy(ctx._state[name][-1][idx]))
    missing = set(names) - set(out)
    if missing:
        raise YaskException(
            f"requested output var(s) {sorted(missing)} not in the "
            f"solution ({sorted(ctx._program.geoms)})")
    return out


class _Pending:
    """One queued request plus its rendezvous with the worker.  The
    mutable accumulators survive preemption rounds (a preempted
    request re-enters the queue as its own continuation)."""

    __slots__ = ("req", "rid", "t_received", "t_wall", "done",
                 "response", "run_secs", "compile_secs", "cache_hit",
                 "preempts", "streams", "on_stream", "trace")

    def __init__(self, req: ServeRequest, rid: str):
        self.req = req
        self.rid = rid
        self.t_received = time.perf_counter()
        self.t_wall = time.time()
        # ONE trace id per request lifecycle: the request's own id
        # wins, else an ambient activation, else mint one when tracing
        # is on.  "" = untraced.
        self.trace = (req.trace or obs.current_trace_id()
                      or (obs.new_trace_id() if obs.trace_enabled()
                          else ""))
        self.done = threading.Event()
        self.response: Optional[ServeResponse] = None
        self.run_secs = 0.0
        self.compile_secs = 0.0
        self.cache_hit = ""
        self.preempts = 0
        self.streams: List[Dict] = []
        #: optional callable(event_dict) — a push hook invoked on the
        #: worker thread at each flush.
        self.on_stream = None

    def finish(self, resp: ServeResponse) -> None:
        self.response = resp
        self.done.set()


class BatchScheduler:
    def __init__(self, registry: SessionRegistry,
                 journal: Optional[ServeJournal] = None,
                 window_secs: Optional[float] = None,
                 max_batch: Optional[int] = None,
                 obs_registry: Optional[Registry] = None):
        from yask_tpu_torch.resilience.faults import Breaker
        self._registry = registry
        self._journal = journal or ServeJournal()
        self._obs = obs_registry or Registry()
        self._window = serve_window_secs() if window_secs is None \
            else max(0.0, float(window_secs))
        self._max_batch = serve_max_batch() if max_batch is None \
            else max(1, int(max_batch))
        self._pending: List[_Pending] = []
        self._cond = threading.Condition()
        self._breaker = Breaker()
        # LOG-ONLY SLO monitor (None unless a YT_SLO_* knob is set —
        # the unconfigured path must cost nothing and write nothing)
        from yask_tpu_torch.obs.slo import SloMonitor
        self._slo = SloMonitor.from_env()
        self._shutdown = False
        self._next_rid = 0
        self._samples: List[Dict] = []
        self._lock = threading.RLock()      # metrics/samples
        self._dev_lock = threading.RLock()  # all context/state access
        self._worker = threading.Thread(target=self._loop,
                                        name="yt-serve-worker",
                                        daemon=True)
        self._worker.start()

    # ------------------------------------------------------------ API

    def submit(self, req: ServeRequest, on_stream=None) -> _Pending:
        """Enqueue; returns the pending handle (wait on
        ``handle.done`` or use :meth:`wait`).  ``on_stream`` is an
        optional callable(event_dict) fired on the worker thread at
        every flush (attached HERE, not after submit, so the first
        chunk's flush cannot race it)."""
        with self._cond:
            rid = f"r{self._next_rid:06d}"
            self._next_rid += 1
            p = _Pending(req, rid)
            p.on_stream = on_stream
            self._journal.record(rid, req.session, "received",
                                 trace_id=p.trace,
                                 first=req.steps()[0],
                                 last=req.steps()[1])
            if self._shutdown:
                p.finish(self._reject(p, "server is shut down"))
                return p
            try:
                self._registry.session(req.session)
            except YaskException as e:
                p.finish(self._reject(p, str(e)))
                return p
            self._pending.append(p)
            self._cond.notify_all()
            return p

    def wait(self, p: _Pending,
             timeout: Optional[float] = None) -> ServeResponse:
        if not p.done.wait(timeout):
            raise YaskException(
                f"request {p.rid} still in flight after {timeout}s")
        return p.response

    def request(self, req: ServeRequest,
                timeout: Optional[float] = None) -> ServeResponse:
        return self.wait(self.submit(req), timeout)

    def queue_depth(self) -> int:
        with self._cond:
            return len(self._pending)

    def samples(self) -> List[Dict]:
        with self._lock:
            return list(self._samples)

    def session_ctx(self, sid: str):
        """Contextmanager: the session's prepared context with ITS
        run state active, under the device lock — the safe window for
        var fills / reads from any tenant thread."""
        from contextlib import contextmanager
        sess = self._registry.session(sid)

        @contextmanager
        def _swap():
            with self._dev_lock:
                ctx = sess.ctx
                prev = ctx.set_run_state(sess.run_state)
                try:
                    yield ctx
                finally:
                    ctx.set_run_state(prev)
        return _swap()

    def run_resident(self, items, outputs=(), deadline_secs=None):
        """Opt-in bulk path: drain a work list of (session, first,
        last) items through the device-resident executor
        (:mod:`yask_tpu_torch.serve.resident`) under THIS scheduler's
        device lock and journal — one sync for the whole queue instead of
        per-request dispatch.  Serializes against in-flight request
        traffic (the one-worker-owns-the-device invariant holds);
        returns {session: {"outputs": ..., "items": n, "run_secs": s}}.
        """
        from yask_tpu_torch.serve.resident import ResidentExecutor
        with self._lock:
            ex = getattr(self, "_resident", None)
            if ex is None:
                ex = self._resident = ResidentExecutor(
                    self._registry, journal=self._journal,
                    dev_lock=self._dev_lock)
        return ex.run_queue(items, outputs=outputs,
                            deadline_secs=deadline_secs)

    def shutdown(self, timeout: float = 10.0) -> None:
        with self._cond:
            self._shutdown = True
            for p in self._pending:
                p.finish(self._reject(p, "server is shut down"))
            self._pending.clear()
            self._cond.notify_all()
        self._worker.join(timeout)

    # ---------------------------------------------------------- worker

    def _loop(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._shutdown:
                    self._cond.wait()
                if self._shutdown and not self._pending:
                    return
                head = self._pending[0]
            # bounded batching window: wait for co-batchable company
            if self._window > 0:
                deadline = head.t_received + self._window
                while True:
                    now = time.perf_counter()
                    if now >= deadline:
                        break
                    with self._cond:
                        if len(self._pending) >= self._max_batch \
                                or self._shutdown:
                            break
                        self._cond.wait(timeout=deadline - now)
            batch = self._collect(head)
            if not batch:
                continue
            try:
                self._execute(batch)
            except Exception as e:  # noqa: BLE001 - the worker must
                # survive anything: a scheduler bug rejects the batch,
                # it must never kill the serving loop for other tenants
                for p in batch:
                    if not p.done.is_set():
                        p.finish(self._reject(
                            p, f"{type(e).__name__}: {e}"))

    def _batch_key(self, p: _Pending) -> Optional[Tuple]:
        try:
            sess = self._registry.session(p.req.session)
        except YaskException:
            return None
        first, last = p.req.steps()
        # bucketed sessions share a bucket-rung profile, so
        # profile.key here IS the bucket key: tenants at different
        # logical domains on the same rung carry equal keys and group
        return (sess.profile.key, sess.mode,
                sess.profile.variant_key(sess.mode), first, last)

    def _collect(self, head: _Pending) -> List[_Pending]:
        """Pop the head plus every co-batchable pending request (same
        batch key, distinct sessions, feasible mode) up to the
        occupancy cap."""
        from yask_tpu_torch.runtime.ensemble import ensemble_feasible
        with self._cond:
            self._expire_queued()
            if head not in self._pending:
                return []
            key = self._batch_key(head)
            if key is None:
                self._pending.remove(head)
                head.finish(self._reject(
                    head, f"unknown serve session {head.req.session!r}"))
                return []
            sess = self._registry.session(head.req.session)
            can_batch, _why = ensemble_feasible(sess.ctx)
            batch = [head]
            seen = {head.req.session}
            if can_batch:
                for p in self._pending:
                    if p is head or len(batch) >= self._max_batch:
                        continue
                    if p.req.session in seen:
                        continue  # same tenant: state-dependent, next round
                    if self._batch_key(p) == key:
                        batch.append(p)
                        seen.add(p.req.session)
            for p in batch:
                self._pending.remove(p)
            return batch

    def _expire_queued(self, now: Optional[float] = None) -> None:
        """Fast-fail every pending request whose deadline elapsed while
        still QUEUED — before the worker touches the device for it.
        The deadline used to bound only device work; a request that
        waited its whole budget in ``_pending`` burned it just as
        surely, and running it anyway wastes a device turn on an
        answer the tenant has already given up on.  Caller holds
        ``self._cond``."""
        now = time.perf_counter() if now is None else float(now)
        for p in list(self._pending):
            ddl = p.req.deadline_secs or serve_deadline_secs()
            if ddl <= 0 or now - p.t_received <= ddl:
                continue
            self._pending.remove(p)
            self._obs.counter(
                "serve.overload.deadline_in_queue").inc()
            p.finish(self._reject(
                p, f"deadline {ddl:g}s expired after "
                   f"{now - p.t_received:.3f}s in queue (request "
                   "never reached the device)",
                reason="deadline_in_queue"))

    # --------------------------------------------------------- execute

    def _reject(self, p: _Pending, why: str,
                reason: str = "") -> ServeResponse:
        detail = {"error": why[:200]}
        if reason:
            detail["reason"] = reason
        self._journal.record(p.rid, p.req.session, "rejected",
                             trace_id=p.trace, **detail)
        self._obs.counter("serve.requests.rejected").inc()
        self._slo_feed(p, p.req.session, ok=False)
        return ServeResponse(rid=p.rid, session=p.req.session,
                             status="rejected", error=why,
                             trace=p.trace)

    def _slo_feed(self, p: _Pending, sid: str, *, ok: bool,
                  quarantined: bool = False,
                  total_ms: Optional[float] = None,
                  occupancy: Optional[float] = None) -> None:
        """Feed the SLO monitor one released/rejected request and
        journal any NEW breach as an ``slo_breach`` row (schema
        ``yask_tpu.slo/1``) joined to the worst offender's trace id.
        LOG-ONLY by contract: breaches print and journal; nothing is
        blocked, and a monitor bug must never break serving."""
        if self._slo is None:
            return
        try:
            self._slo.record(ok=ok, quarantined=quarantined,
                             preempted=bool(p.preempts),
                             total_ms=total_ms, occupancy=occupancy,
                             trace=p.trace)
            for br in self._slo.evaluate():
                self._journal.record(
                    p.rid, sid, "slo_breach",
                    trace_id=br.get("trace") or p.trace,
                    slo_v=br["v"], signal=br["signal"],
                    budget=br["budget"], threshold=br["threshold"],
                    windows=br["windows"])
                # stderr: stdout may carry a caller's own protocol
                print(f"[serve] SLO breach: {br['signal']} burning "
                      f"past {br['threshold']}x budget {br['budget']} "
                      f"in all windows (trace "
                      f"{br.get('trace') or p.trace or '-'}) "
                      "— LOG-ONLY, serving continues",
                      file=sys.stderr)
        except Exception:  # noqa: BLE001 - observability must never
            pass           # take down the serving loop

    def _execute(self, batch: List[_Pending]) -> None:
        """One scheduling turn for a collected batch: journal the
        batching decision, then run the step range — whole when no
        member streams, chunked at the smallest requested flush
        cadence otherwise, yielding to waiting requests between
        chunks."""
        sessions = [self._registry.session(p.req.session)
                    for p in batch]
        first, last = batch[0].req.steps()
        n = len(batch)
        for p, sess in zip(batch, sessions):
            detail = {"batch": n, "first": first, "last": last,
                      "mode": sess.mode,
                      "window_ms": round(self._window * 1000.0, 3)}
            if sess.bucket is not None:
                # the structured bucketing verdict rides every
                # batched row: bucketed / exact / declined-why
                detail["bucket"] = sess.bucket.as_detail()
            if p.req.flush_every > 0:
                detail["flush_every"] = int(p.req.flush_every)
            self._journal.record(p.rid, p.req.session, "batched",
                                 trace_id=p.trace, **detail)
        cadences = [int(p.req.flush_every) for p in batch
                    if p.req.flush_every > 0]
        span = abs(last - first) + 1
        cadence = min(cadences) if cadences else 0
        if cadence <= 0 or cadence >= span:
            self._execute_chunk(batch, sessions, first, last,
                                final=True)
            return
        dirn = 1 if last >= first else -1
        a = first
        while True:
            b = a + dirn * (cadence - 1)
            if (dirn > 0 and b >= last) or (dirn < 0 and b <= last):
                b = last
            final = b == last
            if not self._execute_chunk(batch, sessions, a, b,
                                       final=final):
                return  # terminal (released, recovered, or rejected)
            self._flush_batch(batch, sessions, b)
            if self._maybe_preempt(batch, b + dirn, last):
                return  # continuation re-queued
            a = b + dirn

    def _execute_chunk(self, batch: List[_Pending],
                       sessions: List[Session], first: int, last: int,
                       *, final: bool) -> bool:
        """Run one guarded chunk [first, last] for the batch.  Returns
        True when the caller should continue with the next chunk;
        False when every request reached a terminal state here."""
        from yask_tpu_torch.resilience.checkpoint import extract_snapshot
        from yask_tpu_torch.resilience.faults import Fault, fault_point
        from yask_tpu_torch.resilience.guard import guarded_call
        from yask_tpu_torch.runtime.ensemble import EnsembleRun

        ddl = min((p.req.deadline_secs or serve_deadline_secs())
                  for p in batch) or None
        n = len(batch)
        masked = any(s.sub_sizes for s in sessions)
        t_start = time.perf_counter()

        with self._dev_lock:
            ctx = sessions[0].ctx
            compile0 = ctx._compile_secs
            # rollback targets: the last committed chunk boundary
            # (pre-request when nothing has run yet), host copies of
            # every ring slot of every member
            snaps = {}
            with obs.activate(batch[0].trace), \
                    obs.span("serve.snapshot", phase="checkpoint",
                             batch=n, first=first, last=last):
                for sess in sessions:
                    prev = ctx.set_run_state(sess.run_state)
                    try:
                        snaps[sess.sid] = extract_snapshot(ctx)
                    finally:
                        ctx.set_run_state(prev)

            batched = False
            fault: Optional[Fault] = None
            # the head's trace id scopes the batch span (a batch can
            # mix traces; journal rows carry each member's own id) —
            # activation also stamps any journal rows
            # the run produces underneath.
            try:
                with obs.activate(batch[0].trace), \
                        obs.span("serve.chunk", phase="compute",
                                 batch=n, first=first, last=last,
                                 mode=sessions[0].mode,
                                 rids=[p.rid for p in batch]):
                    # the batching decision's injection site: a
                    # classified fault here takes the same degrade
                    # path as serve.run
                    fault_point("serve.batch")
                    if n > 1 or masked:
                        # bucketed members run masked even at
                        # occupancy 1: a sub-domain session's state is
                        # only correct under the per-step sub-domain
                        # mask.  A fused batch is one K7 launch per
                        # step; a failed build or launch raises out of
                        # ens.run (never a quiet sequential rerun)
                        ens = EnsembleRun(
                            ctx,
                            members=[s.run_state for s in sessions],
                            sub_domains=([s.sub_sizes
                                          for s in sessions]
                                         if masked else None))
                        guarded_call(ens.run, first, last,
                                     site="serve.run",
                                     deadline_secs=ddl)
                        batched = ens.batched_reason == "" and n > 1
                    else:
                        prev = ctx.set_run_state(
                            sessions[0].run_state)
                        try:
                            guarded_call(ctx.run_solution, first,
                                         last, site="serve.run",
                                         deadline_secs=ddl)
                        finally:
                            ctx.set_run_state(prev)
            except Fault as f:
                fault = f
            except YaskException as e:
                for p in batch:
                    p.finish(self._reject(p, str(e)))
                return False
            chunk_secs = time.perf_counter() - t_start
            compile_secs = ctx._compile_secs - compile0
            cache_hit = ctx._last_cache_hit or "cold"
            for p in batch:
                p.run_secs += chunk_secs
                p.compile_secs += compile_secs
                p.cache_hit = cache_hit

            if fault is not None:
                tripped = self._breaker.record(fault)
                for p, sess in zip(batch, sessions):
                    self._journal.record(
                        p.rid, sess.sid, "fault", trace_id=p.trace,
                        kind=fault.kind,
                        site=getattr(fault, "site", "serve.run"),
                        mode=sess.mode, batch=n,
                        breaker_tripped=bool(tripped))
                for p, sess in zip(batch, sessions):
                    p.finish(self._recover(p, sess, snaps[sess.sid],
                                           fault, tripped, first,
                                           last=batch[0].req.steps()[1]))
                return False

        if final:
            now = time.perf_counter()
            for p, sess in zip(batch, sessions):
                p.finish(self._release(
                    p, sess, batch=n, batched=batched,
                    queue_secs=max(0.0, now - p.t_received
                                   - p.run_secs),
                    run_secs=p.run_secs,
                    compile_secs=p.compile_secs,
                    cache_hit=p.cache_hit))
            return False
        return True

    # ------------------------------------------------ stream / preempt

    def _flush_batch(self, batch: List[_Pending],
                     sessions: List[Session], step_done: int) -> None:
        """Emit a ``stream`` event for every streaming member at a
        chunk boundary.  Flushes are guarded at the ``serve.flush``
        site but NON-fatal: a classified fault skips this beacon and
        the run continues — a tenant's answer must never be lost to
        evidence I/O (the journal's own policy, applied to streams)."""
        from yask_tpu_torch.resilience.faults import Fault
        from yask_tpu_torch.resilience.guard import guarded_call
        for p, sess in zip(batch, sessions):
            if p.req.flush_every <= 0:
                continue
            try:
                guarded_call(self._flush_one, p, sess, step_done,
                             site="serve.flush")
            except Fault as f:
                self._journal.record(p.rid, sess.sid, "fault",
                                     trace_id=p.trace,
                                     kind=f.kind, site="serve.flush",
                                     nonfatal=True)

    def _flush_one(self, p: _Pending, sess: Session,
                   step_done: int) -> None:
        from yask_tpu_torch.resilience.faults import fault_point
        fault_point("serve.flush")
        ev: Dict = {"step": int(step_done)}
        if p.req.stream_outputs:
            with self._dev_lock:
                ctx = sess.ctx
                prev = ctx.set_run_state(sess.run_state)
                try:
                    ev["outputs"] = extract_outputs(
                        ctx, tuple(p.req.outputs),
                        sub_sizes=sess.sub_sizes)
                finally:
                    ctx.set_run_state(prev)
        self._journal.record(p.rid, sess.sid, "stream",
                             trace_id=p.trace,
                             step=int(step_done),
                             chunk=len(p.streams),
                             outputs=sorted(ev.get("outputs", ())))
        p.streams.append(ev)
        cb = p.on_stream
        if cb is not None:
            cb(ev)

    def _maybe_preempt(self, batch: List[_Pending], next_first: int,
                       last: int) -> bool:
        """Between chunks: if anyone is waiting, yield — re-queue the
        whole batch as its own continuation (same co-batch on the
        next turn: all members share the updated step range, hence
        the batch key).  The continuation is inserted BEFORE any
        pending request of the same session, so per-session FIFO
        ordering is preserved; with no same-session pending it goes
        to the tail, behind the requests it yielded to."""
        from yask_tpu_torch.resilience.faults import fault_point
        with self._cond:
            if self._shutdown or not self._pending:
                return False
            fault_point("serve.batch")
            for p in batch:
                p.req.first_step = int(next_first)
                p.req.last_step = int(last)
                p.preempts += 1
                self._journal.record(p.rid, p.req.session, "preempted",
                                     trace_id=p.trace,
                                     resume_at=int(next_first),
                                     last=int(last))
            sids = {p.req.session for p in batch}
            pos = len(self._pending)
            for idx, q in enumerate(self._pending):
                if q.req.session in sids:
                    pos = idx
                    break
            self._pending[pos:pos] = batch
            self._cond.notify_all()
            return True

    # --------------------------------------------------------- recover

    def _recover(self, p: _Pending, sess: Session, snap: Dict,
                 fault, tripped: bool, first: int,
                 last: int) -> ServeResponse:
        """Walk the session down the mode-degradation ladder from its
        last committed snapshot, over the REMAINING step range; the
        tenant gets a degraded-mode answer unless the ladder (or the
        breaker) is exhausted."""
        if tripped:
            return self._reject(
                p, f"{fault.kind} at serve.run and the breaker is "
                   "tripped (repeated faults) — not degrading")
        if sess.sub_sizes:
            # masked sub-domain runs are a torch-only contract, and a
            # ladder rung's geometry would not be the bucket's —
            # bucket-hosted sessions reject instead of degrading
            return self._reject(
                p, f"{fault.kind} at serve.run on a bucket-hosted "
                   "session (masked sub-domain runs do not degrade)")
        ddl = p.req.deadline_secs or serve_deadline_secs()
        last_err: Exception = fault
        t0 = time.perf_counter()
        with obs.activate(p.trace):
            return self._recover_laddered(
                p, sess, snap, fault, first, last, ddl, last_err, t0)

    def _recover_laddered(self, p: _Pending, sess: Session, snap: Dict,
                          fault, first: int, last: int, ddl, last_err,
                          t0: float) -> ServeResponse:
        from yask_tpu_torch.resilience.checkpoint import (apply_snapshot,
                                                    degradation_ladder)
        from yask_tpu_torch.resilience.faults import Fault
        from yask_tpu_torch.resilience.guard import guarded_call
        for to_mode in degradation_ladder(
                sess.mode, on_card=sess.ctx.is_offloaded()):
            try:
                ctx2 = sess.profile.ctx_for(to_mode)
            except Exception as e:  # noqa: BLE001 - rung unbuildable,
                last_err = e        # try the next one
                continue
            rs2 = ctx2.new_run_state()
            prev = ctx2.set_run_state(rs2)
            try:
                if not apply_snapshot(ctx2, snap):
                    last_err = YaskException(
                        f"snapshot restore into mode {to_mode} failed")
                    continue
                compile0 = ctx2._compile_secs
                guarded_call(ctx2.run_solution, first, last,
                             site="serve.run", deadline_secs=ddl)
            except Fault as f2:
                self._journal.record(p.rid, sess.sid, "fault",
                                     trace_id=p.trace,
                                     kind=f2.kind, mode=to_mode)
                if self._breaker.record(f2):
                    last_err = f2
                    break
                last_err = f2
                continue
            finally:
                ctx2.set_run_state(prev)
            sess.mode = to_mode
            sess.run_state = rs2
            sess.degrade_path.append(to_mode)
            self._breaker.reset()
            self._journal.record(p.rid, sess.sid, "degraded",
                                 trace_id=p.trace,
                                 to_mode=to_mode, kind=fault.kind,
                                 ladder_path=list(sess.degrade_path))
            return self._release(
                p, sess, batch=1, batched=False,
                queue_secs=t0 - p.t_received,
                run_secs=time.perf_counter() - t0,
                compile_secs=ctx2._compile_secs - compile0,
                cache_hit=ctx2._last_cache_hit or "cold")
        return self._reject(
            p, f"{fault.kind} at serve.run and the degradation ladder "
               f"is exhausted ({type(last_err).__name__}: {last_err})")

    # --------------------------------------------------------- release

    def _release(self, p: _Pending, sess: Session, *, batch: int,
                 batched: bool, queue_secs: float, run_secs: float,
                 compile_secs: float, cache_hit: str) -> ServeResponse:
        """Sanity-gate the written interiors, journal the terminal
        state, record the latency sample, build the response."""
        from yask_tpu_torch.resilience.faults import maybe_corrupt
        from yask_tpu_torch.resilience.sanity import anomaly_fields, check_output
        resp = ServeResponse(
            rid=p.rid, session=sess.sid, batch=batch, batched=batched,
            mode=sess.mode, degraded=sess.degraded,
            queue_secs=queue_secs, run_secs=run_secs,
            compile_secs=compile_secs, cache_hit=cache_hit,
            bucket=(sess.bucket.as_detail()
                    if sess.bucket is not None else {}),
            preempted=p.preempts, streams=list(p.streams),
            trace=p.trace)
        # the queue-wait interval as a retroactive span: the phase
        # breakdown must separate waiting from running
        obs.record_span("serve.queue_wait", "queue", p.t_wall,
                        queue_secs, trace=p.trace, rid=p.rid,
                        session=sess.sid)
        try:
            with self._dev_lock:
                ctx = sess.ctx
                prev = ctx.set_run_state(sess.run_state)
                try:
                    outs = extract_outputs(ctx, tuple(p.req.outputs),
                                           sub_sizes=sess.sub_sizes)
                finally:
                    ctx.set_run_state(prev)
        except YaskException as e:
            return self._reject(p, str(e))
        outs = maybe_corrupt("serve.respond", outs)
        verdict = check_output(outs)
        resp.outputs = outs
        if verdict["ok"]:
            resp.status = "ok"
            self._journal.record(p.rid, sess.sid, "ok", batch=batch,
                                 trace_id=p.trace,
                                 batched=batched, mode=sess.mode,
                                 degraded=sess.degraded,
                                 preempted=p.preempts)
        else:
            # quarantined release: the tenant sees the data AND the
            # verdict; the journal never banks it clean
            resp.status = "anomaly"
            resp.anomaly = anomaly_fields(verdict)["anomaly"]
            self._journal.record(p.rid, sess.sid, "anomaly",
                                 trace_id=p.trace,
                                 batch=batch, mode=sess.mode,
                                 anomalies=verdict["anomalies"])
        with self._lock:
            self._samples.append({
                "status": resp.status, "batch": batch,
                "batched": batched, "mode": sess.mode,
                "degraded": sess.degraded,
                "bucketed": bool(sess.sub_sizes),
                "preempted": p.preempts, "trace": p.trace,
                "queue_secs": queue_secs, "run_secs": run_secs,
                "compile_secs": compile_secs, "cache_hit": cache_hit})
            if len(self._samples) > MAX_SAMPLES:
                del self._samples[:len(self._samples) - MAX_SAMPLES]
        reg = self._obs
        reg.counter(f"serve.requests.{resp.status}").inc()
        reg.counter(f"serve.cache.{cache_hit}").inc()
        if sess.degraded:
            reg.counter("serve.degraded").inc()
        if p.preempts:
            reg.counter("serve.preempted").inc()
        reg.histogram("serve.queue_ms").observe(queue_secs * 1e3)
        reg.histogram("serve.run_ms").observe(run_secs * 1e3)
        reg.histogram("serve.total_ms").observe(
            (queue_secs + run_secs) * 1e3)
        reg.histogram("serve.batch_occupancy").observe(batch)
        reg.gauge("serve.queue_depth").set(self.queue_depth())
        self._slo_feed(p, sess.sid, ok=(resp.status == "ok"),
                       quarantined=(resp.status == "anomaly"),
                       total_ms=(queue_secs + run_secs) * 1e3,
                       occupancy=batch)
        return resp
