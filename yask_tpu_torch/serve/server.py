"""The in-process server: registry + scheduler + metrics under one
facade.

Counterpart of ``yask_tpu/serve/server.py``.  Lifecycle::

    srv = StencilServer(env, journal_path=path)  # owns the worker thread
    sid = srv.open_session(stencil="iso3dfd", radius=8, g=256,
                           mode="fused", wf=2)   # prepares ONCE per
                                                 # profile; later tenants
                                                 # share it
    srv.set_var(sid, "vel", 0.5)                 # state lives server-side
    srv.set_var_slice(sid, "pressure", arr, first, last)
    resp = srv.request(ServeRequest(session=sid, first_step=0,
                                    last_step=3))
    srv.metrics()
    srv.shutdown()

Requests on sessions of one profile, mode and step range are batched
into one :class:`~yask_tpu_torch.runtime.ensemble.EnsembleRun`; in
``fused`` mode that is one K7 launch per step for every member.

What ``yask_tpu``'s server has and this one does not yet: the checker's
serve pass (``preflight=True`` raises), the perflab ledger rows
(``flush_metrics`` raises) and the fleet telemetry unit
(``metrics_snapshot`` raises), each naming its ROADMAP.md item.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from yask_tpu_torch.obs.metrics import Registry, percentile as _pctl
from yask_tpu_torch.serve.api import ServeRequest, ServeResponse
from yask_tpu_torch.serve.journal import ServeJournal
from yask_tpu_torch.serve.registry import SessionRegistry
from yask_tpu_torch.serve.scheduler import BatchScheduler
from yask_tpu_torch.utils.exceptions import YaskException


class StencilServer:
    def __init__(self, env=None, factory=None,
                 journal_path: Optional[str] = None,
                 window_secs: Optional[float] = None,
                 max_batch: Optional[int] = None,
                 preflight: bool = False):
        from yask_tpu_torch import yk_factory
        if preflight:
            raise YaskException(
                "the serve preflight (the checker's serve pass) is not "
                "ported yet: ROADMAP.md A14 (observability, perflab and "
                "checker); open the server with preflight=False")
        self._factory = factory or yk_factory()
        self._env = env if env is not None else self._factory.new_env()
        self.journal = ServeJournal(journal_path)
        # journal growth control: compact past YT_JOURNAL_MAX_MB before
        # appending more (between servers is the safe window)
        self.journal.compact_if_large()
        self.registry = SessionRegistry(self._factory, self._env)
        #: per-server metrics registry (obs.metrics) — the scheduler
        #: feeds it per release; ``metrics()["registry"]`` exports it.
        self.obs = Registry()
        self.scheduler = BatchScheduler(self.registry, self.journal,
                                        window_secs=window_secs,
                                        max_batch=max_batch,
                                        obs_registry=self.obs)

    # ------------------------------------------------------- sessions

    def open_session(self, stencil: str, radius: Optional[int] = None,
                     g=16, mode: str = "torch", wf: int = 2,
                     options: str = "",
                     session: Optional[str] = None,
                     bucket: Optional[bool] = None) -> str:
        """Open a tenant session.  ``bucket`` controls shape-bucket
        co-batching: None = the ``YT_SERVE_BUCKETING`` default (on),
        False = host exactly at ``g``, True = request bucketing.  A
        bucketed session is hosted on a profile at the next bucket-
        ladder rung >= g and runs as a masked sub-domain — results
        stay bit-identical to a solo run at ``g`` (the
        ``serve/buckets.py`` contract); infeasible sessions (fused
        mode, IF_DOMAIN conditions) decline and open exact, with the
        structured reason journaled on every batched row."""
        from yask_tpu_torch.serve.api import serve_bucketing_enabled
        requested = serve_bucketing_enabled() if bucket is None \
            else bool(bucket)
        decision, sub, host_g = self._plan_bucket(
            stencil, radius, g, mode, wf, options, requested)
        prof = self.registry.get_profile(stencil, radius, host_g, mode,
                                         wf, options)
        return self.registry.open_session(prof, session, sub_sizes=sub,
                                          bucket=decision).sid

    def _plan_bucket(self, stencil, radius, g, mode: str, wf: int,
                     options: str, requested: bool):
        """The open-time bucketing verdict: (BucketDecision,
        sub_sizes-or-None, host geometry).  Feasibility is probed on
        an UNPREPARED solution (equations + mode are all it needs), so
        a declined session never pays a wasted bucket-rung prepare."""
        from yask_tpu_torch.serve.buckets import BucketDecision, plan_bucket
        try:
            gi = int(g)
        except (TypeError, ValueError):
            return (BucketDecision(
                "exact", g=0,
                reason=f"non-cubic geometry {g!r} serves exact"),
                None, g)
        if not requested:
            return (BucketDecision("exact", g=gi,
                                   reason="bucketing not requested"),
                    None, g)
        probe = self._factory.new_solution(self._env, stencil=stencil,
                                           radius=radius)
        probe.get_settings().mode = mode
        decision = plan_bucket(probe, gi, True)
        if decision.decision != "bucketed":
            return decision, None, g
        sub = None
        if decision.bucket != gi:
            sub = {d: gi for d in probe._opts.global_domain_sizes}
        return decision, sub, decision.bucket

    def close_session(self, sid: str) -> None:
        self.registry.close_session(sid)

    def session_mode(self, sid: str) -> str:
        return self.registry.session(sid).mode

    # ----------------------------------------------- state in/out

    def set_var(self, sid: str, var: str, value: float) -> None:
        with self.scheduler.session_ctx(sid) as ctx:
            ctx.get_var(var).set_all_elements_same(value)

    def set_var_slice(self, sid: str, var: str, buf,
                      first_indices, last_indices) -> int:
        with self.scheduler.session_ctx(sid) as ctx:
            return ctx.get_var(var).set_elements_in_slice(
                np.asarray(buf), list(first_indices),
                list(last_indices))

    def get_var_slice(self, sid: str, var: str, first_indices,
                      last_indices):
        with self.scheduler.session_ctx(sid) as ctx:
            return ctx.get_var(var).get_elements_in_slice(
                list(first_indices), list(last_indices))

    def init_vars(self, sid: str) -> None:
        """The standard nonzero initial conditions
        (``init_solution_vars``) for this session's state — over the
        tenant's SUB-domain when the session is bucket-hosted, so a
        bucketed tenant starts bit-identical to its solo twin."""
        from yask_tpu_torch.runtime.init_utils import init_solution_vars
        sess = self.registry.session(sid)
        with self.scheduler.session_ctx(sid) as ctx:
            init_solution_vars(ctx, sub_sizes=sess.sub_sizes)

    def session_bucket(self, sid: str) -> Dict:
        """The session's structured bucketing verdict (empty for the
        pre-bucketing open path)."""
        b = self.registry.session(sid).bucket
        return b.as_detail() if b is not None else {}

    # ----------------------------------------------------- requests

    def submit(self, req: ServeRequest, on_stream=None):
        return self.scheduler.submit(req, on_stream=on_stream)

    def wait(self, handle, timeout: Optional[float] = None
             ) -> ServeResponse:
        return self.scheduler.wait(handle, timeout)

    def request(self, req: ServeRequest,
                timeout: Optional[float] = None) -> ServeResponse:
        return self.scheduler.request(req, timeout)

    def run(self, sid: str, first_step: int,
            last_step: Optional[int] = None,
            outputs=(), timeout: Optional[float] = None,
            flush_every: int = 0, stream_outputs: bool = False
            ) -> ServeResponse:
        return self.request(
            ServeRequest(session=sid, first_step=first_step,
                         last_step=last_step,
                         outputs=tuple(outputs),
                         flush_every=int(flush_every),
                         stream_outputs=bool(stream_outputs)), timeout)

    def submit_run(self, sid: str, first_step: int,
                   last_step: Optional[int] = None, outputs=(),
                   flush_every: int = 0, stream_outputs: bool = False):
        """Non-blocking :meth:`run` — returns the pending handle for
        :meth:`wait`.  Submitting a whole sweep before waiting is what
        lands compatible requests inside one batching window."""
        return self.submit(
            ServeRequest(session=sid, first_step=first_step,
                         last_step=last_step,
                         outputs=tuple(outputs),
                         flush_every=int(flush_every),
                         stream_outputs=bool(stream_outputs)))

    # ------------------------------------------------- checkpointing

    def snapshot(self, sid: str) -> Dict:
        """An interior-coordinate checkpoint of the session's state
        (``yask_tpu.checkpoint/1``), taken under the session's device
        lock so it never races a running chunk.  Restores
        bit-identically across modes/paddings."""
        from yask_tpu_torch.resilience.checkpoint import extract_snapshot
        with self.scheduler.session_ctx(sid) as ctx:
            return extract_snapshot(ctx)

    def restore(self, sid: str, snap: Dict) -> bool:
        """Apply a banked checkpoint onto the session (ring state +
        step counters).  Returns False on a schema/shape mismatch
        (``apply_snapshot`` contract: never raises)."""
        from yask_tpu_torch.resilience.checkpoint import apply_snapshot
        with self.scheduler.session_ctx(sid) as ctx:
            return bool(apply_snapshot(ctx, snap))

    # ----------------------------------------------------- warm start

    def prewarm(self, sid: str, steps: int) -> int:
        """Build the session's fused kernel (nvcc at first use) ahead of
        the first request, under the ``serve.run`` guard, the member
        batch's kernel where that is another (a push-off build), and K4
        where ``-trapezoid`` resolves it.  Returns
        1 for a fused session, 0 otherwise (torch mode builds nothing).
        ``steps`` is kept for parity."""
        from yask_tpu_torch.resilience.guard import guarded_call
        sess = self.registry.session(sid)
        with self.scheduler.session_ctx(sid) as ctx:
            if sess.mode != "fused":
                return 0
            guarded_call(lambda: (ctx._fused_kernel(),
                                  ctx._batched_kernel(),
                                  ctx._built_trapezoid_kernel()),
                         site="serve.run")
            return 1

    # ------------------------------------------------------- metrics

    def metrics(self) -> Dict:
        """Serving metrics over the retained samples: queue depth,
        batch occupancy, p50/p99 latency split queue/run, kernel-build
        tiers (``cache_hits``), degradation counts."""
        samples = self.scheduler.samples()
        done = [s for s in samples if s["status"] in ("ok", "anomaly")]
        q = [s["queue_secs"] * 1e3 for s in done]
        r = [s["run_secs"] * 1e3 for s in done]
        tot = [(s["queue_secs"] + s["run_secs"]) * 1e3 for s in done]
        occ = [s["batch"] for s in done]
        hits: Dict[str, int] = {}
        for s in done:
            hits[s["cache_hit"]] = hits.get(s["cache_hit"], 0) + 1
        return {
            "queue_depth": self.scheduler.queue_depth(),
            "sessions": len(self.registry.sessions()),
            "profiles": len(self.registry.profiles()),
            "completed": len(done),
            "ok": sum(1 for s in done if s["status"] == "ok"),
            "anomalies": sum(1 for s in done
                             if s["status"] == "anomaly"),
            "degraded": sum(1 for s in done if s["degraded"]),
            "bucketed": sum(1 for s in done if s.get("bucketed")),
            "preempted": sum(1 for s in done if s.get("preempted")),
            "batch_occupancy_mean": (sum(occ) / len(occ)) if occ
            else 0.0,
            "batch_occupancy_max": max(occ) if occ else 0,
            "p50_queue_ms": round(_pctl(q, 0.50), 3),
            "p99_queue_ms": round(_pctl(q, 0.99), 3),
            "p50_run_ms": round(_pctl(r, 0.50), 3),
            "p99_run_ms": round(_pctl(r, 0.99), 3),
            "p50_total_ms": round(_pctl(tot, 0.50), 3),
            "p99_total_ms": round(_pctl(tot, 0.99), 3),
            "compile_ms_total": round(sum(s["compile_secs"]
                                          for s in done) * 1e3, 1),
            "cache_hits": hits,
            # the obs registry's own view (same percentile math)
            "registry": self.obs.snapshot(),
        }

    def metrics_snapshot(self) -> Dict:
        """The per-worker telemetry unit a fleet front aggregates in
        ``yask_tpu``; it needs the compile cache and the fleet, which
        are not ported yet, so it raises."""
        raise YaskException(
            "metrics_snapshot is not ported yet: ROADMAP.md A7 (compile "
            "cache) and A13 (the fleet); use metrics()")

    def flush_metrics(self) -> List[Dict]:
        """``yask_tpu`` appends the serving metrics to its perflab
        ledger; perflab is not ported yet, so this raises (and never
        writes to any ledger file)."""
        raise YaskException(
            "flush_metrics is not ported yet: ROADMAP.md A14 (perflab); "
            "use metrics()")

    # ------------------------------------------------------ lifecycle

    def shutdown(self) -> None:
        self.scheduler.shutdown()
