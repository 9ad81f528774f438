"""yask_tpu_torch.serve — the in-process multi-tenant stencil server.

Counterpart of ``yask_tpu.serve``.  One process holds a **session
registry** of prepared solutions (:mod:`.registry`): a profile = one
prepared ``StencilContext`` per configuration and mode, a tenant = one
session id owning its own RunState under it.  A **micro-batching
scheduler** (:mod:`.scheduler`) groups compatible pending requests
(same profile / mode / variant key / step range) inside a bounded window
into ONE :class:`~yask_tpu_torch.runtime.ensemble.EnsembleRun` over the
tenants' RunStates — in ``fused`` mode one launch of K7, the
member-batched CUDA kernel, per step.

Every request runs through ``guarded_call`` at the ``serve.run`` fault
site, is journaled (schema ``yask_tpu.serve/1``), passes result-sanity
quarantine before its response is released, and a classified device
fault walks the session down the degradation ladder (``fused`` →
``torch``).  Shape-bucket co-batching (:mod:`.buckets`, torch mode),
streaming flushes with preemption, and the device-resident bulk path
(:mod:`.resident`) come along.  The JSON-lines wire front, client, fleet
and autoscaler are not ported yet (ROADMAP.md A13).
"""

from yask_tpu_torch.serve.api import (ServeRequest, ServeResponse,
                                      serve_bucketing_enabled,
                                      serve_deadline_secs, serve_max_batch,
                                      serve_window_secs)
from yask_tpu_torch.serve.buckets import (BucketDecision,
                                          bucket_cobatch_feasible,
                                          bucket_for, bucket_ladder,
                                          plan_bucket)
from yask_tpu_torch.serve.journal import (SERVE_SCHEMA, SERVE_TERMINAL,
                                          ServeJournal,
                                          default_serve_journal_path)
from yask_tpu_torch.serve.registry import SessionRegistry
from yask_tpu_torch.serve.server import StencilServer

__all__ = ["ServeRequest", "ServeResponse", "StencilServer",
           "SessionRegistry", "ServeJournal", "SERVE_SCHEMA",
           "SERVE_TERMINAL", "default_serve_journal_path",
           "serve_window_secs", "serve_max_batch",
           "serve_deadline_secs", "serve_bucketing_enabled",
           "BucketDecision", "bucket_ladder", "bucket_for",
           "plan_bucket", "bucket_cobatch_feasible"]
