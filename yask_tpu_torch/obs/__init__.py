"""yask_tpu_torch.obs — the port's span tracer, metrics registry and SLO
burn-rate monitor (counterparts of ``yask_tpu.obs``'s modules of the same
names).  The device profiler window, fleet telemetry and roofline
attribution are not ported yet (ROADMAP.md A14)."""

from yask_tpu_torch.obs.tracer import (  # noqa: F401
    TRACE_SCHEMA, activate, current_trace_id, new_trace_id,
    phase_for_site, profile_window, read_spans, record_span, span,
    stamp_trace, trace_enabled)
from yask_tpu_torch.obs.metrics import Registry, percentile  # noqa: F401
from yask_tpu_torch.obs.slo import SloMonitor, slo_enabled  # noqa: F401
