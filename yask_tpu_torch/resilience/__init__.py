"""yask_tpu_torch.resilience — the port's fault policy (counterpart of
``yask_tpu.resilience``): fault taxonomy + classification with CUDA's
signatures (:mod:`.faults`), deadlines and retry (:mod:`.guard`), portable
snapshots + the mode-degradation ladder (:mod:`.checkpoint`), and
result-sanity guards (:mod:`.sanity`).  Fault injection via
``YT_FAULT_PLAN`` drives all of it from CPU tests."""

from yask_tpu_torch.resilience.checkpoint import (  # noqa: F401
    CKPT_SCHEMA, apply_snapshot, degradation_ladder, extract_snapshot,
    peek_checkpoint, restore_checkpoint, save_checkpoint)
from yask_tpu_torch.resilience.faults import (  # noqa: F401
    FAULT_KINDS, Breaker, CompileFailed, CompilerOOM, DeviceHang, Fault,
    RelayDown, ResultAnomaly, classify, classify_message, fault_point,
    maybe_corrupt, reset_faults)
from yask_tpu_torch.resilience.guard import (  # noqa: F401
    RETRYABLE, deadline, guarded_call)
from yask_tpu_torch.resilience.sanity import (  # noqa: F401
    anomaly_fields, check_output)
