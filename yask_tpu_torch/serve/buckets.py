"""Shape-bucket planning: map tenant geometries onto a small ladder of
shared bucket shapes so tenants on DIFFERENT domains co-batch.

Counterpart of ``yask_tpu/serve/buckets.py``.  A session opened at g=20
is hosted inside a bucket profile at the next ladder rung (g=24), runs
as a masked sub-domain of the bucket geometry
(:class:`~yask_tpu_torch.runtime.ensemble.EnsembleRun` ``sub_domains=``),
and shares the rung's profile with every other tenant on it.  Outside
the tenant's sub-domain every cell is held at zero after every step, so
an answer is bit-identical to a solo run at the tenant's geometry.

Bucketing is ``torch`` mode only, as ``yask_tpu`` keeps it jit-only:
the fused kernel advances a chunk with no hook between steps for the
mask, so fused sessions decline and serve exact.  Solutions with
``IF_DOMAIN`` conditions decline too (their conditions anchor to the
bucket's bounds).  ``YT_SERVE_BUCKETS`` overrides the rung list.

:func:`bucket_cobatch_feasible` is the ONE feasibility definition.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

#: default bucket rungs (those of yask_tpu): 8-multiples, <=1.5x steps
#: so bucket-padded volume stays bounded.
DEFAULT_LADDER = (8, 16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512)


def bucket_ladder() -> Tuple[int, ...]:
    """The active rung ladder (``YT_SERVE_BUCKETS`` override)."""
    raw = os.environ.get("YT_SERVE_BUCKETS", "").strip()
    if not raw:
        return DEFAULT_LADDER
    try:
        rungs = sorted({int(x) for x in raw.split(",") if x.strip()})
    except ValueError:
        return DEFAULT_LADDER
    return tuple(r for r in rungs if r > 0) or DEFAULT_LADDER


def bucket_for(g: int) -> Optional[int]:
    """Smallest ladder rung >= ``g`` (None when g overtops the
    ladder — such domains serve exact, they are past the
    small-domain co-batching regime anyway)."""
    g = int(g)
    for rung in bucket_ladder():
        if rung >= g:
            return rung
    return None


@dataclass
class BucketDecision:
    """The structured per-session bucketing verdict — journaled on
    every ``batched`` row so a decline is evidence, not a mystery.

    ``decision`` is one of ``bucketed`` (session rides a bucket
    profile as a sub-domain), ``exact`` (session is hosted at its own
    geometry: already on a rung, past the ladder, or bucketing was
    not requested), ``declined`` (bucketing was requested but the
    solution cannot run masked — ``reason`` says why; the session
    still opens, exact)."""
    decision: str
    reason: str = ""
    g: int = 0
    bucket: Optional[int] = None

    def as_detail(self) -> Dict:
        d = {"decision": self.decision, "g": self.g}
        if self.bucket is not None:
            d["bucket"] = self.bucket
        if self.reason:
            d["reason"] = self.reason
        return d


def bucket_cobatch_feasible(ctx) -> Tuple[bool, str]:
    """Can sessions hosted on this prepared context run as masked
    sub-domains of a shared bucket?  ``(ok, why)`` — the ONE
    definition (registry decision, scheduler, checker serve pass).

    Masked sub-domain runs interpose a zero-mask after EVERY step, so:

    * the mode must be ``torch`` — the fused kernel advances a chunk
      with no hook between steps, and ``ref`` already fails
      :func:`~yask_tpu_torch.runtime.ensemble.ensemble_feasible`;
    * no equation may carry an ``IF_DOMAIN`` condition: domain
      conditions anchor to the BUCKET's bounds (e.g. a reflective
      wall at ``x == last_index``), which is not where the tenant's
      sub-domain ends — masked results would diverge from solo.
      Step conditions (t-only) are position-free and stay exact.
    """
    from yask_tpu_torch.runtime.ensemble import ensemble_feasible
    ok, why = ensemble_feasible(ctx)
    if not ok:
        return False, why
    mode = ctx._mode or ctx._opts.mode
    if mode == "auto":
        mode = "torch"
    if mode != "torch":
        return False, (
            f"mode '{mode}' fuses steps in the kernel; the sub-domain "
            "zero-mask must interpose after every step, which only "
            "torch mode allows")
    for eq in ctx._soln.get_equations():
        if eq.cond is not None:
            return False, (
                f"equation writing '{eq.lhs.var_name()}' carries an "
                "IF_DOMAIN condition anchored to the bucket's domain "
                "bounds — a sub-domain tenant's boundary is elsewhere")
    return True, ""


def plan_bucket(ctx_probe, g: int, requested: bool) -> BucketDecision:
    """The open-session bucketing verdict for a tenant geometry ``g``
    given a prepared context at that geometry class (``ctx_probe`` may
    be the exact-geometry context — feasibility is a property of the
    solution + mode, not of the rung)."""
    g = int(g)
    if not requested:
        return BucketDecision("exact", g=g,
                              reason="bucketing not requested")
    rung = bucket_for(g)
    if rung is None:
        return BucketDecision(
            "exact", g=g,
            reason=f"g={g} overtops the bucket ladder "
                   f"{bucket_ladder()[-1]} — serving exact")
    ok, why = bucket_cobatch_feasible(ctx_probe)
    if not ok:
        return BucketDecision("declined", g=g, reason=why)
    if rung == g:
        # already on a rung: host on the bucket profile anyway (so it
        # co-batches with smaller tenants on the same rung) but no
        # sub-domain masking is needed — full-domain member.
        return BucketDecision("bucketed", g=g, bucket=rung,
                              reason="exact rung")
    return BucketDecision("bucketed", g=g, bucket=rung)
