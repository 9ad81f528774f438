"""SLO burn-rate monitor over the serving plane.

Counterpart of ``yask_tpu/obs/slo.py`` (same schema, knobs and rules).

Classic multi-window burn-rate alerting (SRE workbook shape) over four
request-level SLIs, fed per-release by the scheduler's registry hook:

- ``latency``    — request total latency vs ``YT_SLO_P99_MS`` (an event
                   is *bad* when it exceeds the objective; with the
                   default 1% budget this is exactly a p99 objective).
- ``error_rate`` — error + anomaly/quarantine releases.
- ``preemption`` — preempted streaming requests.
- ``occupancy``  — batch occupancy below ``YT_SLO_MIN_OCCUPANCY``.

For each SLI the monitor keeps a rolling event window and computes, for
every evaluation window W (default 5m and 1h), the burn rate
``bad_fraction(W) / budget``.  A breach fires only when EVERY window
burns above ``YT_SLO_BURN`` — the short window gives fast detection,
the long window suppresses blips.  Breaches are returned as
schema-versioned dicts (``yask_tpu.slo/1``) carrying the worst
offender's trace id; the caller journals them as ``slo_breach`` rows.

LOG-ONLY by definition (same policy as preflight): the monitor never
blocks, degrades, or rejects anything — it observes, journals, and
surfaces.  It is OFF unless at least one ``YT_SLO_*`` knob is set, so
an unconfigured build has zero overhead and bit-identical artifacts.

Knobs (all env, all optional):
  YT_SLO_P99_MS            latency objective in ms (SLI off when unset)
  YT_SLO_LATENCY_BUDGET    allowed bad fraction (default 0.01)
  YT_SLO_ERROR_BUDGET      allowed error+quarantine fraction (0.01)
  YT_SLO_PREEMPT_BUDGET    allowed preemption fraction (0.05)
  YT_SLO_MIN_OCCUPANCY     occupancy objective (SLI off when unset)
  YT_SLO_OCCUPANCY_BUDGET  allowed low-occupancy fraction (0.25)
  YT_SLO_WINDOWS           comma-joined window secs (default "300,3600")
  YT_SLO_BURN              burn-rate threshold (default 1.0)
  YT_SLO_COOLDOWN          min secs between breaches per SLI (60)
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

SLO_SCHEMA = "yask_tpu.slo/1"

_KNOB_PREFIX = "YT_SLO_"


def slo_enabled(env=None) -> bool:
    env = os.environ if env is None else env
    return any(k.startswith(_KNOB_PREFIX) for k in env)


def _fenv(env, key: str, default: Optional[float]) -> Optional[float]:
    raw = env.get(key)
    if raw is None or str(raw).strip() == "":
        return default
    try:
        return float(raw)
    except (TypeError, ValueError):
        return default


class SloMonitor:
    """Rolling multi-window burn-rate evaluation; see module doc."""

    def __init__(self,
                 windows: Tuple[float, ...] = (300.0, 3600.0),
                 burn_threshold: float = 1.0,
                 cooldown_secs: float = 60.0,
                 p99_ms: Optional[float] = None,
                 latency_budget: float = 0.01,
                 error_budget: float = 0.01,
                 preempt_budget: float = 0.05,
                 min_occupancy: Optional[float] = None,
                 occupancy_budget: float = 0.25,
                 clock=time.time):
        self.windows = tuple(sorted(float(w) for w in windows))
        self.burn_threshold = float(burn_threshold)
        self.cooldown_secs = float(cooldown_secs)
        self.p99_ms = p99_ms
        self.latency_budget = float(latency_budget)
        self.error_budget = float(error_budget)
        self.preempt_budget = float(preempt_budget)
        self.min_occupancy = min_occupancy
        self.occupancy_budget = float(occupancy_budget)
        self._clock = clock
        # event: (ts, {sli: bad}, trace)
        self._events: Deque[Tuple[float, Dict[str, bool],
                                  Optional[str]]] = deque(maxlen=65536)
        self._last_bad_trace: Dict[str, Optional[str]] = {}
        self._last_breach_ts: Dict[str, float] = {}
        self._breach_count = 0
        self._lock = threading.Lock()

    @classmethod
    def from_env(cls, env=None) -> Optional["SloMonitor"]:
        """Build from ``YT_SLO_*`` knobs; ``None`` when none are set
        (the monitor must cost nothing unless asked for)."""
        env = os.environ if env is None else env
        if not slo_enabled(env):
            return None
        raw = str(env.get("YT_SLO_WINDOWS", "") or "300,3600")
        try:
            windows = tuple(float(w) for w in raw.split(",") if w.strip())
        except ValueError:
            windows = (300.0, 3600.0)
        return cls(
            windows=windows or (300.0, 3600.0),
            burn_threshold=_fenv(env, "YT_SLO_BURN", 1.0),
            cooldown_secs=_fenv(env, "YT_SLO_COOLDOWN", 60.0),
            p99_ms=_fenv(env, "YT_SLO_P99_MS", None),
            latency_budget=_fenv(env, "YT_SLO_LATENCY_BUDGET", 0.01),
            error_budget=_fenv(env, "YT_SLO_ERROR_BUDGET", 0.01),
            preempt_budget=_fenv(env, "YT_SLO_PREEMPT_BUDGET", 0.05),
            min_occupancy=_fenv(env, "YT_SLO_MIN_OCCUPANCY", None),
            occupancy_budget=_fenv(env, "YT_SLO_OCCUPANCY_BUDGET", 0.25))

    def _budgets(self) -> Dict[str, float]:
        out = {"error_rate": self.error_budget,
               "preemption": self.preempt_budget}
        if self.p99_ms is not None:
            out["latency"] = self.latency_budget
        if self.min_occupancy is not None:
            out["occupancy"] = self.occupancy_budget
        return out

    def record(self, *,
               ok: bool = True,
               quarantined: bool = False,
               preempted: bool = False,
               total_ms: Optional[float] = None,
               occupancy: Optional[float] = None,
               trace: Optional[str] = None,
               ts: Optional[float] = None) -> None:
        """Feed one released request (the scheduler's registry hook)."""
        ts = self._clock() if ts is None else float(ts)
        bad = {"error_rate": bool(quarantined or not ok),
               "preemption": bool(preempted)}
        if self.p99_ms is not None and total_ms is not None:
            bad["latency"] = float(total_ms) > self.p99_ms
        if self.min_occupancy is not None and occupancy is not None:
            bad["occupancy"] = float(occupancy) < self.min_occupancy
        with self._lock:
            self._events.append((ts, bad, trace))
            for sli, b in bad.items():
                if b and trace:
                    self._last_bad_trace[sli] = trace

    def burn_rates(self, now: Optional[float] = None) -> Dict[str, Dict]:
        """Per-SLI, per-window ``{burn, bad, total}`` over the rolling
        event log.  Windows with zero events burn at 0."""
        now = self._clock() if now is None else float(now)
        with self._lock:
            events = list(self._events)
        out: Dict[str, Dict] = {}
        for sli, budget in self._budgets().items():
            per_win = {}
            for w in self.windows:
                cut = now - w
                total = bad = 0
                for ts, flags, _tr in events:
                    if ts < cut or sli not in flags:
                        continue
                    total += 1
                    bad += bool(flags[sli])
                frac = (bad / total) if total else 0.0
                per_win[str(int(w))] = {
                    "burn": (frac / budget) if budget > 0 else 0.0,
                    "bad": bad, "total": total}
            out[sli] = {"budget": budget, "windows": per_win}
        return out

    def evaluate(self, now: Optional[float] = None) -> List[Dict]:
        """Return NEW breaches (past per-SLI cooldown).  A breach
        requires every window to burn above the threshold."""
        now = self._clock() if now is None else float(now)
        rates = self.burn_rates(now)
        breaches: List[Dict] = []
        for sli, r in rates.items():
            wins = r["windows"]
            if not wins:
                continue
            if not all(w["total"] > 0 and
                       w["burn"] >= self.burn_threshold
                       for w in wins.values()):
                continue
            with self._lock:
                last = self._last_breach_ts.get(sli, -1e18)
                if now - last < self.cooldown_secs:
                    continue
                self._last_breach_ts[sli] = now
                self._breach_count += 1
                trace = self._last_bad_trace.get(sli)
            breaches.append({"v": SLO_SCHEMA,
                             "signal": sli,
                             "budget": r["budget"],
                             "threshold": self.burn_threshold,
                             "windows": wins,
                             "trace": trace,
                             "ts": now})
        return breaches

    def summary(self, now: Optional[float] = None) -> Dict:
        """JSON-able state for ``metrics()`` / fleet_stats surfacing."""
        return {"v": SLO_SCHEMA,
                "enabled": True,
                "breaches": self._breach_count,
                "last_breach_ts": dict(self._last_breach_ts),
                "burn": self.burn_rates(now)}
