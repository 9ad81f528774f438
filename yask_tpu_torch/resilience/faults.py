"""Fault taxonomy, classification, outage breaker, and fault injection.

Counterpart of ``yask_tpu/resilience/faults.py``: the same closed
taxonomy of :class:`Fault` kinds, :func:`classify`, the consecutive-fault
:class:`Breaker`, and fault injection through ``YT_FAULT_PLAN``
(:func:`fault_point` / :func:`maybe_corrupt` at named call sites), so the
machinery that keeps a served tenant alive is testable on the CPU.

The message signatures are the card's, not the TPU's: CUDA's
out-of-memory errors (``torch.cuda.OutOfMemoryError``, "CUDA out of
memory") classify as the memory-exhaustion kind (:class:`CompilerOOM`,
kind ``compiler_oom``, the class ``yask_tpu`` gives Mosaic's VMEM
exhaustion), and a failed ``nvcc`` build of a port kernel as
:class:`CompileFailed`.  Mosaic's signatures are not carried.

``YT_FAULT_PLAN`` accepts JSON (``[{"site": "serve.run", "kind":
"device_hang", "after": 2, "times": 99}]``) or the compact form
``site:kind[:times[:after]]`` with ``;`` between entries.  ``site``
patterns are :mod:`fnmatch` globs against site names.  Each entry fires
on hits ``after < n <= after + times`` of a matching site, counted per
process.
"""

from __future__ import annotations

import fnmatch
import json
import os
import time
from typing import Dict, List, Optional

__all__ = [
    "Fault", "RelayDown", "DeviceHang", "CompilerOOM", "CompileFailed",
    "ResultAnomaly", "WorkerDead", "WorkerUnhealthy", "LoadSpike",
    "FAULT_KINDS",
    "classify", "classify_message", "Breaker", "default_breaker_path",
    "fault_point", "maybe_corrupt", "reset_faults",
]


class Fault(Exception):
    """Base of the closed fault taxonomy.  Carries the site that raised
    it and (when classified from a raw exception) the original cause."""

    kind = "fault"

    def __init__(self, msg: str, site: Optional[str] = None,
                 cause: Optional[BaseException] = None):
        super().__init__(msg)
        self.site = site
        self.cause = cause


class RelayDown(Fault):
    """The transport to the device host is unreachable: connection
    resets, refused connections.  Retryable."""
    kind = "relay_down"


class DeviceHang(Fault):
    """Work exceeded its deadline (backend init or a compile/dispatch
    that never returns).  Retryable once; repeated hangs mean the
    window is gone."""
    kind = "device_hang"


class CompilerOOM(Fault):
    """Memory exhaustion: CUDA out of memory on the card (``yask_tpu``
    files Mosaic's VMEM exhaustion here).  NOT retryable: the
    configuration does not fit."""
    kind = "compiler_oom"


class CompileFailed(Fault):
    """A port kernel's ``nvcc`` build failed (or ``nvcc`` is missing).
    Not retryable: the same source fails the same way."""
    kind = "compile_failed"


class ResultAnomaly(Fault):
    """Device work returned values that fail the sanity guards
    (all-zero field, NaN/Inf, oracle mismatch)."""
    kind = "result_anomaly"


class WorkerDead(Fault):
    """A serve-fleet worker process exited (crash, OOM-kill, injected
    chaos kill).  Not retryable against the dead worker; the fleet
    supervisor fails the routed sessions over to a replacement."""
    kind = "worker_dead"


class WorkerUnhealthy(Fault):
    """A serve-fleet worker missed its heartbeat/liveness deadline
    (hung pipe, wedged backend) without exiting.  The supervisor
    SIGKILLs the process group and treats it as :class:`WorkerDead`."""
    kind = "worker_unhealthy"


class LoadSpike(Fault):
    """An injected traffic burst: the load harness probes
    ``fault_point("load.arrival")`` before each open-loop arrival and
    answers a raised LoadSpike with an immediate burst of extra
    requests.  Unlike the device faults this is demand-side chaos —
    nothing is broken, the offered load just jumped — so it is never
    retryable and never feeds the outage breaker."""
    kind = "load_spike"


FAULT_KINDS = {cls.kind: cls for cls in
               (RelayDown, DeviceHang, CompilerOOM, CompileFailed,
                ResultAnomaly, WorkerDead, WorkerUnhealthy, LoadSpike)}

# Message signatures, most specific first (an out-of-memory message may
# also name the failing build, so the OOM test wins).
_OOM_SIGNS = ("CUDA out of memory", "OutOfMemoryError",
              "cudaErrorMemoryAllocation")
_RELAY_SIGNS = ("Connection reset", "Connection refused",
                "failed to connect")
_COMPILE_SIGNS = ("kernel build failed", "nvcc not found", "nvcc exit")


def classify_message(msg: str) -> Optional[type]:
    """Map an exception message onto a Fault class (None = unknown)."""
    if any(s in msg for s in _OOM_SIGNS):
        return CompilerOOM
    if any(s in msg for s in _RELAY_SIGNS):
        return RelayDown
    if any(s in msg for s in _COMPILE_SIGNS):
        return CompileFailed
    return None


def classify(exc: BaseException,
             site: Optional[str] = None) -> Optional[Fault]:
    """Classify a raw exception into the taxonomy.

    Fault instances pass through unchanged (injection raises them
    directly); anything else is classified by message signature.
    Returns None for exceptions that are not a device/relay failure —
    callers must re-raise those (a ``KeyError`` in our own code must
    never be retried as if the relay blinked)."""
    if isinstance(exc, Fault):
        return exc
    cls = classify_message(f"{type(exc).__name__}: {exc}")
    if cls is None:
        return None
    f = cls(f"{type(exc).__name__}: {exc}", site=site, cause=exc)
    return f


def default_breaker_path() -> str:
    """Sidecar file for persistent breaker state (``YT_BREAKER_STATE``
    overrides; default ``BREAKER_STATE.json`` in
    :func:`yask_tpu_torch.utils.paths.state_dir`)."""
    explicit = os.environ.get("YT_BREAKER_STATE")
    if explicit:
        return explicit
    from yask_tpu_torch.utils.paths import state_dir
    return os.path.join(state_dir(), "BREAKER_STATE.json")


class Breaker:
    """Consecutive-failure circuit breaker.  ``record`` faults as they
    happen and ``reset`` on any success; once ``tripped``, the caller
    should stop the enclosing walk (the server stops degrading).

    With ``path`` set, state (count + last fault kind) persists to an
    atomic JSON sidecar and is reloaded on construction.  Sidecar I/O
    failures are swallowed: persistence is a convenience, never a new
    failure mode."""

    def __init__(self, threshold: int = 3, path: Optional[str] = None):
        self.threshold = threshold
        self.path = path
        self.consecutive = 0
        self.last: Optional[Fault] = None
        if path:
            self._load()

    def _load(self) -> None:
        try:
            with open(self.path) as f:
                d = json.load(f)
            self.consecutive = max(0, int(d.get("consecutive", 0)))
            cls = FAULT_KINDS.get(d.get("last_kind", ""))
            if cls is not None:
                self.last = cls(str(d.get("last_msg", "")))
        except (OSError, ValueError, TypeError):
            pass

    def _persist(self) -> None:
        if not self.path:
            return
        try:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                json.dump({"consecutive": self.consecutive,
                           "threshold": self.threshold,
                           "tripped": self.tripped,
                           "last_kind": getattr(self.last, "kind", None),
                           "last_msg": (str(self.last)[:200]
                                        if self.last else ""),
                           "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                               time.gmtime())}, f)
            os.replace(tmp, self.path)
        except OSError:
            pass

    def record(self, fault: Fault) -> bool:
        """Count one fault; returns whether the breaker is now open."""
        self.consecutive += 1
        self.last = fault
        self._persist()
        return self.tripped

    def reset(self) -> None:
        self.consecutive = 0
        self._persist()

    @property
    def tripped(self) -> bool:
        return self.consecutive >= self.threshold


# ---------------------------------------------------------------------------
# fault injection (YT_FAULT_PLAN)

#: corruption kinds understood by maybe_corrupt (everything else raises
#: at fault_point).
_CORRUPT_KINDS = ("zero_output", "nan_output")

_STATE: Dict = {"raw": None, "entries": []}


def _parse_plan(raw: str) -> List[Dict]:
    raw = raw.strip()
    if not raw:
        return []
    if raw.startswith("["):
        entries = json.loads(raw)
    else:
        entries = []
        for part in raw.split(";"):
            part = part.strip()
            if not part:
                continue
            bits = part.split(":")
            if len(bits) < 2:
                raise ValueError(
                    f"YT_FAULT_PLAN entry {part!r}: want site:kind"
                    "[:times[:after]]")
            e = {"site": bits[0], "kind": bits[1]}
            if len(bits) > 2:
                e["times"] = int(bits[2])
            if len(bits) > 3:
                e["after"] = int(bits[3])
            entries.append(e)
    out = []
    for e in entries:
        kind = e.get("kind", "")
        if kind not in FAULT_KINDS and kind not in _CORRUPT_KINDS \
                and kind not in ("exception", "hang"):
            raise ValueError(f"YT_FAULT_PLAN: unknown fault kind "
                             f"{kind!r}")
        out.append({"site": e.get("site", "*"), "kind": kind,
                    "times": int(e.get("times", 1)),
                    "after": int(e.get("after", 0)),
                    "secs": float(e.get("secs", 3600.0)),
                    "_seen": 0})
    return out


def _entries() -> List[Dict]:
    raw = os.environ.get("YT_FAULT_PLAN", "")
    if raw != _STATE["raw"]:
        _STATE["raw"] = raw
        _STATE["entries"] = _parse_plan(raw)
    return _STATE["entries"]


def reset_faults() -> None:
    """Forget parsed plan + hit counters (test isolation helper)."""
    _STATE["raw"] = None
    _STATE["entries"] = []


def _firing(site: str, kinds=None) -> Optional[Dict]:
    for e in _entries():
        if kinds is not None and e["kind"] not in kinds:
            continue
        if not fnmatch.fnmatch(site, e["site"]):
            continue
        e["_seen"] += 1
        if e["after"] < e["_seen"] <= e["after"] + e["times"]:
            return e
    return None


def fault_point(site: str) -> None:
    """Raise (or hang on) the planned fault at a named site.  A no-op
    without a matching ``YT_FAULT_PLAN`` entry — every call is cheap
    enough to leave in production paths."""
    e = _firing(site, kinds=set(FAULT_KINDS) | {"exception", "hang"})
    if e is None:
        return
    kind = e["kind"]
    if kind == "hang":
        # an interruptible stall: the deadline machinery (guard.py)
        # must convert this into a DeviceHang
        time.sleep(e["secs"])
        return
    if kind == "exception":
        raise RuntimeError(f"injected exception at {site}")
    if kind == "relay_down":
        raise RelayDown(f"injected relay drop at {site} "
                        "(failed to connect)", site=site)
    if kind == "device_hang":
        raise DeviceHang(f"injected hang at {site}", site=site)
    if kind == "compiler_oom":
        raise CompilerOOM(f"injected OOM at {site} (CUDA out of memory)",
                          site=site)
    if kind == "compile_failed":
        raise CompileFailed(f"injected kernel build failure at {site} "
                            "(nvcc exit 1)", site=site)
    if kind == "result_anomaly":
        raise ResultAnomaly(f"injected result anomaly at {site}",
                            site=site)
    if kind == "worker_dead":
        raise WorkerDead(f"injected worker death at {site}", site=site)
    if kind == "worker_unhealthy":
        raise WorkerUnhealthy(f"injected unhealthy worker at {site}",
                              site=site)
    if kind == "load_spike":
        raise LoadSpike(f"injected load spike at {site}", site=site)


def maybe_corrupt(site: str, value):
    """Return ``value`` (an ndarray, a var→array dict, or a
    var→ring-of-arrays state dict) corrupted per the plan — all-zero or
    NaN — or unchanged.  Producers call this on outputs right before the
    sanity guards."""
    e = _firing(site, kinds=set(_CORRUPT_KINDS))
    if e is None:
        return value
    import numpy as np

    def corrupt(a):
        a = np.array(a, copy=True)
        a[...] = 0.0 if e["kind"] == "zero_output" else np.nan
        return a

    if isinstance(value, dict):
        return {k: ([corrupt(a) for a in v] if isinstance(v, (list, tuple))
                    else corrupt(v))
                for k, v in value.items()}
    return corrupt(value)
