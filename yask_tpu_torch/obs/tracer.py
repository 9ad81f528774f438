"""Zero-dependency span tracer: the port's correlation spine.

Counterpart of ``yask_tpu/obs/tracer.py``, with the same schema and the
same spans.  Schema ``yask_tpu.trace/1`` — one row per completed span,
appended to ``TRACE_EVENTS.jsonl`` (under
:func:`yask_tpu_torch.utils.paths.state_dir`, ``YT_TRACE_EVENTS``
override)::

    {"v": "yask_tpu.trace/1",
     "trace":  "t4f2...",          # trace id — one per request/run
     "span":   "s07ab...",         # this span
     "parent": "s0000...",         # "" at the root
     "name":   "run.chunk",
     "phase":  "compute",          # compile|exchange|compute|dma|
                                   # checkpoint|queue|front|tune|guard
     "ts":     1754486400.123,     # wall-clock epoch seconds (cross-
                                   # process placement; monotonic bases
                                   # differ between processes)
     "dur":    0.0123,             # perf_counter-measured seconds
     "pid":    1234, "tid": 5678,
     "attrs":  {...}}              # structured, producer-specific

Off by default and a TRUE no-op on the hot path: unless ``YT_TRACE``
is truthy, :func:`span` performs one env lookup and yields a shared
null object — no id generation, no clock reads, no file I/O, and no
file is ever created (the no-op guarantee is asserted by test).

Trace *ids* are independent of the enable gate: :func:`activate`
installs an upstream id (e.g. one stamped on a wire message by the
fleet front) in thread-local state so :func:`stamp_trace` can join
journal/ledger rows to the trace even in processes that do not write
spans themselves.

I/O discipline mirrors the serve journal: append-only, never raises
(an answer must not depend on evidence I/O), malformed lines skipped
on read, and :func:`compact_if_large` bounds growth
(``YT_TRACE_MAX_MB``, bad values fall back to the default, never
raises) by atomically keeping the newest tail of whole lines.
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from contextlib import contextmanager
from typing import Dict, Iterator, List, Optional

TRACE_SCHEMA = "yask_tpu.trace/1"
TRACE_BASENAME = "TRACE_EVENTS.jsonl"

#: canonical phase vocabulary — the obs_report breakdown groups on it.
PHASES = ("compile", "exchange", "compute", "dma", "checkpoint",
          "queue", "front", "tune", "guard")

_TRUTHY = ("1", "on", "true", "yes")


def trace_enabled() -> bool:
    """True when span *writing* is on (``YT_TRACE`` truthy).  Read
    from the environment on every call so tests can monkeypatch."""
    return os.environ.get("YT_TRACE", "").strip().lower() in _TRUTHY


def default_trace_path() -> str:
    if os.environ.get("YT_TRACE_EVENTS"):
        return os.environ["YT_TRACE_EVENTS"]
    from yask_tpu_torch.utils.paths import state_dir
    return os.path.join(state_dir(), TRACE_BASENAME)


def trace_max_bytes() -> int:
    """Compaction threshold (``YT_TRACE_MAX_MB``, default 64 MiB).
    Bad values fall back to the default — same contract as the
    journals' ``compact_if_large``."""
    try:
        mb = float(os.environ.get("YT_TRACE_MAX_MB", "") or 64.0)
        if mb <= 0:
            mb = 64.0
    except ValueError:
        mb = 64.0
    return int(mb * (1 << 20))


def new_trace_id() -> str:
    return "t" + uuid.uuid4().hex[:15]


def _new_span_id() -> str:
    return "s" + uuid.uuid4().hex[:15]


# ------------------------------------------------------------- context
# Thread-local: the active trace id plus the open-span stack.  Worker
# threads/processes join an upstream trace via activate(); nothing is
# inherited implicitly (the scheduler's device thread activates the
# request's id explicitly around each batch).
_tls = threading.local()


def _stack() -> List[str]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def current_trace_id() -> str:
    """The active trace id ("" when none)."""
    return getattr(_tls, "trace", "") or ""


def current_span_id() -> str:
    st = _stack()
    return st[-1] if st else ""


@contextmanager
def activate(trace_id: str) -> Iterator[str]:
    """Install ``trace_id`` as the thread's active trace for the
    duration (no-op passthrough on an empty id).  This is how an id
    stamped on a wire message by the fleet front propagates into a
    worker's journal/ledger rows via :func:`stamp_trace`."""
    if not trace_id:
        yield ""
        return
    prev = current_trace_id()
    _tls.trace = trace_id
    try:
        yield trace_id
    finally:
        _tls.trace = prev


def stamp_trace(row: Dict) -> Dict:
    """Set ``row["trace_id"]`` when a trace id is active; returns the
    row either way.  Journal/ledger append sites call this so every
    artifact joins against TRACE_EVENTS — repo_lint's TRACE-ID rule
    checks the call is present."""
    tid = current_trace_id()
    if tid:
        row["trace_id"] = tid
    return row


# --------------------------------------------------------------- spans
class Span:
    """A live span handle; ``set()`` merges attrs before close."""

    __slots__ = ("trace", "span", "parent", "name", "phase", "attrs",
                 "_t_wall", "_t0")

    def __init__(self, trace: str, parent: str, name: str, phase: str,
                 attrs: Dict):
        self.trace = trace
        self.span = _new_span_id()
        self.parent = parent
        self.name = name
        self.phase = phase
        self.attrs = attrs
        self._t_wall = time.time()
        self._t0 = time.perf_counter()

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self


class _NullSpan:
    """Shared no-op handle yielded when tracing is off."""

    __slots__ = ()
    trace = span = parent = name = phase = ""
    attrs: Dict = {}

    def set(self, **attrs) -> "_NullSpan":
        return self


_NULL = _NullSpan()

_compact_checked = False


def _jsonable(v):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return repr(v)


def _write_row(row: Dict) -> None:
    """Append one span row; never raises (evidence I/O must not cost
    an answer).  First write per process checks the size bound."""
    global _compact_checked
    path = default_trace_path()
    try:
        if not _compact_checked:
            _compact_checked = True
            compact_if_large(path)
        with open(path, "a") as f:  # lint: trace-id-ok
            f.write(json.dumps(row, sort_keys=True) + "\n")
    except (OSError, ValueError, TypeError):
        pass


@contextmanager
def span(name: str, phase: str = "", trace: str = "",
         **attrs) -> Iterator[Span]:
    """Open a span.  A true no-op unless ``YT_TRACE`` is set: one env
    lookup, then a shared null handle — no clocks, ids, or I/O."""
    if not trace_enabled():
        yield _NULL
        return
    tid = trace or current_trace_id() or new_trace_id()
    sp = Span(tid, current_span_id(), name, phase,
              {k: _jsonable(v) for k, v in attrs.items()})
    prev_trace = current_trace_id()
    _tls.trace = tid
    st = _stack()
    st.append(sp.span)
    try:
        yield sp
    finally:
        dur = time.perf_counter() - sp._t0
        st.pop()
        _tls.trace = prev_trace
        _write_row({"v": TRACE_SCHEMA, "trace": sp.trace,
                    "span": sp.span, "parent": sp.parent,
                    "name": sp.name, "phase": sp.phase,
                    "ts": sp._t_wall, "dur": dur,
                    "pid": os.getpid(),
                    "tid": threading.get_ident(),
                    "attrs": {k: _jsonable(v)
                              for k, v in sp.attrs.items()}})


def record_span(name: str, phase: str, start_wall: float, dur: float,
                trace: str = "", parent: str = "", **attrs) -> None:
    """Record a retroactive span from already-measured times (e.g. the
    queue-wait interval computed at release, or the halo share of a
    timed program call).  Same gate and I/O discipline as live spans."""
    if not trace_enabled():
        return
    _write_row({"v": TRACE_SCHEMA,
                "trace": trace or current_trace_id() or new_trace_id(),
                "span": _new_span_id(), "parent": parent,
                "name": name, "phase": phase,
                "ts": float(start_wall), "dur": float(dur),
                "pid": os.getpid(), "tid": threading.get_ident(),
                "attrs": {k: _jsonable(v) for k, v in attrs.items()}})


#: site-prefix → phase, for spans named after guarded_call sites.
_SITE_PHASES = (("ckpt.", "checkpoint"), ("cache.", "compile"),
                ("compile", "compile"), ("exchange", "exchange"),
                ("halo", "exchange"), ("comm", "exchange"),
                ("tuner.", "tune"), ("tune", "tune"),
                ("fleet.", "front"), ("serve.flush", "front"),
                ("state.", "dma"), ("dma", "dma"),
                ("serve.", "compute"), ("run.", "compute"),
                ("bench.", "compute"), ("session.", "compute"),
                ("multihost.", "compute"), ("pipeline.", "compute"),
                ("suite.", "compute"), ("watch.", "front"),
                ("load.", "front"))


def phase_for_site(site: str) -> str:
    for prefix, phase in _SITE_PHASES:
        if site.startswith(prefix):
            return phase
    return "guard"


# ---------------------------------------------------------------- read
def read_spans(path: Optional[str] = None) -> List[Dict]:
    """All span rows, file order; malformed lines skipped, never
    fatal (a producer may have crashed mid-write)."""
    path = path or default_trace_path()
    out: List[Dict] = []
    try:
        with open(path) as f:
            for ln in f:
                ln = ln.strip()
                if not ln:
                    continue
                try:
                    row = json.loads(ln)
                except ValueError:
                    continue
                if isinstance(row, dict) \
                        and row.get("v") == TRACE_SCHEMA:
                    out.append(row)
    except OSError:
        pass
    return out


def compact_if_large(path: Optional[str] = None,
                     max_bytes: Optional[int] = None) -> bool:
    """Bound file growth: when over the limit, atomically keep the
    newest tail of whole lines that fits half the limit (spans have no
    per-key identity to dedupe on — recency is the value).  Never
    raises; bad ``YT_TRACE_MAX_MB`` values use the default."""
    path = path or default_trace_path()
    try:
        limit = trace_max_bytes() if max_bytes is None \
            else int(max_bytes)
        if limit <= 0 or os.path.getsize(path) <= limit:
            return False
        with open(path, "rb") as f:
            lines = f.readlines()
        budget = limit // 2
        kept: List[bytes] = []
        total = 0
        for ln in reversed(lines):
            if total + len(ln) > budget and kept:
                break
            total += len(ln)
            kept.append(ln)
        kept.reverse()
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            f.writelines(kept)
        os.replace(tmp, path)
        return True
    except (OSError, ValueError):
        return False


# ---------------------------------------------------- device profiler
@contextmanager
def profile_window(logdir: Optional[str] = None) -> Iterator[None]:
    """Bracket a region in a device profiler trace: ``yask_tpu`` wraps
    ``jax.profiler``; the port's ``torch.profiler`` window is not ported
    yet, so asking for one raises."""
    from yask_tpu_torch.utils.exceptions import YaskException
    raise YaskException(
        "profile_window is not ported yet: ROADMAP.md A14 (observability, "
        "perflab and checker)")
    yield  # pragma: no cover
