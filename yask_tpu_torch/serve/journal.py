"""The serving journal: append-only ``SERVE_JOURNAL.jsonl``.

Counterpart of ``yask_tpu/serve/journal.py`` with the same schema string,
``yask_tpu.serve/1``, so journals of both packages read alike — one row
per request-lifecycle event::

    {"v": "yask_tpu.serve/1",
     "rid":     "r000007",             # request id
     "session": "s0003",
     "event":   "received|batched|ok|anomaly|rejected|fault|degraded"
                "|stream|preempted|resident_queue|resident_done|..."
     "ts":      "2026-08-05T12:00:00Z",
     "detail":  {...}}                 # event-specific

``ok`` / ``anomaly`` / ``rejected`` are terminal.  The default path is
under :func:`yask_tpu_torch.utils.paths.state_dir` (``YT_SERVE_JOURNAL``
overrides); servers in tests and ``chip_smoke.py`` pass their own.
Append-only, malformed lines skipped on read, atomic compaction between
servers.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, List, Optional

SERVE_SCHEMA = "yask_tpu.serve/1"
SERVE_JOURNAL_BASENAME = "SERVE_JOURNAL.jsonl"

#: terminal request states — one of these must be the last event of
#: every submitted request's lifecycle.
SERVE_TERMINAL = ("ok", "anomaly", "rejected")

SERVE_EVENTS = ("received", "batched", "ok", "anomaly", "rejected",
                "fault", "degraded", "stream", "preempted",
                # resident bulk path (yask_tpu/serve/resident.py):
                # resident_queue = a device-resident work list started
                # (detail: item count, session set), resident_done =
                # one touched session's outputs extracted after the
                # single end-of-queue sync.
                "resident_queue", "resident_done",
                # slo_breach = the LOG-ONLY SLO monitor saw every
                # burn-rate window above threshold (detail: signal,
                # budget, per-window burn; trace_id = worst offender).
                # The fleet, autoscale and overload-control events of
                # yask_tpu's journal come with the fleet (ROADMAP.md
                # A13).
                "slo_breach")


def default_serve_journal_path() -> str:
    if os.environ.get("YT_SERVE_JOURNAL"):
        return os.environ["YT_SERVE_JOURNAL"]
    from yask_tpu_torch.utils.paths import state_dir
    return os.path.join(state_dir(), SERVE_JOURNAL_BASENAME)


def serve_journal_max_bytes() -> int:
    """Size threshold for :meth:`ServeJournal.compact_if_large`
    (``YT_JOURNAL_MAX_MB``, default 64 MiB)."""
    try:
        mb = float(os.environ.get("YT_JOURNAL_MAX_MB", "") or 64.0)
    except ValueError:
        mb = 64.0
    return int(mb * (1 << 20))


def _utc_now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())


class ServeJournal:
    def __init__(self, path: Optional[str] = None):
        self.path = path or default_serve_journal_path()

    # ---------------------------------------------------------- write
    def record(self, rid: str, session: str, event: str,
               trace_id: str = "", **detail) -> Dict:
        """Append one lifecycle row.  Unlike the session journal this
        never raises: serving must survive a read-only journal dir (a
        tenant's answer cannot depend on evidence I/O), so failures
        return the row un-persisted.

        ``trace_id`` joins the row against TRACE_EVENTS.jsonl — the
        scheduler passes each request's own id explicitly (one batch
        can mix traces); callers without one inherit the thread's
        active trace via ``stamp_trace``."""
        from yask_tpu_torch.obs.tracer import stamp_trace
        if event not in SERVE_EVENTS:
            raise ValueError(f"unknown serve journal event {event!r}; "
                             f"one of {SERVE_EVENTS}")
        row = {"v": SERVE_SCHEMA, "rid": str(rid),
               "session": str(session), "event": str(event),
               "ts": _utc_now()}
        if trace_id:
            row["trace_id"] = str(trace_id)
        else:
            stamp_trace(row)
        if detail:
            row["detail"] = detail
        try:
            with open(self.path, "a") as f:
                f.write(json.dumps(row, sort_keys=True) + "\n")
        except OSError:
            pass
        return row

    # ----------------------------------------------------------- read
    def rows(self) -> List[Dict]:
        out: List[Dict] = []
        try:
            with open(self.path) as f:
                for ln in f:
                    ln = ln.strip()
                    if not ln:
                        continue
                    try:
                        row = json.loads(ln)
                    except ValueError:
                        continue
                    if isinstance(row, dict) \
                            and row.get("v") == SERVE_SCHEMA:
                        out.append(row)
        except OSError:
            pass
        return out

    def events(self, rid: str) -> List[Dict]:
        """One request's lifecycle, file order == time order."""
        return [r for r in self.rows() if r.get("rid") == rid]

    def terminal(self, rid: str) -> Optional[str]:
        """The request's terminal state, or None while in flight."""
        for r in reversed(self.events(rid)):
            if r["event"] in SERVE_TERMINAL:
                return r["event"]
        return None

    def max_occupancy(self) -> int:
        """Largest batch size any ``batched`` row records (0 when the
        server never batched) — the acceptance criterion's probe."""
        best = 0
        for r in self.rows():
            if r["event"] == "batched":
                best = max(best, int(r.get("detail", {})
                                     .get("batch", 0)))
        return best

    # ----------------------------------------------------------- admin
    def compact(self, keep_terminal_only: bool = True) -> int:
        """Atomically rewrite to the last event per rid (terminal rows
        preferred); run between servers, never during one.

        Admission control and the co-batching acceptance probe read
        ``max_occupancy()`` from ``batched`` rows, so compaction keeps
        the highest-occupancy ``batched`` row per rid alongside the
        terminal row — the occupancy evidence survives any number of
        compactions."""
        rows = self.rows()
        last: Dict[str, Dict] = {}
        best_batched: Dict[str, Dict] = {}
        order: List[str] = []
        for r in rows:
            rid = r.get("rid", "")
            if rid not in last:
                order.append(rid)
            if r["event"] == "batched":
                prev = best_batched.get(rid)
                occ = int(r.get("detail", {}).get("batch", 0))
                if prev is None or occ > int(prev.get("detail", {})
                                             .get("batch", 0)):
                    best_batched[rid] = r
            if not keep_terminal_only or r["event"] in SERVE_TERMINAL \
                    or last.get(rid, {}).get("event") \
                    not in SERVE_TERMINAL:
                last[rid] = r
        kept = 0
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            for rid in order:
                bb = best_batched.get(rid)
                if bb is not None and bb is not last[rid]:
                    f.write(json.dumps(bb, sort_keys=True) + "\n")
                    kept += 1
                f.write(json.dumps(last[rid], sort_keys=True) + "\n")
                kept += 1
        os.replace(tmp, self.path)
        return len(rows) - kept

    def compact_if_large(self, max_bytes: Optional[int] = None) -> bool:
        """Compact when the journal file exceeds ``max_bytes``
        (default :func:`serve_journal_max_bytes`).  Long-lived fleet
        workers call this at startup and between requests so
        ``SERVE_JOURNAL.w<i>.jsonl`` cannot grow unbounded.  Never
        raises — growth control must not take a worker down."""
        try:
            limit = serve_journal_max_bytes() if max_bytes is None \
                else int(max_bytes)
            if os.path.getsize(self.path) <= limit:
                return False
            self.compact()
            return True
        except (OSError, ValueError):
            return False
