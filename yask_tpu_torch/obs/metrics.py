"""Process-local metrics: counters / gauges / histograms with p50/p99.

Counterpart of ``yask_tpu/obs/metrics.py``, unchanged in behaviour.

The registry subsumes the ad-hoc percentile math that used to live in
``serve.server._pctl`` — :func:`percentile` IS that implementation
(nearest-rank on ``round(q*(n-1))``), hoisted so the server, the
fleet front, and any future producer compute identical quantiles.

Zero dependencies, thread-safe, JSON-able snapshots::

    reg = Registry()
    reg.counter("serve.requests.ok").inc()
    reg.histogram("serve.total_ms").observe(12.5)
    reg.snapshot()  # {"counters": {...}, "gauges": {...},
                    #  "histograms": {name: {count, mean, p50, p99,
                    #                        max, ...}}}

Histograms keep a bounded sample window (default 4096, oldest
evicted) — the same retention the scheduler applies to its samples
list, so registry quantiles match ``server.metrics()`` exactly.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Deque, Dict, List

DEFAULT_WINDOW = 4096


def percentile(xs: List[float], q: float) -> float:
    """Nearest-rank percentile, exactly the historical serve metric:
    ``sorted(xs)[min(n-1, round(q*(n-1)))]``; 0.0 on empty input."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    i = min(len(xs) - 1, int(round(q * (len(xs) - 1))))
    return xs[i]


class Counter:
    __slots__ = ("_v", "_lock")

    def __init__(self):
        self._v = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._v += n

    @property
    def value(self) -> int:
        return self._v


class Gauge:
    __slots__ = ("_v", "_lock")

    def __init__(self):
        self._v = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    @property
    def value(self) -> float:
        return self._v


class Histogram:
    """Bounded-window histogram; quantiles via :func:`percentile`."""

    __slots__ = ("_xs", "_count", "_sum", "_max", "_lock")

    def __init__(self, window: int = DEFAULT_WINDOW):
        self._xs: Deque[float] = deque(maxlen=max(1, int(window)))
        self._count = 0
        self._sum = 0.0
        self._max = 0.0
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._xs.append(v)
            self._count += 1
            self._sum += v
            if v > self._max:
                self._max = v

    def percentile(self, q: float) -> float:
        with self._lock:
            xs = list(self._xs)
        return percentile(xs, q)

    @property
    def count(self) -> int:
        return self._count

    def summary(self) -> Dict:
        with self._lock:
            xs = list(self._xs)
            count, total, mx = self._count, self._sum, self._max
        return {"count": count,
                "mean": (total / count) if count else 0.0,
                "p50": percentile(xs, 0.50),
                "p99": percentile(xs, 0.99),
                "max": mx,
                "window": len(xs)}


class Registry:
    """Named metric instruments, created on first touch."""

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter()
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge()
            return g

    def histogram(self, name: str,
                  window: int = DEFAULT_WINDOW) -> Histogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram(window)
            return h

    def snapshot(self) -> Dict:
        """JSON-able view of every instrument — what the fleet's
        ``op_metrics`` exports per worker."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hists)
        return {"counters": {k: c.value
                             for k, c in sorted(counters.items())},
                "gauges": {k: g.value
                           for k, g in sorted(gauges.items())},
                "histograms": {k: h.summary()
                               for k, h in sorted(hists.items())}}
