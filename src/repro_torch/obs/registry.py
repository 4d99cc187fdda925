"""Dependency-free metrics registry: counters, gauges, histograms, spans.

The port's copy of the counter, gauge, histogram, span, source, reset and
snapshot parts of the reference's ``obs/registry.py``:

  * **Near-zero cost when disabled.**  Every hot-path mutator
    (``Counter.inc``, ``Gauge.set``, ``Histogram.observe``) is one
    attribute test + branch when the registry is disabled.  Instrumented
    modules cache the metric object at import time so the per-event cost
    is a bound-method call, never a registry lookup.
  * **Snapshot is plain data.**  :meth:`Registry.snapshot` returns a
    JSON-serializable dict.
  * **Resets are named and checked.**  External counter *sources* (the
    host heap's ``n_flush``/``n_fence``/... counts) register read/reset
    callbacks; :meth:`Registry.reset` raises :class:`UnknownMetric` on a
    name nothing registered, so a reset can never silently miss a heap.

Spans (:meth:`Registry.span`) always *time* — recovery stats carry their
phase durations whether or not metrics are on — but only accumulate into
the registry's phase table while the registry is enabled.

Counters tolerate racy ``+=`` under the GIL; structural mutation of the
registry itself is lock-protected.
"""

from __future__ import annotations

import threading
import time


class UnknownMetric(KeyError):
    """A reset named a metric nothing registered (or one that cannot be
    reset) -- raised instead of silently skipping."""


class Counter:
    """Monotonic event count (reset only via the registry)."""

    __slots__ = ("name", "value", "_reg")

    def __init__(self, name: str, reg: "Registry"):
        self.name = name
        self.value = 0
        self._reg = reg

    def inc(self, n: int = 1) -> None:
        if self._reg.enabled:
            self.value += n

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """Point-in-time value, explicitly ``set``."""

    __slots__ = ("name", "value", "_reg")

    def __init__(self, name: str, reg: "Registry"):
        self.name = name
        self.value = 0
        self._reg = reg

    def set(self, value) -> None:
        if self._reg.enabled:
            self.value = value

    def reset(self) -> None:
        self.value = 0


class Histogram:
    """Distribution summary with exact percentiles up to ``cap`` stored
    observations (benchmark rounds stay far below it); beyond the cap
    only count/sum/min/max keep updating and the summary says so."""

    __slots__ = ("name", "count", "total", "vmin", "vmax", "_values",
                 "_cap", "_reg")

    def __init__(self, name: str, reg: "Registry", cap: int = 16384):
        self.name = name
        self._cap = cap
        self._reg = reg
        self.reset()

    def observe(self, value) -> None:
        if not self._reg.enabled:
            return
        self.count += 1
        self.total += value
        if self.vmin is None or value < self.vmin:
            self.vmin = value
        if self.vmax is None or value > self.vmax:
            self.vmax = value
        if len(self._values) < self._cap:
            self._values.append(value)

    def reset(self) -> None:
        self.count = 0
        self.total = 0.0
        self.vmin = None
        self.vmax = None
        self._values = []

    def summary(self) -> dict:
        out = {"count": self.count, "sum": self.total,
               "min": self.vmin, "max": self.vmax,
               "mean": (self.total / self.count) if self.count else None}
        vals = sorted(self._values)
        for q, key in ((0.50, "p50"), (0.90, "p90"), (0.99, "p99")):
            out[key] = (vals[min(len(vals) - 1, int(q * len(vals)))]
                        if vals else None)
        if self.count > len(self._values):
            out["sampled"] = len(self._values)
        return out


class _Span:
    """Context manager timing one named phase.  Always times (callers
    read ``.seconds`` for their own stats); accumulates into the
    registry's phase table only while enabled.  ``add(n)`` attributes an
    item count to the phase (blocks swept, records pruned, ...)."""

    __slots__ = ("name", "args", "seconds", "items", "_reg", "_t0")

    def __init__(self, reg: "Registry", name: str, args: dict):
        self._reg = reg
        self.name = name
        self.args = args
        self.seconds = 0.0
        self.items = 0

    def add(self, n: int = 1) -> None:
        self.items += n

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.seconds = time.perf_counter() - self._t0
        reg = self._reg
        if reg.enabled:
            reg._record_span(self)


class Registry:
    """Named metrics + phase spans.

    ``counter``/``gauge``/``histogram`` are get-or-create (stable
    identity per name, so modules can cache the object at import time).
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}
        self._sources: dict[str, tuple] = {}     # name -> (read, reset|None)
        self._phases: dict[str, dict] = {}

    # ------------------------------------------------------------ lifecycle
    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    # ------------------------------------------------------ metric creation
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name, self))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name, self))
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram(name, self))
        return h

    def register_source(self, name: str, read, reset=None) -> None:
        """Register an externally-owned counter (e.g. the host heap's
        ``n_flush``).  Re-registering a name replaces the previous
        binding: the newest owner (the live heap) wins."""
        with self._lock:
            self._sources[name] = (read, reset)

    # ------------------------------------------------------------ span/phase
    def span(self, name: str, **args) -> _Span:
        return _Span(self, name, args)

    def _record_span(self, span: _Span) -> None:
        row = self._phases.get(span.name)
        if row is None:
            row = self._phases[span.name] = {
                "seconds": 0.0, "items": 0, "calls": 0}
        row["seconds"] += span.seconds
        row["items"] += span.items
        row["calls"] += 1

    # -------------------------------------------------------------- queries
    def snapshot(self) -> dict:
        counters = {n: c.value for n, c in self._counters.items()}
        for name, (read, _reset) in self._sources.items():
            counters[name] = read()
        return {
            "enabled": self.enabled,
            "counters": counters,
            "gauges": {n: g.value for n, g in self._gauges.items()},
            "histograms": {n: h.summary()
                           for n, h in self._histograms.items() if h.count},
            "phases": {n: dict(row) for n, row in self._phases.items()},
        }

    # --------------------------------------------------------------- resets
    def reset(self, *names: str) -> None:
        """Reset each named metric; unknown or unresettable names raise
        :class:`UnknownMetric` (never silently skipped)."""
        for name in names:
            if name in self._counters:
                self._counters[name].reset()
            elif name in self._histograms:
                self._histograms[name].reset()
            elif name in self._gauges:
                self._gauges[name].reset()
            elif name in self._sources:
                reset = self._sources[name][1]
                if reset is None:
                    raise UnknownMetric(
                        f"metric source {name!r} has no reset callback")
                reset()
            else:
                raise UnknownMetric(
                    f"no resettable metric named {name!r} is registered")

    def reset_all(self) -> None:
        """Zero every registry-owned metric and clear the phase table.
        External sources keep their owners' counts -- reset those by
        name, so a missing registration is an error, not a skew."""
        for c in self._counters.values():
            c.reset()
        for g in self._gauges.values():
            g.reset()
        for h in self._histograms.values():
            h.reset()
        self._phases.clear()
