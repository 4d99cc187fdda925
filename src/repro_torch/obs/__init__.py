"""``repro_torch.obs`` — metrics registry and phase spans for the port
(a copy of the counter, gauge, histogram, span and snapshot parts of the
reference's ``obs`` package).

One process-wide default :class:`~repro_torch.obs.registry.Registry`
backs the module-level helpers; instrumented modules cache metric objects
at import time so the hot-path cost is one bound-method call with an
enabled-flag branch.

Metric names used by the port: ``device.*`` (engine allocator call
sites), ``engine.*`` (publish queue), ``sched.*`` (admission),
``serve.*`` (latency histograms), ``trie.*`` (prefix-cache hits) and
``engine_recovery.*`` (named ``crash_and_recover`` phases).
"""

from __future__ import annotations

from .registry import Counter, Gauge, Histogram, Registry

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "get_registry",
    "counter", "gauge", "histogram", "span", "snapshot", "enable",
    "disable", "is_enabled",
]

_default = Registry(enabled=True)


def get_registry() -> Registry:
    return _default


def counter(name: str) -> Counter:
    return _default.counter(name)


def gauge(name: str) -> Gauge:
    return _default.gauge(name)


def histogram(name: str) -> Histogram:
    return _default.histogram(name)


def span(name: str):
    return _default.span(name)


def snapshot() -> dict:
    return _default.snapshot()


def enable() -> None:
    _default.enable()


def disable() -> None:
    _default.disable()


def is_enabled() -> bool:
    return _default.enabled
