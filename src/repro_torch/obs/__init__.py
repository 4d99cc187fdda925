"""``repro_torch.obs`` — metrics registry and phase spans for the port
(a copy of the counter, gauge, histogram, span, source, reset and
snapshot parts of the reference's ``obs`` package).

One process-wide default :class:`~repro_torch.obs.registry.Registry`
backs the module-level helpers; instrumented modules cache metric objects
at import time so the hot-path cost is one bound-method call with an
enabled-flag branch.

Metric names used by the port: ``device.*`` (engine allocator call
sites), ``engine.*`` (publish queue), ``sched.*`` (admission),
``serve.*`` (latency histograms), ``trie.*`` (prefix-cache hits),
``engine_recovery.*`` (named ``crash_and_recover`` phases) and, for the
host heap under the checkpoint store, the reference's ``heap.*``
(flush/fence/cas/drain sources registered by ``PersistentHeap``),
``alloc.*``, ``placement.*``, ``span.*`` and ``recovery.*`` names.
"""

from __future__ import annotations

from .registry import Counter, Gauge, Histogram, Registry, UnknownMetric

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "UnknownMetric",
    "get_registry", "counter", "gauge", "histogram", "register_source",
    "span", "snapshot", "reset", "reset_all", "enable", "disable",
    "is_enabled",
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


def register_source(name: str, read, reset=None) -> None:
    _default.register_source(name, read, reset)


def span(name: str, **args):
    return _default.span(name, **args)


def snapshot() -> dict:
    return _default.snapshot()


def reset(*names: str) -> None:
    _default.reset(*names)


def reset_all() -> None:
    _default.reset_all()


def enable() -> None:
    _default.enable()


def disable() -> None:
    _default.disable()


def is_enabled() -> bool:
    return _default.enabled
