"""repro_torch.obs — observability over the simulated runtime.

One subsystem, four pieces (see the module docstrings for detail):

  * ``events``  — typed TraceEvents, string-compatible with the legacy
    ``env.trace`` f-strings;
  * ``tracer``  — begin/end spans + instants on named tracks over the
    simulated clock (``NULL_TRACER`` when off: zero-overhead no-ops);
  * ``metrics`` — declared per-component stat schemas (``StatsView``) and
    the run-wide ``MetricsRegistry`` that indexes them;
  * ``export``  — Chrome-trace-event JSON (Perfetto-loadable) + flat
    metrics snapshots; ``report`` is the CLI over the export.

``Observability`` is the per-run bundle the orchestrator owns: it turns an
``ObsConfig`` into a tracer (real or null) plus a registry, adopts every
component's stats view, and exports the trace at run end.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.config import ObsConfig
from repro_torch.obs.metrics import (SCHEMAS, Histogram, MetricsRegistry,
                               StatsView, declared_keys)
from repro_torch.obs.tracer import NULL_TRACER, NullTracer, Span, Tracer
from repro_torch.obs.export import (chrome_trace, validate_chrome_trace,
                              write_chrome_trace)

__all__ = ["ObsConfig", "Observability", "SCHEMAS", "Histogram",
           "MetricsRegistry", "StatsView", "declared_keys", "NULL_TRACER",
           "NullTracer", "Span", "Tracer", "chrome_trace",
           "validate_chrome_trace", "write_chrome_trace"]


class Observability:
    """Per-run observability bundle: config + tracer + metrics registry."""

    def __init__(self, cfg: Optional[ObsConfig] = None):
        self.cfg = cfg if cfg is not None else ObsConfig()
        self.registry = MetricsRegistry()
        self.tracer = Tracer(registry=self.registry) if self.cfg.enabled \
            else NULL_TRACER

    @property
    def enabled(self) -> bool:
        return self.cfg.enabled

    def adopt(self, stats) -> None:
        """Register a component's StatsView with the run's registry (plain
        dicts — e.g. from tests poking legacy shims — are ignored)."""
        if isinstance(stats, StatsView):
            self.registry.adopt(stats)

    def finish(self, t: float) -> None:
        self.tracer.finish(t)

    def export(self, path: str) -> None:
        write_chrome_trace(path, self.tracer, metrics=self.registry.flat())
