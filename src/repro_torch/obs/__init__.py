"""Observability layer for the port (copied from the reference package).

- :mod:`repro_torch.obs.trace` — span tracer with Chrome/Perfetto export
- :mod:`repro_torch.obs.metrics` — counter/gauge/histogram registry
- :mod:`repro_torch.obs.summary` — per-epoch one-line structured summaries

Dependency-free (stdlib only) and imported by ``repro_torch.core.counters``.
The ledger, live exporter and attribution modules are not ported yet.
"""
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.summary import EpochSummarizer
from repro_torch.obs.trace import NULL_TRACER, Tracer

__all__ = ["Tracer", "NULL_TRACER", "MetricsRegistry", "EpochSummarizer"]
