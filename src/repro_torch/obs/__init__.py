"""Observability layer for the port (stdlib copies of the reference's).

- :mod:`repro_torch.obs.trace` — span tracer with Chrome/Perfetto export
- :mod:`repro_torch.obs.metrics` — counter/gauge/histogram registry
- :mod:`repro_torch.obs.summary` — per-epoch one-line structured summaries
- :mod:`repro_torch.obs.ledger` — append-only cross-run performance ledger
- :mod:`repro_torch.obs.live` — live sampler, Prometheus exporter, HTTP
  endpoint
- :mod:`repro_torch.obs.attribution` — achieved-vs-peak utilization per
  stage
- :mod:`repro_torch.obs.regress` — noise-aware perf-regression sentinel
  stats

Deliberately dependency-free (stdlib only) and imported by
``repro_torch.core.counters``, so it must never import from
``repro_torch.core`` / ``repro_torch.runtime`` at module scope (``live``
reaches ``repro_torch.core.threads.spawn`` lazily at thread-start time).
"""
from repro_torch.obs.attribution import attribution_report, format_attribution
from repro_torch.obs.ledger import (
    LedgerSchemaError, RunLedger, config_fingerprint, make_record,
)
from repro_torch.obs.live import (
    LiveSampler, TelemetryServer, parse_prometheus_text, to_prometheus_text,
)
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.summary import EpochSummarizer
from repro_torch.obs.trace import NULL_SPAN, NULL_TRACER, Tracer

__all__ = [
    "Tracer", "NULL_TRACER", "NULL_SPAN",
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "EpochSummarizer",
    "RunLedger", "LedgerSchemaError", "make_record", "config_fingerprint",
    "LiveSampler", "TelemetryServer",
    "to_prometheus_text", "parse_prometheus_text",
    "attribution_report", "format_attribution",
]
