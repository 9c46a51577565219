"""Bandwidth/compute attribution: achieved-vs-peak utilization per stage.

Joins the run's measured byte counters and per-stage busy time (a
:meth:`Counters.snapshot` dict) against the tier bandwidth model
(:class:`repro_torch.core.costmodel.TierBandwidths`, duck-typed here so
``repro_torch.obs`` stays stdlib-only) to answer the question the ROADMAP's
optimization arc keeps asking: *which stage is the bottleneck right now,
and how far from peak is each tier running?*

Per stage the report carries::

    {"bytes": ..., "busy_s": ..., "achieved_bps": bytes/busy_s,
     "peak_bps": modeled tier bandwidth, "utilization": achieved/peak,
     "basis": "<which denominator was available>"}

The denominator preference order is: the stage's own measured service time
(the ``storage.read_seconds``/``storage.write_seconds`` histogram sums from
the metrics registry — reads that went through the I/O queue), then the
pipeline stage busy time (``busy_prefetch`` etc. — covers gather-worker
reads that bypass the queue), then the run wall time (a lower bound on
achieved bandwidth). ``basis`` names which one was used so a report is
never silently comparing different denominators across runs.

``limiting_stage`` names the stage whose MODELED time (bytes / peak
bandwidth, flops / peak flops — the same terms as
:func:`repro_torch.core.costmodel.modeled_time`) dominates: the stage that bounds
the fully-overlapped pipeline, i.e. where optimization effort pays.
"""
from __future__ import annotations

from typing import Dict, Optional

ATTRIBUTION_SCHEMA_VERSION = 1

# snapshot-dict field names feeding each stage's byte total
_STAGE_BYTES = {
    "storage_read": ("storage_read_paged_bytes",),
    "storage_write": ("storage_write_paged_bytes",),
    "host_gather": ("host_gather_bytes", "host_scatter_bytes"),
    "device_link": ("h2d_bytes", "d2h_bytes"),
}

# pipeline stages whose busy time serves each attribution stage (fallback
# denominator when the metrics registry has no direct service-time sum)
_STAGE_BUSY = {
    "storage_read": ("busy_prefetch", "busy_prefetch_bwd", "busy_snap_prefetch",
                     "busy_snap_fetch", "busy_grad_fetch", "busy_loss_fetch",
                     "busy_async_read"),
    "storage_write": ("busy_write_behind",),
    "host_gather": ("busy_gather", "busy_regather"),
    "device_link": ("busy_h2d", "busy_d2h"),
}


def _peak_bps(bw, stage: str) -> float:
    if stage in ("storage_read", "storage_write"):
        return float(getattr(bw, "ssd", 0.0))
    if stage == "host_gather":
        return float(getattr(bw, "host_mem", 0.0))
    if stage == "device_link":
        return float(getattr(bw, "host_link", 0.0))
    return 0.0


def _hist_sum(metrics: Optional[Dict], name: str) -> float:
    if not metrics:
        return 0.0
    h = metrics.get(name)
    if isinstance(h, dict):
        s = h.get("sum", 0.0)
        if isinstance(s, (int, float)):
            return float(s)
    return 0.0


def attribution_report(
    snapshot: Dict[str, float],
    bw,
    wall_s: float,
    flops: float = 0.0,
    metrics: Optional[Dict] = None,
) -> Dict:
    """Build the achieved-vs-peak report.

    ``snapshot`` is a :meth:`Counters.snapshot` dict (or a per-epoch delta
    of one — the math is linear in the fields), ``bw`` a
    ``TierBandwidths``-shaped object, ``metrics`` an optional
    :meth:`MetricsRegistry.snapshot` dict supplying measured service-time
    sums. Degenerate inputs (no bytes moved, zero wall) produce zeroed
    entries rather than raising — an attribution of "nothing happened" is
    itself informative.
    """
    wall_s = max(0.0, float(wall_s))
    stages: Dict[str, Dict] = {}
    modeled: Dict[str, float] = {}
    measured_service = {
        "storage_read": _hist_sum(metrics, "storage.read_seconds"),
        "storage_write": _hist_sum(metrics, "storage.write_seconds"),
    }
    for stage, fields in _STAGE_BYTES.items():
        nbytes = float(sum(snapshot.get(f, 0) or 0 for f in fields))
        peak = _peak_bps(bw, stage)
        svc = measured_service.get(stage, 0.0)
        busy = float(sum(
            snapshot.get(k, 0.0) or 0.0 for k in _STAGE_BUSY[stage]
        ))
        if svc > 0:
            denom, basis = svc, "measured_service_s"
        elif busy > 0:
            denom, basis = busy, "stage_busy_s"
        elif wall_s > 0:
            denom, basis = wall_s, "wall_s"
        else:
            denom, basis = 0.0, "none"
        achieved = nbytes / denom if denom > 0 else 0.0
        stages[stage] = dict(
            bytes=nbytes,
            busy_s=busy if busy > 0 else denom,
            achieved_bps=achieved,
            peak_bps=peak,
            utilization=(achieved / peak) if peak > 0 else 0.0,
            basis=basis,
        )
        modeled[stage] = nbytes / peak if peak > 0 else 0.0

    # compute: flops over the wall not spent waiting on workers is the best
    # single-thread estimate we have without a device profiler
    peak_flops = float(getattr(bw, "peak_flops", 0.0))
    achieved_flops = flops / wall_s if wall_s > 0 else 0.0
    stages["compute"] = dict(
        flops=float(flops),
        busy_s=wall_s,
        achieved_flops=achieved_flops,
        peak_flops=peak_flops,
        utilization=(achieved_flops / peak_flops) if peak_flops > 0 else 0.0,
        basis="wall_s",
    )
    modeled["compute"] = flops / peak_flops if peak_flops > 0 else 0.0

    limiting = max(modeled, key=lambda k: modeled[k]) if any(
        v > 0 for v in modeled.values()
    ) else None
    return dict(
        schema_version=ATTRIBUTION_SCHEMA_VERSION,
        wall_s=wall_s,
        stages=stages,
        modeled_s=modeled,
        limiting_stage=limiting,
    )


def format_attribution(report: Dict) -> str:
    """One line per stage for CSV-style bench output / epoch summaries:
    ``attribution.storage_read,42.1MB/s,util=0.04 of 1.0GB/s``."""
    lines = []
    for stage, s in sorted(report["stages"].items()):
        if stage == "compute":
            lines.append(
                f"attribution.compute,{s['achieved_flops'] / 1e9:.2f}GFLOP/s,"
                f"util={s['utilization']:.3f} of "
                f"{s['peak_flops'] / 1e12:.0f}TFLOP/s"
            )
        else:
            lines.append(
                f"attribution.{stage},{s['achieved_bps'] / 1e6:.1f}MB/s,"
                f"util={s['utilization']:.3f} of "
                f"{s['peak_bps'] / 1e9:.1f}GB/s basis={s['basis']}"
            )
    lines.append(
        f"attribution.limiting_stage,0,{report['limiting_stage']}"
    )
    return "\n".join(lines)
