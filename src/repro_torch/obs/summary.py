"""Per-epoch one-line structured summaries from ``Counters`` deltas.

The engine logs one line per epoch on the ``repro_torch.obs`` logger (silent
unless the application configures logging — the examples/launchers enable
``logging.basicConfig`` when ``--trace`` or ``-v`` is given):

    epoch=2 wall=1.84s stalls[top3]=compute_wait_fwd:0.41,h2d.put:0.12,...
    cache_hit=93.4% read_amp=1.62x io_read=812.3MB io_write=101.0MB

:class:`EpochSummarizer` keeps the previous :meth:`Counters.snapshot` and
reports per-epoch deltas, so totals accumulated across epochs (or a warmup
epoch) don't pollute later lines.
"""
from __future__ import annotations

import logging
from typing import Optional

LOG = logging.getLogger("repro_torch.obs")


def _delta(cur: dict, prev: dict, key: str) -> float:
    return cur.get(key, 0.0) - (prev.get(key, 0.0) if prev else 0.0)


def _prefix_delta(cur: dict, prev: dict, prefix: str) -> dict:
    """Deltas of every flattened ``snapshot()`` key under ``prefix`` (e.g.
    ``stall_``), keyed by the bare stage name."""
    out = {}
    for k, v in cur.items():
        if not k.startswith(prefix):
            continue
        d = v - (prev.get(k, 0.0) if prev else 0.0)
        if d > 0:
            out[k[len(prefix):]] = d
    return out


class EpochSummarizer:
    """Turn successive ``Counters.snapshot()`` dicts into one-line epoch
    summaries: top-3 stalls by stage, cache hit rate, and read
    amplification (paged bytes actually read / logical bytes requested)."""

    def __init__(self, counters):
        self.counters = counters
        self._prev: Optional[dict] = None
        self._epoch = 0

    def reset(self) -> None:
        """Re-baseline (e.g. after a warmup epoch's ``Counters.reset``)."""
        self._prev = None
        self._epoch = 0

    def summarize(self, wall_seconds: Optional[float] = None) -> str:
        """Format (and remember) the delta since the previous call."""
        cur = self.counters.snapshot()
        prev = self._prev
        self._prev = cur
        self._epoch += 1

        stalls = _prefix_delta(cur, prev, "stall_")
        top3 = sorted(stalls.items(), key=lambda kv: kv[1], reverse=True)[:3]
        stall_s = ",".join(f"{k}:{v:.2f}" for k, v in top3) or "none"

        hits = _delta(cur, prev, "cache_hits")
        misses = _delta(cur, prev, "cache_misses")
        total = hits + misses
        hit_s = f"{100.0 * hits / total:.1f}%" if total else "n/a"

        logical = _delta(cur, prev, "storage_read_bytes")
        paged = _delta(cur, prev, "storage_read_paged_bytes")
        amp_s = f"{paged / logical:.2f}x" if logical else "n/a"

        wrote = _delta(cur, prev, "storage_write_bytes")
        parts = [f"epoch={self._epoch}"]
        if wall_seconds is not None:
            parts.append(f"wall={wall_seconds:.2f}s")
        parts += [
            f"stalls[top3]={stall_s}",
            f"cache_hit={hit_s}",
            f"read_amp={amp_s}",
            f"io_read={paged / 1e6:.1f}MB",
            f"io_write={wrote / 1e6:.1f}MB",
        ]
        return " ".join(parts)

    def log_epoch(self, wall_seconds: Optional[float] = None) -> None:
        if LOG.isEnabledFor(logging.INFO):
            LOG.info(self.summarize(wall_seconds))
        else:
            # keep the delta baseline moving even when logging is off, so
            # enabling -v mid-run doesn't report a multi-epoch blob
            self.summarize(wall_seconds)
