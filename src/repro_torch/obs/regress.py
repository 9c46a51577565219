"""Noise-aware perf-regression detection over ledger series.

The statistics behind ``benchmarks/regress.py`` (kept importable so the
test suite can hammer them with synthetic series): compare a run's headline
metric against the trailing window of PRIOR runs *of the same config
fingerprint*, using a median ± MAD band so one noisy historical sample
can't widen or shift the baseline the way a mean/stddev would.

Band construction for a baseline window ``B``::

    center = median(B)
    sigma  = 1.4826 * median(|B - center|)     # MAD -> robust sigma
    band   = max(mad_scale * sigma, rel_floor * |center|)

The relative floor matters twice: it keeps zero-variance baselines (a
deterministic counter repeated N times) from flagging on the first
nanosecond of jitter, and it puts a lower bound on how subtle a regression
the sentinel claims to detect — CI boxes are noisy, and a tool that cries
wolf gets removed from CI. With the defaults (``mad_scale=4``,
``rel_floor=0.10``) a gaussian-noise series false-positives with
probability ~3e-5 per check, while a 30% step is caught immediately
(both pinned by seeded tests).

``min_samples`` guards cold starts: fewer prior same-fingerprint records
than that and the verdict is ``skip`` (accumulate, don't judge).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.obs.ledger import RunLedger, resolve_path

REGRESS_SCHEMA_VERSION = 1
REGRESS_KIND = "repro-regress"

DEFAULT_WINDOW = 20
DEFAULT_MIN_SAMPLES = 3
DEFAULT_MAD_SCALE = 4.0
DEFAULT_REL_FLOOR = 0.10

#: check verdicts
OK, REGRESSION, SKIP = "ok", "regression", "skip"


def median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    if n == 0:
        return 0.0
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def mad_sigma(xs: List[float]) -> float:
    """Robust sigma estimate: 1.4826 × median absolute deviation (the
    constant makes it consistent with stddev for gaussian data)."""
    if not xs:
        return 0.0
    c = median(xs)
    return 1.4826 * median([abs(x - c) for x in xs])


@dataclasses.dataclass
class CheckResult:
    run_kind: str
    metric: str
    direction: str          # "lower" / "higher" is better
    verdict: str            # ok / regression / skip
    current: Optional[float]
    baseline_median: Optional[float] = None
    band: Optional[float] = None
    n_baseline: int = 0
    detail: str = ""

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def check_series(
    baseline: List[float],
    current: float,
    *,
    direction: str = "lower",
    min_samples: int = DEFAULT_MIN_SAMPLES,
    mad_scale: float = DEFAULT_MAD_SCALE,
    rel_floor: float = DEFAULT_REL_FLOOR,
    run_kind: str = "?",
    metric: str = "?",
) -> CheckResult:
    """Judge ``current`` against the trailing ``baseline`` samples."""
    if direction not in ("lower", "higher"):
        raise ValueError(f"direction must be lower/higher, got {direction!r}")
    n = len(baseline)
    if n < min_samples:
        return CheckResult(
            run_kind, metric, direction, SKIP, current, n_baseline=n,
            detail=f"{n} baseline sample(s) < min_samples={min_samples}",
        )
    center = median(baseline)
    band = max(mad_scale * mad_sigma(baseline), rel_floor * abs(center))
    if direction == "lower":
        regressed = current > center + band
        edge = center + band
    else:
        regressed = current < center - band
        edge = center - band
    verdict = REGRESSION if regressed else OK
    rel = (current - center) / abs(center) if center else float("inf")
    return CheckResult(
        run_kind, metric, direction, verdict, current,
        baseline_median=center, band=band, n_baseline=n,
        detail=(
            f"current={current:.6g} vs median={center:.6g} "
            f"({rel:+.1%}), threshold={'>' if direction == 'lower' else '<'}"
            f"{edge:.6g}"
        ),
    )


def check_ledger(
    ledger: RunLedger,
    *,
    run_kinds: Optional[List[str]] = None,
    window: int = DEFAULT_WINDOW,
    min_samples: int = DEFAULT_MIN_SAMPLES,
    mad_scale: float = DEFAULT_MAD_SCALE,
    rel_floor: float = DEFAULT_REL_FLOOR,
) -> List[CheckResult]:
    """Sentinel pass over a whole ledger: for each run kind, judge the
    LATEST record's watched headline metrics against the trailing window of
    prior records sharing its config fingerprint. The watch list (metric →
    better-direction) comes from the latest record itself — the ledger is
    self-describing, this function knows nothing about specific benches.
    """
    results: List[CheckResult] = []
    for kind in (run_kinds or ledger.run_kinds()):
        recs = ledger.records(kind)
        if not recs:
            continue
        cur = recs[-1]
        watch: Dict[str, str] = cur.get("watch") or {}
        if not watch:
            results.append(CheckResult(
                kind, "-", "lower", SKIP, None,
                detail="latest record declares no watched metrics",
            ))
            continue
        prior = [
            r for r in recs[:-1]
            if r.get("fingerprint") == cur.get("fingerprint")
        ][-window:]
        for metric, direction in sorted(watch.items()):
            cur_v = resolve_path(cur, metric)
            if not isinstance(cur_v, (int, float)) or isinstance(cur_v, bool):
                results.append(CheckResult(
                    kind, metric, direction, SKIP, None,
                    detail="metric missing/non-numeric on latest record",
                ))
                continue
            base = [
                v for v in (resolve_path(r, metric) for r in prior)
                if isinstance(v, (int, float)) and not isinstance(v, bool)
            ]
            results.append(check_series(
                [float(v) for v in base], float(cur_v),
                direction=direction, min_samples=min_samples,
                mad_scale=mad_scale, rel_floor=rel_floor,
                run_kind=kind, metric=metric,
            ))
    return results


def report_payload(results: List[CheckResult], ledger_path: str,
                   params: Optional[dict] = None) -> dict:
    """JSON artifact form (``REGRESS_*.json``) consumed by
    ``benchmarks/lint_artifacts.py``."""
    checks = [r.to_dict() for r in results]
    return dict(
        kind=REGRESS_KIND,
        version=REGRESS_SCHEMA_VERSION,
        ledger=ledger_path,
        params=params or {},
        checks=checks,
        counts=dict(
            checks=len(checks),
            regressions=sum(1 for r in results if r.verdict == REGRESSION),
            ok=sum(1 for r in results if r.verdict == OK),
            skipped=sum(1 for r in results if r.verdict == SKIP),
        ),
    )
