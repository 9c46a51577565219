"""Append-only run ledger: the repo's cross-run performance memory.

Every benchmark / engine run appends ONE schema-versioned JSON line to a
``.jsonl`` ledger (canonically ``RUNS/ledger.jsonl``), carrying everything a
later reader needs to compare runs without re-running them:

- ``run_kind`` — which producer wrote it (``pipeline_overlap``,
  ``serving_throughput``, ``kernel_hotpath``, ``fault_soak``, launchers);
- ``fingerprint`` — a stable hash of the run's config dict, so the
  regression sentinel only ever compares like against like (changing
  ``--nodes`` starts a fresh series instead of poisoning the old one);
- ``git_rev`` / ``backend`` / ``written_at`` — provenance;
- ``headline`` — the flat, small dict of numbers worth tracking over time
  (epoch wall, overlap fraction, qps, p99, ...), with an optional ``watch``
  map declaring which direction is "better" per headline metric — the
  ledger is self-describing, the sentinel carries no per-bench tables;
- ``counters`` / ``metrics`` — the full :meth:`Counters.snapshot` and
  :meth:`MetricsRegistry.snapshot` dumps, so any number that later turns
  out to matter is already in the history;
- ``attribution`` — the achieved-vs-peak utilization report
  (:mod:`repro_torch.obs.attribution`), when the producer computed one.

Writes are one ``write()`` of one ``\\n``-terminated line on an append-mode
handle under a lock — concurrent appenders (two benches, or a bench racing
its own serve thread) interleave whole lines, never torn ones (pinned by
test). Records missing the provenance fields are REFUSED with
:class:`LedgerSchemaError` rather than written — a ledger line that can't
be attributed to a config is silent drift, the exact failure mode this
module exists to kill.

Deliberately stdlib-only (``repro_torch.obs`` is imported by
``repro_torch.core.counters``): the backend, the torch device type
(``"cuda"`` or ``"cpu"``), is supplied by callers.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import threading
import time
from typing import Dict, List, Optional

LEDGER_SCHEMA_VERSION = 1
LEDGER_KIND = "repro-run"

#: Fields every record must carry to be appendable. ``counters`` /
#: ``metrics`` / ``attribution`` / ``watch`` are optional payload.
REQUIRED_FIELDS = (
    "kind", "schema_version", "run_kind", "fingerprint", "config",
    "written_at", "headline",
)


class LedgerSchemaError(ValueError):
    """A record is missing required fields (or carries wrong types) —
    refused instead of appended, so the ledger never accumulates
    unattributable lines."""


def config_fingerprint(config: Dict) -> str:
    """Stable short hash of a config dict: sha256 over the canonical
    (sorted-keys, compact) JSON form, truncated to 16 hex chars. Two runs
    share a fingerprint iff their configs are equal as JSON values."""
    blob = json.dumps(config, sort_keys=True, separators=(",", ":"),
                      default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def git_revision(cwd: Optional[str] = None) -> Optional[str]:
    """Current short git rev, or ``None`` outside a checkout / without git.
    ``REPRO_GIT_REV`` overrides (CI images without a .git dir)."""
    env_rev = os.environ.get("REPRO_GIT_REV")
    if env_rev:
        return env_rev
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            cwd=cwd, capture_output=True, timeout=5,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    return out.stdout.decode().strip() or None


def make_record(
    run_kind: str,
    config: Dict,
    headline: Dict[str, float],
    *,
    counters=None,
    watch: Optional[Dict[str, str]] = None,
    attribution: Optional[Dict] = None,
    backend: Optional[str] = None,
    extra: Optional[Dict] = None,
) -> Dict:
    """Build a ledger record from a run's config + results.

    ``counters`` (a :class:`repro_torch.core.counters.Counters`)
    contributes both its scalar snapshot and its metrics-registry snapshot;
    ``watch`` maps headline metric names to ``"lower"``/``"higher"`` (which
    direction is better — consumed by the regression sentinel);
    ``attribution`` is the achieved-vs-peak report from
    :mod:`repro_torch.obs.attribution`; ``backend`` the device type the run
    used (``"cuda"`` or ``"cpu"``).
    """
    rec = dict(
        kind=LEDGER_KIND,
        schema_version=LEDGER_SCHEMA_VERSION,
        run_kind=str(run_kind),
        fingerprint=config_fingerprint(config),
        config=dict(config),
        git_rev=git_revision(),
        backend=backend,
        written_at=time.time(),  # repro: allow[R6] -- wall-clock provenance
        headline={k: _as_jsonable(v) for k, v in dict(headline).items()},
    )
    if watch:
        rec["watch"] = dict(watch)
    if counters is not None:
        rec["counters"] = {
            k: _as_jsonable(v) for k, v in counters.snapshot().items()
        }
        rec["metrics"] = counters.metrics.snapshot()
    if attribution is not None:
        rec["attribution"] = attribution
    if extra:
        rec.update(extra)
    return rec


def _as_jsonable(v):
    if isinstance(v, (bool, int, float, str)) or v is None:
        return v
    try:
        return float(v)   # numpy scalars and friends
    except (TypeError, ValueError):
        return str(v)


def validate_record(rec: Dict) -> List[str]:
    """Return a list of schema problems (empty = valid)."""
    errs = []
    if not isinstance(rec, dict):
        return ["record is not a JSON object"]
    for key in REQUIRED_FIELDS:
        if key not in rec:
            errs.append(f"missing required field {key!r}")
    if errs:
        return errs
    if rec["kind"] != LEDGER_KIND:
        errs.append(f"kind is {rec['kind']!r}, expected {LEDGER_KIND!r}")
    if rec["schema_version"] != LEDGER_SCHEMA_VERSION:
        errs.append(f"unknown schema_version {rec['schema_version']!r}")
    if not isinstance(rec["run_kind"], str) or not rec["run_kind"]:
        errs.append("run_kind must be a non-empty string")
    if not isinstance(rec["config"], dict):
        errs.append("config must be an object")
    if not isinstance(rec["fingerprint"], str) or len(rec["fingerprint"]) < 8:
        errs.append("fingerprint must be a hash string")
    elif isinstance(rec["config"], dict) \
            and rec["fingerprint"] != config_fingerprint(rec["config"]):
        errs.append("fingerprint does not match the config it claims to hash")
    if not isinstance(rec["headline"], dict):
        errs.append("headline must be an object")
    if not isinstance(rec.get("watch", {}), dict):
        errs.append("watch must be an object when present")
    else:
        bad = {d for d in rec.get("watch", {}).values()
               if d not in ("lower", "higher")}
        if bad:
            errs.append(f"watch directions must be lower/higher, got {bad}")
    return errs


def resolve_path(rec: Dict, dotted: str):
    """Dotted-path lookup into a record; bare names (no dot, or not found
    at top level) default into ``headline`` — ``series(kind, "wall_s")``
    and ``series(kind, "headline.wall_s")`` are the same query."""
    def walk(doc, parts):
        for p in parts:
            if not isinstance(doc, dict) or p not in doc:
                return None
            doc = doc[p]
        return doc

    v = walk(rec, dotted.split("."))
    if v is None and not dotted.startswith("headline."):
        v = walk(rec, ["headline"] + dotted.split("."))
    return v


class RunLedger:
    """Append/query interface over one ``.jsonl`` ledger file.

    ``append`` validates then writes one line atomically (lock + single
    ``write`` on an append-mode handle). Queries re-read the file each call
    — ledgers are small (one line per run) and readers must see appends
    from other processes.
    """

    def __init__(self, path: str):
        self.path = str(path)
        self._lock = threading.Lock()

    # ------------------------------------------------------------- writing
    def append(self, record: Dict) -> Dict:
        errs = validate_record(record)
        if errs:
            raise LedgerSchemaError(
                f"refusing to ledger record: {'; '.join(errs)}"
            )
        line = json.dumps(record, sort_keys=True, default=_as_jsonable)
        if "\n" in line:
            raise LedgerSchemaError("record serializes to multiple lines")
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        with self._lock:
            # one write of one terminated line on O_APPEND: concurrent
            # appenders (even cross-process) interleave whole records
            with open(self.path, "a") as f:
                f.write(line + "\n")
        return record

    # ------------------------------------------------------------- reading
    def records(self, run_kind: Optional[str] = None) -> List[Dict]:
        """All records oldest-first, optionally filtered by ``run_kind``.
        Unparseable lines raise — a torn ledger should fail loudly, not be
        silently skipped over."""
        if not os.path.exists(self.path):
            return []
        out = []
        with open(self.path) as f:
            for i, line in enumerate(f):
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError as e:
                    raise LedgerSchemaError(
                        f"{self.path}:{i + 1}: unparseable ledger line ({e})"
                    )
                if run_kind is None or rec.get("run_kind") == run_kind:
                    out.append(rec)
        return out

    def latest(self, run_kind: str) -> Optional[Dict]:
        recs = self.records(run_kind)
        return recs[-1] if recs else None

    def run_kinds(self) -> List[str]:
        return sorted({r.get("run_kind", "?") for r in self.records()})

    def series(
        self, run_kind: str, metric: str,
        fingerprint: Optional[str] = None,
    ) -> List[float]:
        """The metric's value across this kind's records (oldest-first),
        skipping records where it is absent/non-numeric. ``metric`` is a
        dotted path (``headline.wall_s``, ``counters.storage_read_ops``,
        ``metrics.serve\\.lookup_seconds`` won't work — registry names
        contain dots, use ``resolve_path`` on records directly for those);
        bare names default into ``headline``. ``fingerprint`` restricts to
        records of one config."""
        out = []
        for rec in self.records(run_kind):
            if fingerprint and rec.get("fingerprint") != fingerprint:
                continue
            v = resolve_path(rec, metric)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                out.append(float(v))
        return out
