"""The port's run ledger and regression sentinel
(``repro_torch.obs.{ledger,regress}``) against the reference's,
on the CPU — ``tests/test_ledger.py``'s cases, each as parametrised cases
that hold the port's answer against the reference's:

- fingerprints equal for equal configs (and key order), different for
  different values;
- ``validate_record`` gives the same errors for the same broken records,
  and ``RunLedger.append`` refuses them without writing;
- a port record (with the port's ``Counters``, backend ``"cpu"``) carries
  provenance, counters and metrics and validates; ledgers round-trip
  (records, latest, series, fingerprint filter, dotted paths) and a torn
  line raises; two threads appending never tear a line;
- the sentinel gives the same verdicts, bands and details on seeded series
  and on the same ledger file, and the same report payload.
"""
import json
import threading

import numpy as np
import pytest

from repro.obs import ledger as jledger
from repro.obs import regress as jregress

from repro_torch.core.counters import Counters
from repro_torch.obs.ledger import (
    LEDGER_KIND, LedgerSchemaError, RunLedger, config_fingerprint,
    make_record, resolve_path, validate_record,
)
from repro_torch.obs.regress import (
    REGRESSION, check_ledger, check_series, mad_sigma, median,
    report_payload,
)


def _record(config, headline, run_kind="bench_x", mk=make_record, **kw):
    kw.setdefault("watch", {k: "lower" for k in headline})
    return mk(run_kind, config, headline, **kw)


# ------------------------------------------------------------- fingerprints
@pytest.mark.parametrize("config", [
    {"nodes": 4000, "depth": 2}, {"depth": 2, "nodes": 4000},
    {"nodes": 4001, "depth": 2}, {}, {"dims": [1024, 256, 19], "f": 0.5},
    {"nested": {"b": 1, "a": [1, 2]}, "s": "x"},
])
def test_fingerprint_equals_reference(config):
    fp = config_fingerprint(config)
    assert fp == jledger.config_fingerprint(config)
    assert len(fp) == 16 and int(fp, 16) >= 0


def test_fingerprint_stable_and_value_sensitive():
    a = config_fingerprint({"nodes": 4000, "depth": 2})
    assert a == config_fingerprint({"depth": 2, "nodes": 4000})
    assert a != config_fingerprint({"nodes": 4001, "depth": 2})


# ----------------------------------------------------------------- refusals
def _broken(good):
    out = {f"strip_{k}": {x: v for x, v in good.items() if x != k}
           for k in ("fingerprint", "config", "headline", "run_kind",
                     "written_at", "kind", "schema_version")}
    out.update(
        forged=dict(good, config={"n": 2}),
        bad_watch=dict(good, watch={"wall_s": "sideways"}),
        watch_not_dict=dict(good, watch=["wall_s"]),
        bad_kind=dict(good, kind="other"),
        bad_version=dict(good, schema_version=99),
        empty_run_kind=dict(good, run_kind=""),
        short_fingerprint=dict(good, fingerprint="abc"),
        headline_not_dict=dict(good, headline=[1.0]),
        config_not_dict=dict(good, config=[1]),
        not_a_dict=[good],
    )
    return out


BROKEN = sorted(_broken(_record({"n": 1}, {"wall_s": 1.0})))


@pytest.mark.parametrize("case", BROKEN)
def test_validate_record_errors_equal_reference(tmp_path, case):
    rec = _broken(_record({"n": 1}, {"wall_s": 1.0}))[case]
    errs = validate_record(rec)
    assert errs and errs == jledger.validate_record(rec)
    led = RunLedger(str(tmp_path / "ledger.jsonl"))
    with pytest.raises((LedgerSchemaError, TypeError, AttributeError)):
        led.append(rec)
    assert not (tmp_path / "ledger.jsonl").exists()


def test_make_record_carries_provenance_and_port_counters():
    c = Counters()
    c.bump("cache_hits", 7)
    c.bump("h2d_bytes", 1 << 20)
    c.record_busy("gather", 0.25)
    rec = _record({"n": 1}, {"wall_s": 2.0}, counters=c, backend="cpu")
    assert rec["kind"] == LEDGER_KIND
    assert rec["fingerprint"] == config_fingerprint({"n": 1})
    assert rec["backend"] == "cpu"
    assert rec["counters"]["cache_hits"] == 7
    assert rec["counters"]["busy_gather"] == pytest.approx(0.25)
    assert rec["metrics"]["counters.h2d_bytes"] == 1 << 20
    assert validate_record(rec) == [] == jledger.validate_record(rec)
    json.dumps(rec)


def test_ledger_roundtrip_latest_series(tmp_path):
    led = RunLedger(str(tmp_path / "runs" / "ledger.jsonl"))  # parent mkdir
    for i, wall in enumerate((1.0, 1.1, 0.9)):
        led.append(_record({"n": 1}, {"wall_s": wall, "step": i}))
    led.append(_record({"n": 1}, {"qps": 50.0}, run_kind="bench_y"))
    led.append(_record({"n": 2}, {"wall_s": 99.0}))      # other config
    assert led.run_kinds() == ["bench_x", "bench_y"]
    assert len(led.records()) == 5
    assert led.latest("bench_x")["headline"]["wall_s"] == 99.0
    assert led.series("bench_x", "wall_s") == [1.0, 1.1, 0.9, 99.0]
    assert led.series("bench_x", "headline.wall_s",
                      fingerprint=config_fingerprint({"n": 1})) \
        == [1.0, 1.1, 0.9]
    assert led.latest("missing_kind") is None
    # the reference reads the port's file the same way
    jled = jledger.RunLedger(led.path)
    assert jled.records() == led.records()
    assert jled.series("bench_x", "wall_s") == led.series("bench_x", "wall_s")


@pytest.mark.parametrize("path", ["wall_s", "headline.wall_s", "soak.faults",
                                  "soak.nope", "headline", "config.n"])
def test_resolve_path_equals_reference(path):
    rec = _record({"n": 1}, {"wall_s": 3.0}, extra={"soak": {"faults": 5}})
    assert resolve_path(rec, path) == jledger.resolve_path(rec, path)


def test_records_raise_on_torn_line(tmp_path):
    path = str(tmp_path / "ledger.jsonl")
    led = RunLedger(path)
    led.append(_record({"n": 1}, {"wall_s": 1.0}))
    with open(path, "a") as f:
        f.write('{"kind": "repro-run", "truncat\n')
    with pytest.raises(LedgerSchemaError, match=":2:"):
        led.records()


def test_two_thread_append_no_torn_lines(tmp_path):
    led = RunLedger(str(tmp_path / "ledger.jsonl"))
    n_per_thread = 100

    def writer(tid):
        for i in range(n_per_thread):
            led.append(_record({"n": 1}, {"wall_s": 1.0, "tid": tid, "i": i}))

    threads = [threading.Thread(target=writer, args=(t,)) for t in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    recs = led.records()   # raises on any torn line
    assert len(recs) == 2 * n_per_thread
    assert all(validate_record(r) == [] for r in recs)
    assert len({(r["headline"]["tid"], r["headline"]["i"])
                for r in recs}) == 2 * n_per_thread


# ------------------------------------------------------------------ sentinel
def _series(seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "step":
        return list(1.0 + 0.02 * rng.standard_normal(20)), 1.30, "lower"
    if kind == "noise":
        return (list(1.0 + 0.02 * rng.standard_normal(20)),
                float(1.0 + 0.02 * rng.standard_normal()), "lower")
    if kind == "drop":
        return list(100.0 + 2.0 * rng.standard_normal(20)), 70.0, "higher"
    if kind == "flat":
        return [5.0] * 10, 5.0 + rng.uniform(0, 1), "lower"
    return [1.0, 1.1], 9.9, "lower"                       # cold start


@pytest.mark.parametrize("kind", ["step", "noise", "drop", "flat", "cold"])
@pytest.mark.parametrize("seed", [0, 1, 42])
def test_check_series_equals_reference(seed, kind):
    base, cur, direction = _series(seed, kind)
    got = check_series(base, cur, direction=direction).to_dict()
    want = jregress.check_series(base, cur, direction=direction).to_dict()
    assert got == want
    if kind in ("step", "drop"):
        assert got["verdict"] == REGRESSION


def test_check_series_rejects_bad_direction():
    with pytest.raises(ValueError, match="direction"):
        check_series([1.0] * 5, 1.0, direction="sideways")


@pytest.mark.parametrize("xs", [[], [3.0, 1.0, 2.0], [4.0, 1.0, 2.0, 3.0],
                                [5.0] * 9 + [500.0],
                                list(np.random.default_rng(7).normal(
                                    10.0, 3.0, 401))])
def test_median_and_mad_sigma_equal_reference(xs):
    assert median(xs) == jregress.median(xs)
    assert mad_sigma(xs) == jregress.mad_sigma(xs)


def _seed_ledger(path, walls, config=None, mk=make_record):
    for w in walls:
        RunLedger(path).append(_record(config or {"n": 1}, {"wall_s": w},
                                       mk=mk))


@pytest.mark.parametrize("walls", [
    [1.0, 1.02, 0.98, 1.01, 1.35],          # regression
    [1.0, 1.0, 1.0, 1.0, 1.5],
    [1.0, 1.0, 1.01],                       # cold start: skip
    [1.0, 1.02, 0.98, 1.01, 1.0],           # ok
])
def test_check_ledger_and_report_equal_reference(tmp_path, walls):
    path = str(tmp_path / "l.jsonl")
    _seed_ledger(path, walls)
    # another config's runs must not enter the baseline in either package
    _seed_ledger(path, [0.1, 0.1, 0.1], config={"n": 99})
    _seed_ledger(path, walls[-1:])
    RunLedger(path).append(make_record("quiet", {"n": 1}, {"wall_s": 1.0}))
    got = check_ledger(RunLedger(path))
    want = jregress.check_ledger(jledger.RunLedger(path))
    assert [r.to_dict() for r in got] == [r.to_dict() for r in want]
    assert report_payload(got, path, {"window": 20}) == \
        jregress.report_payload(want, path, {"window": 20})
