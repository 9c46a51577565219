"""The port's live telemetry (``repro_torch.obs.live``) and the launchers'
``--telemetry-port`` / ``--ledger``, on the CPU.

- ``to_prometheus_text`` renders the same text as the reference's for the
  same snapshot (a port ``Counters`` registry after a pipelined engine
  epoch, and a synthetic one with histograms, NaN and off-grammar names),
  and ``parse_prometheus_text`` reads it back as the reference's does;
- the ``LiveSampler``: bounded rings, a never-started sampler allocates no
  thread, start/stop/restart leaves no thread behind;
- a ``TelemetryServer`` on an ephemeral port serves ``GET /metrics`` after a
  pipelined epoch whose byte counters equal ``Counters.snapshot()``'s, and
  404 elsewhere;
- ``launch.train --offload`` and ``launch.infer`` with ``--device cpu
  --telemetry-port 0 --ledger PATH``: exit 0, the endpoint was up over the
  run (scraped just before it stopped: its byte counters are the ledger
  record's), and one valid record of the launcher's run kind with backend
  ``"cpu"``.
"""
import http.server
import math
import socketserver
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from repro.obs import live as jlive

from repro_torch.core.cache import HostCache
from repro_torch.core.counters import Counters
from repro_torch.core.engine import SSOEngine
from repro_torch.core.storage import StorageTier
from repro_torch.graph.synthetic import random_features, random_labels
from repro_torch.obs import live
from repro_torch.obs.ledger import RunLedger, validate_record
from repro_torch.obs.live import (
    LiveSampler, TelemetryServer, parse_prometheus_text, prometheus_name,
    to_prometheus_text,
)

DIMS = [24, 32, 8]


def pipelined_epoch(c: Counters):
    """One pipelined (depth 2) GCN epoch on the launcher's smoke graph, on
    the CPU, accounted in ``c``."""
    import torch

    from repro_torch.launch.infer import _smoke_graph
    from repro_torch.models.gnn.layers import get_gnn
    from repro_torch.runtime import PipelineConfig

    g, plan = _smoke_graph(2000, 7, 6, "cpu")
    spec = get_gnn("gcn")
    X = random_features(g.n_nodes, DIMS[0], 0)[plan.ro.perm]
    Y = random_labels(g.n_nodes, DIMS[-1], 0)[plan.ro.perm]
    params = spec.init(torch.Generator().manual_seed(0), DIMS[0], DIMS[1],
                       DIMS[-1], 2, device="cpu")
    st = StorageTier(tempfile.mkdtemp(), counters=c)
    eng = SSOEngine(spec, plan, DIMS, st, HostCache(1 << 20, st, c), c,
                    pipeline=PipelineConfig(depth=2), device="cpu")
    try:
        eng.initialize(X)
        eng.run_epoch(params, Y)
    finally:
        eng.close()
        st.close()


def byte_fields(snap):
    return sorted(k for k in snap if k.endswith("_bytes"))


@pytest.fixture(scope="module")
def epoch_counters():
    c = Counters()
    pipelined_epoch(c)
    return c


def synthetic_snapshot():
    return {
        "storage.io_queue_depth": 3, "io.slow_lane": 0.0,
        "cache.used_bytes": 123456789012, "weird-name.x": 1.5,
        "trace.ring_occupancy": 0.25, "nan.gauge": float("nan"),
        "big.int": 2 ** 53, "neg": -7,
        "serve.lookup_seconds": {"count": 5, "sum": 0.0123, "p50": 0.001,
                                 "p99": 0.004, "min": 0.0005, "max": 0.005},
        "empty.hist": {"count": 0, "sum": 0.0},
    }


@pytest.mark.parametrize("which", ["epoch", "synthetic"])
def test_prometheus_text_equals_reference(epoch_counters, which):
    snap = (epoch_counters.metrics.snapshot() if which == "epoch"
            else synthetic_snapshot())
    text = to_prometheus_text(snap)
    assert text == jlive.to_prometheus_text(snap)
    parsed = parse_prometheus_text(text)
    want = jlive.parse_prometheus_text(text)
    assert parsed.keys() == want.keys()
    for k in parsed:
        assert parsed[k] == want[k] or (math.isnan(parsed[k])
                                        and math.isnan(want[k]))
    if which == "epoch":
        for f in byte_fields(epoch_counters.snapshot()):
            assert parsed[f"repro_counters_{f}"] == getattr(epoch_counters, f)


@pytest.mark.parametrize("name", ["storage.io_queue_depth", "io.slow_lane",
                                  "weird-name.x", "counters.h2d_bytes", ""])
def test_prometheus_name_equals_reference(name):
    assert prometheus_name(name) == jlive.prometheus_name(name)


def test_parse_rejects_an_unparseable_line():
    with pytest.raises(ValueError, match="unparseable"):
        parse_prometheus_text("lonely_token_without_value\n")


def test_live_sampler_rings_bounded_and_latest():
    c = Counters()
    g = c.metrics.gauge("test.depth")
    s = LiveSampler(c, history=4)
    for i in range(10):
        g.set(float(i))
        s.poll_once()
    assert s.ticks == 10
    ring = s.series("test.depth")
    assert [v for _, v in ring] == [6.0, 7.0, 8.0, 9.0]
    assert [t for t, _ in ring] == sorted(t for t, _ in ring)
    c.metrics.histogram("test.lat").observe(0.5)
    c.bump("h2d_bytes", 4096)
    s.poll_once()
    assert s.latest()["test.lat.count"] == 1.0
    assert s.latest()["counters.h2d_bytes"] == 4096.0
    assert s.series("never.registered") == []
    assert "io_q=" in s.status_line() and "cache_hit=" in s.status_line()


def test_live_sampler_never_started_allocates_no_thread():
    before = threading.active_count()
    s = LiveSampler(Counters())
    assert s.running is False and s._thread is None
    assert threading.active_count() == before
    s.stop()                                   # stop on never-started: no-op
    assert s.running is False


def test_live_sampler_start_stop_lifecycle():
    c = Counters()
    before = threading.active_count()
    with LiveSampler(c, interval_s=0.01) as s:
        assert s.running
        assert any(t.name == "obs-live-sampler" for t in threading.enumerate())
        deadline = time.perf_counter() + 5.0
        while s.ticks < 3 and time.perf_counter() < deadline:
            time.sleep(0.005)
        assert s.ticks >= 3
    assert not s.running
    assert threading.active_count() == before
    assert c.threads_leaked == 0
    s.start()                                  # restartable after stop
    assert s.running
    s.stop()
    assert not s.running and threading.active_count() == before


def scrape(port: int) -> dict:
    url = f"http://127.0.0.1:{port}/metrics"
    with urllib.request.urlopen(url, timeout=10) as resp:
        assert resp.status == 200
        assert resp.headers["Content-Type"].startswith("text/plain")
        return parse_prometheus_text(resp.read().decode())


def test_telemetry_server_byte_counters_after_a_pipelined_epoch():
    c = Counters()
    before = threading.active_count()
    with TelemetryServer(c, port=0) as srv:
        assert srv.port > 0
        pipelined_epoch(c)
        parsed = scrape(srv.port)
        snap = c.snapshot()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/nope",
                                   timeout=10)
    assert snap["h2d_bytes"] > 0 and snap["storage_read_bytes"] > 0
    for f in byte_fields(snap):
        assert parsed[f"repro_counters_{f}"] == snap[f], f
    assert c.threads_leaked == 0
    assert threading.active_count() == before


def test_telemetry_server_stop_joins_every_request_thread(monkeypatch):
    """``stop`` returns with no request thread alive: 20 requests, the
    last a 404, then ``stop``, 50 times in a row. The 404's thread lingers
    until the server's socket has closed, and 20 ms more, so a ``stop``
    that does not join it returns while it is alive."""
    closed = threading.Event()
    close = http.server.ThreadingHTTPServer.server_close
    finish = socketserver.StreamRequestHandler.finish

    def server_close(self):
        close(self)
        closed.set()

    def slow_finish(self):
        finish(self)
        if getattr(self, "path", "") == "/nope":
            closed.wait(5)
            time.sleep(0.02)

    monkeypatch.setattr(http.server.ThreadingHTTPServer, "server_close",
                        server_close)
    monkeypatch.setattr(socketserver.StreamRequestHandler, "finish",
                        slow_finish)
    before = threading.active_count()
    for _ in range(50):
        closed.clear()
        c = Counters()
        srv = TelemetryServer(c, port=0).start()
        for _ in range(19):
            scrape(srv.port)
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/nope",
                                   timeout=10)
        srv.stop()
        assert threading.active_count() == before
        assert c.threads_leaked == 0


@pytest.fixture()
def scrapes(monkeypatch):
    """Every TelemetryServer's last scrape, taken just before it stops."""
    seen = []
    stop = TelemetryServer.stop

    def scrape_then_stop(self, timeout_s=5.0):
        if self._httpd is not None:
            seen.append(scrape(self.port))
        stop(self, timeout_s)

    monkeypatch.setattr(live.TelemetryServer, "stop", scrape_then_stop)
    return seen


@pytest.mark.parametrize("launcher,argv,run_kind,watch", [
    ("train", ["--arch", "gcn-cora", "--offload"], "train_offload_smoke",
     {"wall_s": "lower"}),
    ("infer", ["--arch", "gcn-cora"], "infer_smoke",
     {"wall_s": "lower", "p99_ms": "lower"}),
])
def test_launcher_telemetry_port_and_ledger_on_cpu(tmp_path, scrapes,
                                                   launcher, argv, run_kind,
                                                   watch):
    from repro_torch.launch import infer, train

    path = str(tmp_path / "runs" / "ledger.jsonl")
    main = train.main if launcher == "train" else infer.main
    with pytest.raises(SystemExit) as ei:
        main(argv + ["--device", "cpu", "--telemetry-port", "0",
                     "--ledger", path])
    assert ei.value.code == 0
    (rec,) = RunLedger(path).records()
    assert validate_record(rec) == []
    assert rec["run_kind"] == run_kind and rec["backend"] == "cpu"
    assert rec["watch"] == watch
    assert np.isfinite(rec["headline"]["wall_s"])
    (parsed,) = scrapes                   # one server, over the depth-2 run
    fields = byte_fields(rec["counters"])
    assert rec["counters"]["h2d_bytes"] > 0
    for f in fields:
        assert parsed[f"repro_counters_{f}"] == rec["counters"][f], f
