"""Live telemetry: background sampler, Prometheus text export, HTTP endpoint.

The tracer and metrics registry answer "what happened?" after a run
exports; this module answers "what is happening RIGHT NOW?" during one.
Three pieces:

- :class:`LiveSampler` — a daemon thread (``repro_torch.core.threads.spawn``,
  join-bounded on stop) polling :meth:`MetricsRegistry.snapshot` every
  ``interval_s`` into bounded per-metric ring time-series (queue depth,
  inflight bytes, cache bytes, pool free bytes, slow-lane flag, ...), and
  optionally logging a one-line status summary every ``log_every_s`` so a
  wedged pipeline in an hour-long soak is visible within seconds instead of
  at epoch end. Not constructing a sampler costs nothing; a constructed but
  never-started sampler allocates no thread (pinned by test).
- :func:`to_prometheus_text` / :func:`parse_prometheus_text` — render a
  registry snapshot in the Prometheus text exposition format (counters,
  gauges, histogram summaries with quantile labels) and parse it back
  (round-trip pinned by test).
- :class:`TelemetryServer` — an optional stdlib ``http.server`` endpoint
  (``--telemetry-port`` on the launchers) serving ``GET /metrics`` so a
  real Prometheus (or ``curl``) can scrape a long-running training job.

Thread discipline: the sampler/HTTP threads are spawned through
``repro_torch.core.threads`` (imported lazily — ``repro_torch.obs`` must
stay import-cycle-free below ``repro_torch.core``) and never touch hot
paths; polling cost is one registry snapshot per tick (callback gauges are
only evaluated here, exactly as at any other snapshot).
"""
from __future__ import annotations

import logging
import re
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

LOG = logging.getLogger("repro_torch.obs.live")

DEFAULT_INTERVAL_S = 0.5
DEFAULT_HISTORY = 720   # per-metric samples retained (~6 min at the default)

_PROM_PREFIX = "repro_"
_PROM_NAME_BAD = re.compile(r"[^a-zA-Z0-9_]")
_HIST_QUANTILES = (("0.5", "p50"), ("0.99", "p99"))


def prometheus_name(name: str) -> str:
    """``storage.io_queue_depth`` -> ``repro_storage_io_queue_depth`` (the
    registry's ``<subsystem>.<name>`` grammar maps 1:1 onto Prometheus's
    underscore convention; anything else is sanitized)."""
    return _PROM_PREFIX + _PROM_NAME_BAD.sub("_", name)


def to_prometheus_text(snapshot: Dict) -> str:
    """Render a :meth:`MetricsRegistry.snapshot` dict as Prometheus text
    exposition (version 0.0.4). Scalar metrics become untyped samples;
    histogram dicts become a summary: ``_count``/``_sum`` plus
    ``{quantile="0.5"|"0.99"}`` sample lines."""
    lines: List[str] = []
    for name in sorted(snapshot):
        v = snapshot[name]
        pname = prometheus_name(name)
        if isinstance(v, dict):   # histogram snapshot
            lines.append(f"# TYPE {pname} summary")
            for q, key in _HIST_QUANTILES:
                lines.append(
                    f'{pname}{{quantile="{q}"}} {_fmt(v.get(key, 0.0))}'
                )
            lines.append(f"{pname}_sum {_fmt(v.get('sum', 0.0))}")
            lines.append(f"{pname}_count {_fmt(v.get('count', 0))}")
        else:
            lines.append(f"# TYPE {pname} gauge")
            lines.append(f"{pname} {_fmt(v)}")
    return "\n".join(lines) + "\n"


def _fmt(v) -> str:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "NaN"
    if f != f:
        return "NaN"
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def parse_prometheus_text(text: str) -> Dict[str, float]:
    """Parse exposition text back into ``{name_or_name{labels}: value}`` —
    the round-trip check the exporter test pins (and a convenient assert
    for anyone scraping the endpoint in tests)."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            key, val = line.rsplit(None, 1)
        except ValueError:
            raise ValueError(f"unparseable exposition line: {line!r}")
        out[key] = float(val)
    return out


class LiveSampler:
    """Poll the registry into bounded ring time-series on a daemon thread.

    ``counters`` is a :class:`repro_torch.core.counters.Counters`; each tick
    appends ``(t_rel_s, value)`` per scalar metric (histograms contribute
    their ``count``) into a ``deque(maxlen=history)``. ``log_every_s``
    additionally emits a one-line status on the ``repro_torch.obs.live`` logger.
    """

    def __init__(
        self,
        counters,
        interval_s: float = DEFAULT_INTERVAL_S,
        history: int = DEFAULT_HISTORY,
        log_every_s: Optional[float] = None,
    ):
        self.counters = counters
        self.interval_s = max(0.01, float(interval_s))
        self.history = max(2, int(history))
        self.log_every_s = log_every_s
        self._series: Dict[str, deque] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = None
        self._t0 = time.perf_counter()
        self._last_log = 0.0
        self.ticks = 0

    # ------------------------------------------------------------ lifecycle
    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "LiveSampler":
        if self._thread is not None:
            return self
        from repro_torch.core.threads import spawn  # lazy: avoid obs->core cycle

        self._stop.clear()
        self._t0 = time.perf_counter()
        self._thread = spawn("obs-live-sampler", self._run)
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        if self._thread is None:
            return
        from repro_torch.core.threads import join_bounded

        self._stop.set()
        join_bounded(self._thread, timeout_s, counters=self.counters,
                     what="live sampler thread")
        self._thread = None

    def __enter__(self) -> "LiveSampler":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

    # ------------------------------------------------------------- sampling
    def _run(self) -> None:
        # first poll immediately so short runs still record a sample
        while True:
            self.poll_once()
            if self._stop.wait(self.interval_s):
                return

    def poll_once(self) -> Dict[str, float]:
        """One sampling tick (also callable inline from tests): snapshot
        the registry, append to the rings, maybe log a status line."""
        t = time.perf_counter() - self._t0
        snap = self.counters.metrics.snapshot()
        flat: Dict[str, float] = {}
        for name, v in snap.items():
            if isinstance(v, dict):
                flat[name + ".count"] = float(v.get("count", 0))
            else:
                try:
                    flat[name] = float(v)
                except (TypeError, ValueError):
                    continue
        with self._lock:
            for name, value in flat.items():
                ring = self._series.get(name)
                if ring is None:
                    ring = self._series[name] = deque(maxlen=self.history)
                ring.append((t, value))
            self.ticks += 1
        if (
            self.log_every_s is not None
            and t - self._last_log >= self.log_every_s
        ):
            self._last_log = t
            LOG.info(self.status_line())
        return flat

    # -------------------------------------------------------------- reading
    def series(self, name: str) -> List[Tuple[float, float]]:
        with self._lock:
            ring = self._series.get(name)
            return list(ring) if ring else []

    def latest(self) -> Dict[str, float]:
        with self._lock:
            return {
                name: ring[-1][1]
                for name, ring in self._series.items() if ring
            }

    def to_prometheus_text(self) -> str:
        return to_prometheus_text(self.counters.metrics.snapshot())

    def status_line(self) -> str:
        """One line of load-bearing live state for long-soak logs."""
        c = self.counters.snapshot()
        m = self.counters.metrics.snapshot()

        def g(name, default=0.0):
            v = m.get(name, default)
            return v if isinstance(v, (int, float)) else default

        hits, misses = c.get("cache_hits", 0), c.get("cache_misses", 0)
        total = hits + misses
        hit_s = f"{100.0 * hits / total:.1f}%" if total else "n/a"
        return (
            f"live t={time.perf_counter() - self._t0:.1f}s "
            f"io_q={g('storage.io_queue_depth'):.0f} "
            f"inflight={g('storage.io_inflight_bytes') / 1e6:.2f}MB "
            f"cache_hit={hit_s} "
            f"read={c.get('storage_read_paged_bytes', 0) / 1e6:.1f}MB "
            f"write={c.get('storage_write_paged_bytes', 0) / 1e6:.1f}MB "
            f"retries={g('io.retries'):.0f} "
            f"slow_lane={g('io.slow_lane'):.0f} "
            f"trace_drops={g('trace.dropped_events'):.0f}"
        )


class TelemetryServer:
    """``GET /metrics`` over stdlib ``http.server`` on a daemon thread.

    ``port=0`` binds an ephemeral port (read it back from ``.port`` — tests
    use this). The handler snapshots the registry per request; there is no
    per-request state, so the threading server needs no extra locking."""

    def __init__(self, counters, port: int = 0, host: str = "127.0.0.1"):
        self.counters = counters
        self._httpd = None
        self._thread = None
        self.host = host
        self.port = int(port)

    def start(self) -> "TelemetryServer":
        if self._httpd is not None:
            return self
        import http.server

        from repro_torch.core.threads import spawn  # lazy: avoid obs->core cycle

        counters = self.counters

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):          # noqa: N802 (stdlib API name)
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_error(404)
                    return
                body = to_prometheus_text(
                    counters.metrics.snapshot()
                ).encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type", "text/plain; version=0.0.4"
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):
                LOG.debug("telemetry http: " + fmt, *args)

        class Server(http.server.ThreadingHTTPServer):
            """Each request's thread comes from ``spawn`` and is kept, so
            that ``stop`` can join it: ``ThreadingMixIn`` tracks no daemon
            request thread, and ``server_close`` would return while the
            last request's thread still runs."""

            daemon_threads = True

            def __init__(self, *args):
                super().__init__(*args)
                self.handlers: List[threading.Thread] = []
                self.handlers_lock = threading.Lock()

            def process_request(self, request, client_address):
                t = spawn("obs-telemetry-request",
                          self.process_request_thread,
                          args=(request, client_address), start=False)
                with self.handlers_lock:
                    self.handlers = [h for h in self.handlers
                                     if h.is_alive()] + [t]
                t.start()

        self._httpd = Server((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = spawn("obs-telemetry-http", self._httpd.serve_forever)
        LOG.info("telemetry endpoint: http://%s:%d/metrics",
                 self.host, self.port)
        return self

    def stop(self, timeout_s: float = 5.0) -> None:
        if self._httpd is None:
            return
        from repro_torch.core.threads import join_bounded

        self._httpd.shutdown()       # no request is taken after this
        self._httpd.server_close()
        with self._httpd.handlers_lock:
            handlers = list(self._httpd.handlers)
        join_bounded([self._thread] + handlers, timeout_s,
                     counters=self.counters, what="telemetry http thread")
        self._httpd = self._thread = None

    def __enter__(self) -> "TelemetryServer":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
