"""Span tracer with Chrome/Perfetto ``trace_event`` export.

The measurement substrate for the pipeline-tuning work (ROADMAP items 3–4):
every runtime stage — prefetch / gather workers, the H2D transfer and D2H
retire threads, the ``StorageIOQueue`` service thread, write-behind, and the
compute loop — records named, thread-attributed spans into one bounded
in-memory ring, and :meth:`Tracer.export_chrome_trace` renders the whole
pipelined epoch as a zoomable timeline in ``ui.perfetto.dev`` (or
``chrome://tracing``).

Three recording shapes:

- :meth:`Tracer.span` — a ``with``-scoped span on the current thread
  (Chrome ``"X"`` complete event);
- :meth:`Tracer.complete` — an after-the-fact span for code that already
  timed itself (``Counters.record_busy`` bridges every pipeline stage's
  busy interval through this, so any stage that reports busy time
  automatically appears on the timeline);
- :meth:`Tracer.begin` / :meth:`Tracer.end` — an async span that may START
  on one thread and END on another (Chrome ``"b"``/``"e"`` events keyed by
  an id): the runtime uses these for per-unit lifetimes, prefetch-start →
  compute-consumed, which is what makes the pipeline depth visible.

Plus :meth:`Tracer.instant` (point events, e.g. cache evictions) and
:meth:`Tracer.counter` (counter tracks, e.g. the host-cache byte timeline).

Hot-path discipline: the ring is a ``deque(maxlen=...)`` — appending drops
the oldest event instead of growing (``dropped`` counts the evictions) — and
the DISABLED tracer does no work at all: ``span()`` returns a shared no-op
singleton (no allocation) and every other recorder early-returns after one
attribute check (pinned by tests). Components reach the tracer through
``Counters.tracer``, which defaults to the module-level :data:`NULL_TRACER`.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Optional


class _NullSpan:
    """Shared no-op context manager returned by a disabled tracer's
    ``span()`` — one module-level instance, so the disabled path allocates
    nothing per call."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self._tracer = tracer
        self._name = name
        self._args = args

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tracer._emit("X", self._name, self._t0, t1 - self._t0,
                           self._args)
        return False


class Tracer:
    """Thread-safe bounded-ring span recorder.

    Timestamps are ``time.perf_counter`` relative to the tracer's creation
    (same clock as every runtime stall/busy measurement), exported in the
    microseconds Chrome's ``trace_event`` format expects.
    """

    def __init__(self, enabled: bool = True, ring_events: int = 1 << 18):
        self.enabled = bool(enabled)
        self._ring: deque = deque(maxlen=max(1, int(ring_events)))
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()
        self._thread_names: dict = {}   # tid -> name at first event
        self.dropped = 0                # events evicted from the full ring

    # ------------------------------------------------------------- recording
    def _emit(self, ph: str, name: str, t_start: float, dur_s: float = 0.0,
              args: Optional[dict] = None, uid=None) -> None:
        if not self.enabled:
            return
        tid = threading.get_ident()
        ts = (t_start - self._t0) * 1e6
        with self._lock:
            if tid not in self._thread_names:
                self._thread_names[tid] = threading.current_thread().name
            if len(self._ring) == self._ring.maxlen:
                self.dropped += 1
            self._ring.append((ph, name, ts, dur_s * 1e6, tid, args, uid))

    def span(self, name: str, **args):
        """``with tracer.span("gather", part=3):`` — an ``"X"`` span on the
        current thread, emitted when the block exits."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, args or None)

    def complete(self, name: str, dur_s: float, t_end: Optional[float] = None,
                 args: Optional[dict] = None) -> None:
        """Record an already-measured span that ENDED at ``t_end`` (now, if
        omitted) and lasted ``dur_s`` seconds — the bridge for code that
        times itself (``Counters.record_busy`` / ``record_phase``)."""
        if not self.enabled:
            return
        t1 = time.perf_counter() if t_end is None else t_end
        self._emit("X", name, t1 - dur_s, dur_s, args)

    def begin(self, name: str, uid, **args) -> None:
        """Open an async span keyed by ``(name, uid)``; :meth:`end` may run
        on a DIFFERENT thread (the pipeline's per-unit lifetime spans)."""
        if not self.enabled:
            return
        self._emit("b", name, time.perf_counter(), 0.0, args or None, uid)

    def end(self, name: str, uid) -> None:
        if not self.enabled:
            return
        self._emit("e", name, time.perf_counter(), 0.0, None, uid)

    def instant(self, name: str, **args) -> None:
        """A zero-duration point event (e.g. a cache eviction)."""
        if not self.enabled:
            return
        self._emit("i", name, time.perf_counter(), 0.0, args or None)

    def counter(self, name: str, value) -> None:
        """A sample on a counter track (rendered as a graph in Perfetto,
        e.g. host-cache resident bytes over time)."""
        if not self.enabled:
            return
        self._emit("C", name, time.perf_counter(), 0.0, {"value": value})

    # --------------------------------------------------------------- reading
    @property
    def events_recorded(self) -> int:
        return len(self._ring)

    @property
    def ring_capacity(self) -> int:
        return self._ring.maxlen or 0

    @property
    def ring_occupancy(self) -> float:
        """Fill fraction of the bounded ring (1.0 = at capacity, i.e. the
        next event evicts the oldest) — exported as the
        ``trace.ring_occupancy`` registry gauge."""
        cap = self._ring.maxlen or 0
        return len(self._ring) / cap if cap else 0.0

    def events(self) -> list:
        """Snapshot of the ring as dicts (test/introspection helper; the
        canonical output is :meth:`export_chrome_trace`)."""
        with self._lock:
            ring = list(self._ring)
        return [
            dict(ph=ph, name=name, ts=ts, dur=dur, tid=tid,
                 args=args, id=uid)
            for ph, name, ts, dur, tid, args, uid in ring
        ]

    def clear(self) -> None:
        """Drop all recorded events (e.g. after a warmup epoch); thread
        names persist so later events still resolve."""
        with self._lock:
            self._ring.clear()
            self.dropped = 0

    # ---------------------------------------------------------------- export
    def export_chrome_trace(self, path: str) -> str:
        """Write the ring as Chrome ``trace_event`` JSON (the object form:
        ``{"traceEvents": [...]}``) loadable by ``ui.perfetto.dev``.

        Every event carries ``name``/``ph``/``ts``/``pid``/``tid``;
        ``"X"`` events add ``dur``; async ``"b"``/``"e"`` pairs share a
        string ``id``. Thread names are attached via ``"M"`` metadata
        events so the pipeline threads (``sso-prefetch``, ``sso-gather-N``,
        ``sso-h2d``, ``sso-d2h``, ``sso-io``, main) label their tracks.
        """
        pid = os.getpid()
        with self._lock:
            ring = list(self._ring)
            tnames = dict(self._thread_names)
            dropped = self.dropped
        evs = [dict(ph="M", name="process_name", pid=pid, tid=0,
                    args=dict(name="sso-runtime")),
               # self-describing truncation: a reader (or the artifact
               # lint) can tell a short run from a ring that wrapped
               # without consulting anything outside the file
               dict(ph="M", name="trace_ring", pid=pid, tid=0,
                    args=dict(dropped_events=dropped,
                              ring_capacity=self._ring.maxlen or 0,
                              events_exported=len(ring),
                              truncated=dropped > 0))]
        for tid in sorted(tnames):
            evs.append(dict(ph="M", name="thread_name", pid=pid, tid=tid,
                            args=dict(name=tnames[tid])))
        for ph, name, ts, dur, tid, args, uid in ring:
            ev = dict(ph=ph, name=name, cat="sso", pid=pid, tid=tid,
                      ts=round(ts, 3))
            if ph == "X":
                ev["dur"] = round(dur, 3)
            elif ph in ("b", "e"):
                ev["id"] = str(uid)
            elif ph == "i":
                ev["s"] = "t"   # thread-scoped instant
            if args:
                ev["args"] = dict(args)
            evs.append(ev)
        payload = {
            "traceEvents": evs,
            "displayTimeUnit": "ms",
            "otherData": {"dropped_events": dropped},
        }
        with open(path, "w") as f:
            json.dump(payload, f)
        return path


#: Shared disabled tracer — the default ``Counters.tracer``. All recording
#: methods early-return; ``span()`` hands back the no-op singleton.
NULL_TRACER = Tracer(enabled=False, ring_events=1)
