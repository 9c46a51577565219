"""Where the compute thread's time goes, and the card's time per pass.

:class:`LoopClock` partitions the compute thread's wall inside
``SSOEngine.run_epoch`` and ``OffloadedInference.run`` into named states.
Each :meth:`LoopClock.lap` charges the time since the previous lap to one
state: ``Counters.loop_<state>_ns`` always (one ``perf_counter_ns`` read and
one locked add), and a ``loop:<state>`` span on ``Counters.tracer`` when the
tracer is on. The states:

- ``launch`` — building and enqueuing a unit's device work: the wait on its
  staged inputs' event, the layer's forward, vjp or loss, the D2H enqueue;
- ``sync`` — blocked on the card: a synchronous result copy, a D2H event's
  ``synchronize``, the loss scalar;
- ``scatter`` — the ∇A write-back (``SSOEngine._grad_accumulate``);
- ``write`` — bypass writes and retire submits, their backpressure stalls
  included;
- ``barrier`` — layer boundaries: a pipelined stream's set-up (its stage
  threads started) and teardown (joined), write drains, cache drops, file
  frees and allocations;
- ``fetch`` — pipeline stages the compute thread runs itself: the serial
  stream's gather and aux fetch, and a unit's H2D staging when there is no
  transfer stage;
- ``residual`` — adding a unit's side-input cotangent (GCNII's ∇H^0) into
  its partition's grad buffer.

The wait for the next unit of a pipelined stream is not a state: the
``compute_wait_*`` stalls of :meth:`PipelineExecutor.run_stream` account
it, and the stream moves the mark past it (:meth:`LoopClock.mark`). What
no state or stall covers is the remainder.

:class:`DeviceClock` brackets each unit's device work with a pair of CUDA
events on the compute stream: the start after the wait on its inputs (when
they have landed), the end after its last kernel, before the D2H enqueue.
It is armed for a run only with the tracer on and a CUDA device; the pairs
resolve at the end of the run (one event ``synchronize``) into
``device_fwd_ns`` / ``device_loss_ns`` / ``device_bwd_ns``. Disarmed, it
builds no event.
"""
from __future__ import annotations

import time
from typing import List, Tuple

import torch

from repro_torch.core.counters import Counters

LOOP_STATES = ("launch", "sync", "scatter", "write", "barrier", "fetch",
               "residual")
DEVICE_PASSES = ("fwd", "loss", "bwd")


class LoopClock:
    """Lap timer of one compute thread (see the module docstring)."""

    def __init__(self, counters: Counters):
        self.counters = counters
        self._t = time.perf_counter_ns()

    def mark(self) -> None:
        """Set the mark without charging: the start of a run, or past a
        wait that a ``compute_wait_*`` stall accounts."""
        self._t = time.perf_counter_ns()

    def lap(self, state: str) -> None:
        """Charge the time since the last mark to ``state``."""
        t = time.perf_counter_ns()
        dt = t - self._t
        self._t = t
        c = self.counters
        c.bump(f"loop_{state}_ns", dt)
        if c.tracer.enabled:
            c.tracer.complete(f"loop:{state}", dt * 1e-9, t_end=t * 1e-9)


class DeviceClock:
    """CUDA-event pairs around each unit's device work (see the module
    docstring). Events come from a pool and go back to it once read."""

    def __init__(self, counters: Counters, device: torch.device):
        self.counters = counters
        self.device = device
        self.armed = False
        self._free: List = []
        self._pairs: List[Tuple[str, object, object]] = []
        self._open = None

    def arm(self) -> None:
        """At the start of a run: time its units if the tracer is on and
        the device is a CUDA card. Drops pairs a faulted run left."""
        self.armed = (self.device.type == "cuda"
                      and self.counters.tracer.enabled)
        for _, a, b in self._pairs:
            self._free += [a, b]
        self._pairs.clear()
        self._open = None

    def _record(self):
        ev = (self._free.pop() if self._free
              else torch.cuda.Event(enable_timing=True))
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def start(self) -> None:
        """After the unit's wait on its inputs, before its first kernel."""
        if self.armed:
            self._open = self._record()

    def stop(self, which: str) -> None:
        """After the unit's last kernel of pass ``which``, before its D2H
        enqueue."""
        if self.armed and self._open is not None:
            self._pairs.append((which, self._open, self._record()))
            self._open = None

    def resolve(self) -> None:
        """At the end of a run: wait for the last event, add each pair's
        elapsed time to its pass's field, and return the events to the
        pool."""
        if not self._pairs:
            return
        self._pairs[-1][2].synchronize()
        tot = dict.fromkeys(DEVICE_PASSES, 0)
        for which, a, b in self._pairs:
            tot[which] += round(a.elapsed_time(b) * 1e6)   # ms -> ns
            self._free += [a, b]
        self._pairs.clear()
        self.counters.bump_many(**{f"device_{k}_ns": v
                                   for k, v in tot.items() if v})
