"""The traced run: ``torch.profiler`` over the measured window, reduced to
device busy time, each kernel's device time and launch count, the device
operations that took most time, and the device's idle gaps named by what
the host was doing: the program's own span tracer (``Counters.tracer``,
``repro_torch.obs.Tracer``), which records every pipeline stage's busy
interval and every stall, is switched on for the window
(:class:`HostSpans`).

Profiler timestamps and ``time.perf_counter_ns`` are put on one clock by a
marker recorded with both at the window's start; the tracer's timestamps
by a marker event recorded into it.
"""
from __future__ import annotations

import re
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np

MIN_GAP_NS = 200_000        # idle gaps shorter than 0.2 ms are not named
LABELLED_GAPS = 500         # the longest gaps that are named one by one


class HostSpans:
    """The program's span tracer on ``counters`` for the measured window:
    :meth:`start` puts a recording ``Tracer`` in place of the no-op one,
    :meth:`stop` puts the no-op one back and returns the spans as
    ``[(name, t0_ns, t1_ns)]`` on ``time.perf_counter_ns``."""

    def __init__(self, counters):
        self.counters = counters
        self._tracer = None
        self._mark_ns = 0

    def start(self) -> None:
        from repro_torch.obs import Tracer

        self._tracer = Tracer()
        self._tracer.instant("perfbench_mark")
        self._mark_ns = time.perf_counter_ns()
        self.counters.tracer = self._tracer

    def stop(self) -> List[Tuple[str, int, int]]:
        from repro_torch.obs import NULL_TRACER

        self.counters.tracer = NULL_TRACER
        evs = self._tracer.events()
        mark = next(e["ts"] for e in evs if e["name"] == "perfbench_mark")
        base = self._mark_ns - int(mark * 1e3)
        return [(e["name"], base + int(e["ts"] * 1e3),
                 base + int((e["ts"] + e["dur"]) * 1e3))
                for e in evs if e["ph"] == "X"]


def _short(name: str) -> str:
    """A kernel's name without its return type and arguments."""
    short = re.sub(r"^void\s+", "", name.replace("(anonymous namespace)::", ""))
    return short.split("(", 1)[0].split("<", 1)[0].strip() or name


def _union(iv: np.ndarray) -> np.ndarray:
    """Merged ``(start, end)`` intervals, sorted."""
    if not len(iv):
        return iv
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out, dtype=np.int64)


class DeviceTrace:
    """Profile the block between :meth:`start` and :meth:`stop`."""

    def __init__(self):
        self._prof = None
        self._offset = 0
        self.t0_ns = self.t1_ns = 0

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        t = time.perf_counter_ns()
        with record_function("perfbench_mark"):
            pass
        self._mark_perf = t
        torch.cuda.synchronize()
        self.t0_ns = time.perf_counter_ns()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1_ns = time.perf_counter_ns()
        self._prof.__exit__(None, None, None)

    def summary(self, spans: List[Tuple[str, int, int]]) -> dict:
        """``busy_s``, ``window_s``, ``kernels`` ({short name: [count,
        seconds]}), ``device_ops`` and ``idle_gaps`` (top 10 each)."""
        import torch

        evs = self._prof.profiler.kineto_results.events()
        mark = next((e for e in evs if e.name() == "perfbench_mark"), None)
        offset = (mark.start_ns() - self._mark_perf) if mark else 0
        w0, w1 = self.t0_ns + offset, self.t1_ns + offset
        iv, by_name = [], defaultdict(lambda: [0, 0])
        for e in evs:
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                continue
            s, d = e.start_ns(), e.duration_ns()
            s, t = max(s, w0), min(s + d, w1)
            if t <= s:
                continue
            iv.append((s, t))
            rec = by_name[_short(e.name())]
            rec[0] += 1
            rec[1] += (t - s) / 1e9
        busy = _union(np.asarray(iv, dtype=np.int64).reshape(-1, 2))
        busy_s = float((busy[:, 1] - busy[:, 0]).sum()) / 1e9 if len(busy) \
            else 0.0
        ops = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
        return dict(
            busy_s=busy_s,
            window_s=(w1 - w0) / 1e9,
            kernels={k: v for k, v in by_name.items()},
            device_ops=[[k, v[1]] for k, v in ops],
            idle_gaps=self._gaps(busy, w0, w1, spans, offset),
        )

    @staticmethod
    def _gaps(busy: np.ndarray, w0: int, w1: int,
              spans: List[Tuple[str, int, int]], offset: int) -> list:
        """Idle time summed by the name of the host span that overlaps each
        gap most (``host_other`` where none covers a tenth of it)."""
        edges = np.concatenate([[w0], busy.ravel() if len(busy) else [], [w1]])
        gaps = edges.reshape(-1, 2)
        gaps = gaps[gaps[:, 1] - gaps[:, 0] >= MIN_GAP_NS]
        order = np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")
        named, rest = gaps[order[:LABELLED_GAPS]], gaps[order[LABELLED_GAPS:]]
        kinds = defaultdict(list)
        for kind, t0, t1 in spans:
            kinds[kind].append((t0 + offset, t1 + offset))
        kinds = {k: np.asarray(v, dtype=np.int64) for k, v in kinds.items()}
        total: Dict[str, float] = defaultdict(float)
        for g0, g1 in named:
            best, best_ov = "host_other", 0.1 * (g1 - g0)
            for k, iv in kinds.items():
                ov = np.clip(np.minimum(iv[:, 1], g1) - np.maximum(iv[:, 0], g0),
                             0, None).sum()
                if ov > best_ov:
                    best, best_ov = k, ov
            total[best] += (g1 - g0) / 1e9
        if len(rest):
            total["short_gaps"] += float((rest[:, 1] - rest[:, 0]).sum()) / 1e9
        return [[k, v] for k, v in sorted(total.items(),
                                          key=lambda kv: -kv[1])[:10]]


def kernel_time(summary: Optional[dict], kernel: str):
    """``(launches, seconds)`` of the device kernels whose name holds
    ``kernel`` (the vector and scalar variants together)."""
    n, s = 0, 0.0
    for name, (cnt, sec) in (summary or {}).get("kernels", {}).items():
        if kernel in name:
            n += cnt
            s += sec
    return n, s
