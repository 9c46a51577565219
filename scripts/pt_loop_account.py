#!/usr/bin/env python3
"""Where a benchmark cell's step goes, from the program's own account, on
the card.

    python3 scripts/pt_loop_account.py --cells gcn-igbm-3l.train_spill \\
        --seed 4271000001 [--rounds 3] [--profiled 2] [--out FILE]

For each cell of ``BENCHMARK.json``: the benchmark's set-up
(``perfbench/entries/<entry>.py``: inputs from the seed, the program's
graph, plan, engine and checked steps), then ``4 * rounds`` steps with the
program's tracer off and on in turns (off, on, on, off, ...). Each step is
timed as the harness times it (``run_epoch`` + AdamW, or ``run``, then a
device synchronise), and its ``run_epoch`` / ``run`` alone; beside them, the
run's compute-loop states (``Counters.loop_*_ns``), its ``compute_wait_*``
stalls, and what closes or not: ``closes`` = (states + waits) / run. Then
``profiled`` traced steps under ``torch.profiler``: the device brackets
(``device_*_ns``) beside the kernel time inside the run's window (memory
copies and the ``scatter_add`` kernels apart), and the card's idle time
inside the run split by what the compute thread was doing: each
``loop:<state>`` span and ``stall:compute_wait_*`` span of the program's
tracer (``perfbench.devtrace.HostSpans``) against the complement of the
profiler's device intervals. One JSON object a line. Needs one CUDA card and
``nvcc``.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "src")]

STATES = ("launch", "sync", "scatter", "write", "barrier", "fetch")
FIELDS = [f"loop_{s}_ns" for s in STATES] + [
    "device_fwd_ns", "device_loss_ns", "device_bwd_ns", "storage_read_ns",
    "storage_read_bytes", "host_copy_ns", "host_gather_bytes",
    "gather_cpu_ns", "gather_nivcsw", "gather_majflt"]
MARK = "loop_account_mark"


def snap(c) -> dict:
    f = {k: getattr(c, k) for k in FIELDS}
    f["wait_s"] = sum(v for k, v in c.stage_stall_seconds.items()
                      if k.startswith("compute_wait"))
    f["gather_busy_s"] = sum(c.stage_busy_seconds.get(k, 0.0)
                             for k in ("gather", "regather"))
    return f


def delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a}


def run_once(entry, kind: str):
    """The cell's run_epoch (with its gradients) or run."""
    if kind == "train":
        return entry.engine.run_epoch(entry.params, entry.y)
    entry.engine.run(entry.params)
    return None


def finish(entry, kind: str, out, dev) -> None:
    """The rest of the harness's step: AdamW, then a device synchronise."""
    import torch

    from repro_torch import optim

    if kind == "train":
        entry.params, entry.opt = optim.adamw_update(
            out[1], entry.params, entry.opt, **entry.optim)
    torch.cuda.synchronize(dev)


def _union(iv):
    """Merged, sorted ``[start, end)`` intervals."""
    out = []
    for a, b in sorted(iv):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def device_account(prof, mark_ns: int, r0: int, r1: int, spans) -> dict:
    """The run ``[r0, r1)`` (``perf_counter_ns``) on the profiler's clock:
    device time by kind, and the card's idle time inside it by the compute
    thread's span (``spans``: ``[(name, t0_ns, t1_ns)]`` on
    ``perf_counter_ns``)."""
    import numpy as np
    import torch

    evs = prof.profiler.kineto_results.events()
    mark = next(e for e in evs if e.name() == MARK
                and e.device_type() != torch.autograd.DeviceType.CUDA)
    off = mark.start_ns() - mark_ns
    w0, w1 = r0 + off, r1 + off
    by = dict(kernel=0, scatter_add=0, memcpy=0)
    iv = []
    for e in evs:
        if e.device_type() != torch.autograd.DeviceType.CUDA \
                or e.name() == MARK:
            continue
        s, d, name = e.start_ns(), e.duration_ns(), e.name()
        if s + d > w0 and s < w1:
            iv.append((max(s, w0), min(s + d, w1)))
        if not w0 <= s < w1:
            continue
        if name.startswith(("Memcpy", "Memset")):
            by["memcpy"] += d
        elif "scatter_add" in name:
            by["scatter_add"] += d
        else:
            by["kernel"] += d
    busy = _union(iv)
    edges = [w0] + [t for ab in busy for t in ab] + [w1]
    idle = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    idle_by = {}
    for name, a, b in spans:
        if not name.startswith(("loop:", "stall:compute_wait")):
            continue
        key = name if name.startswith("loop:") else "compute_wait"
        ov = np.clip(np.minimum(idle[:, 1], b + off)
                     - np.maximum(idle[:, 0], a + off), 0, None).sum()
        idle_by[key] = idle_by.get(key, 0) + int(ov)
    idle_s = float((idle[:, 1] - idle[:, 0]).sum()) / 1e9
    return ({k: v / 1e9 for k, v in by.items()}
            | {"window_s": (w1 - w0) / 1e9, "device_idle_s": idle_s,
               "idle_by_state_s": {k: v / 1e9 for k, v in idle_by.items()}})


def account_cell(name: str, seed: int, rounds: int, profiled: int, dev,
                 emit) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from perfbench import harness
    from perfbench.devtrace import HostSpans
    from repro_torch.obs import NULL_TRACER, Tracer

    cell = harness.load_cell(name)
    kind = cell.traffic["entry"]
    entry = importlib.import_module(f"perfbench.entries.{kind}").Entry(
        cell.config, cell.traffic, seed, dev)
    t0 = time.perf_counter()
    entry.setup()
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    c = entry.counters
    try:
        for i, traced in enumerate([False, True, True, False] * rounds):
            c.tracer = Tracer() if traced else NULL_TRACER
            a = snap(c)
            t0 = time.perf_counter()
            out = run_once(entry, kind)
            run_s = time.perf_counter() - t0
            finish(entry, kind, out, dev)
            step_s = time.perf_counter() - t0
            d = delta(a, snap(c))
            c.tracer = NULL_TRACER
            loop_s = sum(d[f"loop_{s}_ns"] for s in STATES) / 1e9
            emit(dict(cell=name, step=i, traced=traced, setup_s=setup_s,
                      step_s=step_s, run_s=run_s, loop_s=loop_s,
                      closes=(loop_s + d["wait_s"]) / run_s,
                      remainder_s=run_s - loop_s - d["wait_s"], **d))
        for i in range(profiled):
            hs = HostSpans(c)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                torch.cuda.synchronize(dev)
                with record_function(MARK):
                    pass
                mark_ns = time.perf_counter_ns()
                hs.start()
                a = snap(c)
                r0 = time.perf_counter_ns()
                out = run_once(entry, kind)
                r1 = time.perf_counter_ns()
                finish(entry, kind, out, dev)
                d = delta(a, snap(c))
                spans = hs.stop()
            ks = device_account(prof, mark_ns, r0, r1, spans)
            brackets = (d["device_fwd_ns"] + d["device_loss_ns"]
                        + d["device_bwd_ns"]) / 1e9
            emit(dict(cell=name, profiled=i, device_brackets_s=brackets,
                      brackets_over_kernels=brackets / ks["kernel"]
                      if ks["kernel"] > 0 else None, **ks, **d))
    finally:
        c.tracer = NULL_TRACER
        entry.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cells", required=True,
                    help="comma-separated cells of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rounds", type=int, default=3,
                    help="rounds of off, on, on, off steps")
    ap.add_argument("--profiled", type=int, default=2)
    ap.add_argument("--out", default=None, help="also append lines here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("pt_loop_account: needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # the configurations state float32: no TF32, as in the harness
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sink = open(args.out, "a") if args.out else None

    def emit(rec: dict) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        if sink is not None:
            sink.write(line + "\n")
            sink.flush()

    try:
        for name in args.cells.split(","):
            account_cell(name, args.seed, args.rounds, args.profiled, dev,
                         emit)
            torch.cuda.empty_cache()
    finally:
        if sink is not None:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
