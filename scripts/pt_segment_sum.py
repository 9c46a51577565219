#!/usr/bin/env python3
"""The chunk length of ``segment_sum`` on the card, on the benchmark graph.

    PYTHONPATH=src python scripts/pt_segment_sum.py [--chunks 256,512,1024,2048]

Builds the benchmark graph's plan (``chip_smoke.bench_plan``:
``perfbench/rmat.py`` at structure seed 0, 65,536 nodes, 16
switching-aware partitions, ``build_plan`` with its power-of-two padding)
and, on the card, rows of
``torch.Generator`` seed 0 for every unit at widths 1,024 and 256. Then,
for each chunk length K (``ops.SEGMENT_CHUNK`` set for the call) and for
``index_put_(accumulate=True)``, the device time of the segment sums of
one step (every kernel, copy and fill they run, by ``torch.profiler``) and
the host's time to queue them, in rounds a b ... b a:

- GCN (``gcn-igbm-3l``): every unit at widths 1,024, 256 and 256, the
  ``dst`` sum twice (the forward and the backward's recompute) and the
  ``src`` sum once (the edge gather's backward): 144 sums;
- GCNII (``gcnii-igbm-16l``): the same three sums a unit at 256 over 16
  layers: 768 sums.

``index_put_`` runs GCNII's once (13 s). Each K's outputs are bitwise the
committed K's on the segments both leave whole, and bitwise a rerun.
First, the first call in one sum that makes the host wait on the card
(``torch.cuda.set_sync_debug_mode``) and the host's time a call of its
parts; last, ``chip_smoke.phase_a_segment_sum``'s row. One JSON object a
line. Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
import traceback
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chunks", default="256,512,1024,2048")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pt_segment_sum: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from repro_torch.kernels.gather_scatter import ops

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    committed = ops.SEGMENT_CHUNK
    chunks = [int(k) for k in args.chunks.split(",")]
    plan = chip_smoke.bench_plan(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    xs = {}
    for u in plan.units:
        for d in (1024, 256):
            xs[u.p, d] = torch.randn((u.topo.dst.shape[0], d), generator=gen,
                                     device=dev)
    # (x, ids, n) of one step's sums
    gcn = [(xs[u.p, d], ids, n)
           for d in (1024, 256, 256) for u in plan.units
           for ids, n in ((u.topo.dst, u.topo.n_dst),
                          (u.topo.dst, u.topo.n_dst),
                          (u.topo.src, u.n_req))]
    gcnii = [(xs[u.p, 256], ids, n)
             for _ in range(16) for u in plan.units
             for ids, n in ((u.topo.dst, u.topo.n_dst),
                            (u.topo.dst, u.topo.n_dst),
                            (u.topo.src, u.n_req))]

    def library(x, ids, n):
        return x.new_zeros((n, x.shape[1])).index_put_(
            (ids.long(),), x, accumulate=True)

    def run(kind, sums):
        if kind == "index_put_":
            return [library(*s) for s in sums]
        ops.SEGMENT_CHUNK = kind
        try:
            return [ops.segment_sum(*s) for s in sums]
        finally:
            ops.SEGMENT_CHUNK = committed

    def device_ms(kind, sums):
        """Device ms of the step's sums (``torch.profiler``: every kernel,
        copy and fill they run), their host ms, and each kernel's ms."""
        from torch.profiler import ProfilerActivity, profile

        run(kind, sums[:3])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            outs = run(kind, sums)
            host = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
        del outs
        per = {}
        for e in prof.key_averages():
            t = getattr(e, "device_time_total", None)
            t = e.cuda_time_total if t is None else t
            if t > 0:
                per[e.key[:80]] = [e.count, round(t / 1e3, 3)]
        return sum(v[1] for v in per.values()), host, per

    # where the host waits: the first synchronising call in one sum
    x0, ids0, n0 = gcn[0]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops.segment_sum(x0, ids0, n0)
        print(json.dumps({"sync": None}), flush=True)
    except RuntimeError:
        print(json.dumps({"sync": traceback.format_exc()[-1500:]}),
              flush=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    # the host's cost of each part of one sum, us a call (100 calls)
    parts = {
        "sort": lambda: torch.sort(ids0, stable=True),
        "empty": lambda: torch.empty(n0 + 1, dtype=torch.int64, device=dev),
        "segment_sum": lambda: ops.segment_sum(x0, ids0, n0),
        "index_put_": lambda: library(x0, ids0, n0),
    }
    host_us = {}
    for name, fn in parts.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            fn()
        host_us[name] = (time.perf_counter() - t0) * 1e4
        torch.cuda.synchronize()
    print(json.dumps({"host_us_a_call": host_us}), flush=True)

    kinds = chunks + ["index_put_"]
    times = defaultdict(lambda: defaultdict(list))
    for _ in range(args.rounds):
        for kind in kinds + kinds[::-1]:
            for step, sums in (("gcn", gcn), ("gcnii", gcnii)):
                if kind == "index_put_" and step == "gcnii" and \
                        times[kind][step]:
                    continue          # 13 s a step: one reading is enough
                times[kind][step].append(device_ms(kind, sums))

    # bits: every K against the committed one on the segments both keep
    # whole, and a rerun
    want = run(committed, gcn[:48])
    for kind in kinds:
        line = {"chunk": kind}
        for step in ("gcn", "gcnii"):
            line[f"{step}_device_ms"] = [t[0] for t in times[kind][step]]
            line[f"{step}_host_ms"] = [round(t[1], 1)
                                       for t in times[kind][step]]
            line[f"{step}_median_ms"] = statistics.median(
                line[f"{step}_device_ms"])
        line["gcn_kernels_ms"] = times[kind]["gcn"][-1][2]
        if kind != "index_put_":
            got = run(kind, gcn[:48])
            same = True
            for (x, ids, n), a, b in zip(gcn[:48], got, want):
                deg = torch.bincount(ids.long(), minlength=n)
                whole = deg <= min(kind, committed)
                same &= bool(torch.equal(a[whole], b[whole]))
            line["whole_segments_equal_committed"] = same
            line["rerun_equal"] = all(
                torch.equal(a, b) for a, b in zip(run(kind, gcn[:48]), got))
            del got
        print(json.dumps(line), flush=True)
    del want
    del xs, gcn, gcnii, plan
    torch.cuda.empty_cache()
    row = chip_smoke.phase_a_segment_sum(dev)
    chip_smoke.print_row("segment_sum", row)
    print(json.dumps({"row": row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
