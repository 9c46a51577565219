"""The ∇A write-back's ``scatter_add`` at a benchmark cell's shapes, on the
card: the kernel adding in place in page-locked host buffers through their
mapped address (the engine's path), beside the round trip it replaced
(each pair's whole pageable buffer copied to the card, added, copied back)
and the same kernel on device copies of the buffers (HBM).

    python3 scripts/pt_write_back.py [--cell gat-igbm-3l.train_resident]
        [--seed 1] [--rounds 3]

Builds the cell's graph and partition plan as ``perfbench`` does and takes
every (unit, source partition) pair of one write-back layer (the width
``dims[1]``) whose rows are not one contiguous run. Per layer pass: the
in-place launches timed with CUDA events, queued back to back (median of
``--rounds``); the round trip through ``KernelDispatch.scatter_add_rows``
on pageable buffers, host clock with a synchronise; the device-copy
launches queued. Beside them: the link's rate each way (a 256 MB pinned
copy), the link bound (each touched base row read and written once over
the link) and the HBM bound of the old kernel (the yardstick's bytes at
3.35 TB/s). The three results are compared bitwise. One JSON line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "src")]


def _link_gbps(dev) -> dict:
    import torch

    n = 256 << 20
    host = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    card = torch.empty(n, dtype=torch.uint8, device=dev)
    out = {}
    for name, dst, src in (("h2d", card, host), ("d2h", host, card)):
        dst.copy_(src, non_blocking=True)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        a.record()
        for _ in range(4):
            dst.copy_(src, non_blocking=True)
        b.record()
        b.synchronize()
        out[name] = 4 * n / (a.elapsed_time(b) * 1e-3) / 1e9
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="gat-igbm-3l.train_resident")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from perfbench import harness
    from repro_torch.kernels.dispatch import KernelDispatch, _contiguous_run
    from repro_torch.kernels.gather_scatter import ops
    from repro_torch.runtime.pinned import page_locked_empty

    dev = torch.device("cuda", 0)
    cell = harness.load_cell(args.cell)
    inputs = harness.make_inputs(cell.config, cell.traffic, args.seed, dev)
    plan, _ = harness.program_graph(cell.config, cell.traffic, inputs, dev,
                                    {})
    D = cell.config["dims"][1]
    rng = np.random.default_rng(args.seed)
    pairs = []     # (q, rows host, rows dev, values dev)
    for u in plan.units:
        ptr = u.req_part_ptr
        vals = torch.from_numpy(
            rng.standard_normal((u.n_req, D), dtype=np.float32)).to(dev)
        for q in u.req_parts:
            a0, _ = plan.ro.partition_slice(int(q))
            rows = (u.req_global[ptr[q]:ptr[q + 1]] - a0).astype(np.int32)
            if rows.size and not _contiguous_run(rows):
                pairs.append((int(q), rows, torch.from_numpy(rows).to(dev),
                              vals[ptr[q]:ptr[q + 1]]))
    sizes = {q: plan.ro.partition_slice(q) for q in range(plan.n_parts)}
    sizes = {q: (a1 - a0, D) for q, (a0, a1) in sizes.items()}
    locked = {q: page_locked_empty(s, np.float32) for q, s in sizes.items()}
    for buf in locked.values():
        buf.fill(0)
    on_card = {q: torch.zeros(s, device=dev) for q, s in sizes.items()}
    pageable = {q: np.zeros(s, np.float32) for q, s in sizes.items()}

    def timed(fn):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) * 1e-3

    def in_place():
        for q, _, rows, vals in pairs:
            ops.scatter_add_host_(torch.from_numpy(locked[q]), rows, vals)

    def device_copy():
        for q, _, rows, vals in pairs:
            ops.scatter_add_(on_card[q], rows, vals)

    kd = KernelDispatch("kernel", device=dev)
    host_vals = [v.cpu().numpy() for *_, v in pairs]

    def round_trip():
        t0 = time.perf_counter()
        for (q, rows, _, _), v in zip(pairs, host_vals):
            kd.scatter_add_rows(pageable[q], rows, v)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    in_place()
    device_copy()
    round_trip()      # warm: build, first touch
    t_in, t_dev, t_rt = [], [], []
    for _ in range(args.rounds):
        t_in.append(timed(in_place))
        t_dev.append(timed(device_copy))
        t_rt.append(round_trip())
    rounds = args.rounds + 1
    same = all(np.array_equal(locked[q], pageable[q])
               and np.array_equal(locked[q], on_card[q].cpu().numpy())
               for q in sizes)
    link = _link_gbps(dev)
    touched = sum(int(r.size) for _, r, _, _ in pairs)
    base_bytes = 4.0 * touched * D        # each way
    hbm = sum(3.0 * 4.0 * r.size * D + 4.0 * r.size for _, r, _, _ in pairs)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(json.dumps({
        "cell": args.cell, "card": smi, "width": D, "pairs": len(pairs),
        "rows": touched, "rounds": rounds, "bitwise_equal": same,
        "in_place_ms": 1e3 * statistics.median(t_in),
        "device_copy_ms": 1e3 * statistics.median(t_dev),
        "round_trip_ms": 1e3 * statistics.median(t_rt),
        "link_gbps": link,
        "link_bound_ms": 1e3 * max(base_bytes / (link["h2d"] * 1e9),
                                   base_bytes / (link["d2h"] * 1e9)),
        "hbm_bound_ms": 1e3 * hbm / 3.35e12,
        "launches": ops.LAUNCHES["scatter_add"],
        "page_locked_bytes": sum(b.nbytes for b in locked.values()),
    }))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
