"""The readings that a cell's limits are set from, on the card at the
cell's own size:

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... \\
        --control-seeds 7,8,9

For each of ``--seeds`` the program's set-up (which for training runs the
checked steps) and the comparison with the float64 reference, as a run
makes them, with no measured window. For each of ``--control-seeds`` the
control: the reference in float32 with TF32 matmuls put in the program's
place; for training also two faults planted in the reference put in the
program's place: half the batch left out, and a state left unchanged (a
learning rate of 0). One JSON line a reading, with each checked step's
loss gap and every leaf's gaps for the look at what a number reads.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(REPO), str(REPO / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)

    import importlib

    import torch

    from perfbench import compare, harness, reference

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = harness.load_cell(args.workload)
    kind = cell.traffic["entry"]
    mod = importlib.import_module(f"perfbench.entries.{kind}")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = [int(s) for s in args.control_seeds.split(",") if s]

    def emit(**rec):
        print(json.dumps(dict(workload=cell.name, **rec)), flush=True)

    def leaves(prog, ref):
        """Each step's loss gap and every leaf's norm gaps (with the
        reference's first-gradient norm), worst first."""
        out = {"loss_steps": [abs(a - b) / abs(b) for a, b in
                              zip(prog["losses"], ref["losses"])]}
        for part in ("grad1", "change"):
            gaps = compare.leaf_gaps(prog[part], ref[part])
            out[part] = sorted(([k, g, ref["grad1"][k]] for k, g in
                                gaps.items()), key=lambda x: -x[1])
        return out

    for seed in seeds:
        t0 = time.perf_counter()
        entry = mod.Entry(cell.config, cell.traffic, seed, dev)
        entry.setup()
        t1 = time.perf_counter()
        entry.close()
        torch.cuda.empty_cache()
        if kind == "train":
            ref = entry.reference()
            emit(side="program", seed=seed,
                 numbers=compare.train_numbers(entry.readings(), ref),
                 worst=leaves(entry.readings(), ref), setup_s=t1 - t0,
                 check_s=time.perf_counter() - t1, timings=entry.timings)
        else:
            emit(side="program", seed=seed, numbers=entry.check(),
                 setup_s=t1 - t0, check_s=time.perf_counter() - t1,
                 timings=entry.timings)
        del entry
        torch.cuda.empty_cache()
    for seed in controls:
        inp = harness.make_inputs(cell.config, cell.traffic, seed, dev)
        if kind == "train":
            args_ = (cell.config, inp, cell.traffic["optimizer"],
                     cell.traffic["checked_steps"], dev)
            ref = reference.train_readings(*args_)
            ctl = reference.train_readings(*args_, dtype=torch.float32,
                                           tf32=True)
            emit(side="control", seed=seed,
                 numbers=compare.train_numbers(ctl, ref),
                 worst=leaves(ctl, ref))
            half = reference.train_readings(*args_, half_batch=True)
            emit(side="fault_half_batch", seed=seed,
                 numbers=compare.train_numbers(half, ref))
            still = reference.train_readings(
                args_[0], inp, dict(args_[2], lr=0.0), *args_[3:])
            emit(side="fault_state_unchanged", seed=seed,
                 numbers=compare.train_numbers(still, ref))
        else:
            ref = reference.embeddings(cell.config, inp, dev)
            ctl = reference.embeddings(cell.config, inp, dev,
                                       dtype=torch.float32, tf32=True)
            emit(side="control", seed=seed,
                 numbers=compare.table_numbers(ctl, ref))
        del inp
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
