"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line.

Everything a cell is made of is found by name (see ``perfbench/__init__``);
this module holds only what every cell shares: the inputs made from the
seed, the program's graph and plan, its weights, the window, the counters'
deltas, the traced run and the per-layer readers.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
REPO = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path):
    return json.loads(Path(path).read_text())


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX
    package's (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# --------------------------------------------------------------- the cell
@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench if bench is not None else load_json(REPO / "BENCHMARK.json")
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cfg = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def mine(metric, e2e):
        cells = metric.get("workloads")
        if cells is not None:
            return name in cells
        return e2e is None or metric["moves"] in e2e

    e2e = [m for m in bench["end_to_end"] if mine(m, None)]
    names = {m["name"] for m in e2e}
    return Cell(
        name=name, chips=cell["chips"],
        config=load_json(REPO / cfg["file"]),
        traffic=load_json(BENCH_DIR / "workloads" / f"{cell['traffic']}.json"),
        limits=load_json(BENCH_DIR / "limits" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=[m for m in bench["per_layer"] if mine(m, names)],
    )


def metric_reader(name: str):
    """``read(ctx)`` of ``metrics/<name>.py``."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ------------------------------------------------------------ the inputs
@dataclasses.dataclass
class Inputs:
    """What the benchmark makes from the seed and hands to both sides, in
    the generator's node order."""
    indptr: np.ndarray
    indices: np.ndarray
    x: np.ndarray                      # float32 (n, d_in)
    y: np.ndarray                      # int32 (n,)
    weights: Dict[str, "object"]       # "<layer>.<name>" -> float32 tensor

    @property
    def n_nodes(self) -> int:
        return self.indptr.shape[0] - 1


def make_inputs(config: dict, traffic: dict, seed: int, device) -> Inputs:
    """The R-MAT graph of the traffic's ``structure_seed`` (numpy; the
    same in every run), then on ``device`` from a ``torch.Generator``
    seeded with ``seed``: features N(0, 1), labels uniform over the
    classes and every weight in one draw."""
    import torch

    from perfbench.reference import family
    from perfbench.rmat import rmat_graph

    g = traffic["graph"]
    indptr, indices = rmat_graph(config["n_nodes"], config["avg_degree"],
                                 g["structure_seed"], g["a"], g["b"], g["c"])
    n, dims = config["n_nodes"], config["dims"]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randn((n, dims[0]), generator=gen, device=device)
    y = torch.randint(0, dims[-1], (n,), generator=gen, device=device)
    init = family(config["model"]).param_init(config)
    flat = torch.randn((sum(math.prod(s) for _, s, _ in init),),
                       generator=gen, device=device)
    weights, off = {}, 0
    for key, shape, scale in init:
        k = math.prod(shape)
        weights[key] = (flat[off:off + k] * scale).reshape(shape)
        off += k
    return Inputs(indptr, indices, x.cpu().numpy(),
                  y.to(torch.int32).cpu().numpy(), weights)


# ----------------------------------------------------------- the program
def program_graph(config: dict, traffic: dict, inputs: Inputs, device,
                  timings: Dict[str, float]):
    """The program's partition and plan of the inputs' graph:
    ``switching_aware_partition`` at its defaults but the traffic's
    ``partition_seed`` and ``build_plan`` (with the program's GCN edge
    weights where the configuration asks for them). Returns ``(plan,
    parts)``."""
    from repro_torch.core.plan import build_plan
    from repro_torch.graph.csr import CSRGraph, gcn_norm_coeffs
    from repro_torch.graph.partition import switching_aware_partition

    g = CSRGraph(indptr=inputs.indptr, indices=inputs.indices,
                 n_nodes=inputs.n_nodes)
    t0 = time.perf_counter()
    res = switching_aware_partition(g, config["n_parts"],
                                    seed=traffic["graph"]["partition_seed"])
    t1 = time.perf_counter()
    ew = gcn_norm_coeffs(g) if config.get("edge_weight") == "gcn_norm" \
        else None
    plan = build_plan(g, res.parts, config["n_parts"], edge_weight=ew,
                      device=device)
    timings["partition_s"] = t1 - t0
    timings["build_plan_s"] = time.perf_counter() - t1
    return plan, res.parts


def program_params(config: dict, inputs: Inputs, device):
    """The program's layers (``spec.init`` on the meta device, then
    materialised on ``device``) holding the inputs' weights."""
    import torch

    from repro_torch.models.gnn.layers import get_gnn

    dims = config["dims"]
    params = get_gnn(config["model"]).init(
        torch.Generator(), dims[0], dims[1], dims[-1], len(dims) - 1,
        device="meta").to_empty(device=device)
    have = {f"{i}.{k}": p for i, layer in enumerate(params)
            for k, p in layer.named_parameters()}
    if set(have) != set(inputs.weights):
        raise RuntimeError(f"the program's parameters {sorted(have)} are not "
                           f"the reference's {sorted(inputs.weights)}")
    with torch.no_grad():
        for k, p in have.items():
            p.copy_(inputs.weights[k])
    return params


def pipeline_config(traffic: dict):
    from repro_torch.runtime import PipelineConfig

    return PipelineConfig(**traffic.get("pipeline", {}))


def program_storage(traffic: dict):
    """``(counters, storage, cache)``: the storage tier in a fresh directory
    under ``TMPDIR`` and the traffic's host cache over it."""
    from repro_torch.core.cache import HostCache
    from repro_torch.core.counters import Counters
    from repro_torch.core.storage import StorageTier

    c = Counters()
    st = StorageTier(tempfile.mkdtemp(prefix="perfbench-"), counters=c)
    return c, st, HostCache(traffic["cache_mb"] << 20, st, c)


def snapshot(counters) -> dict:
    return dict(fields={f.name: getattr(counters, f.name)
                        for f in dataclasses.fields(counters)},
                busy=dict(counters.stage_busy_seconds),
                stall=dict(counters.stage_stall_seconds))


# ------------------------------------------------------ per-layer readers
class Context:
    """What a per-layer reader (``metrics/<name>.py``) reads: the window's
    counter deltas per step, the traced window and the yardstick's
    arithmetic. A reader returns None where it finds nothing to read."""

    def __init__(self, entry: str, steps: int, window_s: float,
                 before: dict, after: dict, timings: Dict[str, float],
                 trace: Optional[dict], launches: dict, step_flops: float,
                 peaks: Optional[dict]):
        self.entry = entry
        self.steps = steps
        self.window_s = window_s
        self.step_s = window_s / steps
        self._b, self._a = before, after
        self.timings = timings
        self.trace = trace
        self.launches = launches
        self.step_flops = step_flops
        self.peaks = peaks

    def per_step(self, field: str) -> float:
        return (self._a["fields"][field] - self._b["fields"][field]) \
            / self.steps

    def busy_per_step(self, *stages: str) -> float:
        return sum(self._a["busy"].get(s, 0.0) - self._b["busy"].get(s, 0.0)
                   for s in stages) / self.steps

    def stall_per_step(self, prefix: str) -> float:
        return sum(v - self._b["stall"].get(k, 0.0)
                   for k, v in self._a["stall"].items()
                   if k.startswith(prefix)) / self.steps

    def idle_pct(self) -> Optional[float]:
        if not self.trace or self.trace["window_s"] <= 0:
            return None
        return 100.0 * (1.0 - self.trace["busy_s"] / self.trace["window_s"])

    def mfu_pct(self) -> Optional[float]:
        if not self.peaks or self.trace is None:
            return None
        return 100.0 * self.step_flops / self.step_s \
            / self.peaks["float32_flops_per_s"]

    def roofline_pct(self, kernel: str) -> Optional[float]:
        """The kernel's bytes over the card's bandwidth, over its device
        time in the traced window; None when the trace does not hold
        exactly the launches the plan predicts."""
        from perfbench.devtrace import kernel_time

        if not self.peaks or self.trace is None or kernel not in self.launches:
            return None
        n, sec = kernel_time(self.trace, kernel)
        want, nbytes = self.launches[kernel]
        if n != want * self.steps or sec <= 0:
            print(f"perfbench: {kernel}: {n} launches traced, the plan "
                  f"predicts {want * self.steps}; no roofline", file=sys.stderr)
            return None
        return 100.0 * nbytes * self.steps / self.peaks["hbm_bytes_per_s"] \
            / sec


# ----------------------------------------------------------------- a run
def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float) -> dict:
    """One run of ``cell`` on ``device``; returns the result line's dict."""
    import torch

    from perfbench import compare
    from perfbench.devtrace import DeviceTrace, HostSpans
    from perfbench.yardstick import kernel_launches, peaks_for, step_flops

    on_card = device.type == "cuda"
    # the configurations state float32: no TF32 in the program's matmuls
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    entry_kind = cell.traffic["entry"]
    entry = importlib.import_module(f"perfbench.entries.{entry_kind}").Entry(
        cell.config, cell.traffic, seed, device)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    entry.timings["start_s"] = time.perf_counter() - t_start
    entry.setup()
    if on_card:
        torch.cuda.synchronize(device)
    before = snapshot(entry.counters)
    dt = DeviceTrace() if trace and on_card else None
    if dt is not None:
        spans = HostSpans(entry.counters)
        dt.start()
        spans.start()
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    steps, marks = 0, [t0]
    while True:
        entry.step()
        steps += 1
        marks.append(time.perf_counter())
        if marks[-1] - t0 >= seconds:
            break
    window_s = marks[-1] - t0
    summary = None
    if dt is not None:
        host = spans.stop()
        dt.stop()
        summary = dt.summary(host)
    after = snapshot(entry.counters)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    plan, dims = entry.plan, cell.config["dims"]
    ctx = Context(entry_kind, steps, window_s, before, after, entry.timings,
                  summary, kernel_launches(plan, dims, entry_kind),
                  step_flops(cell.config, entry_kind, plan.n_nodes,
                             int(plan.ro.graph.n_edges)),
                  peaks_for(kind))
    entry.close()
    if on_card:
        torch.cuda.empty_cache()
    numbers = entry.check()
    correct, checks = compare.judge(numbers, cell.limits)

    metrics = {}
    if trace:
        for m in cell.per_layer:
            val = metric_reader(m["name"])(ctx)
            if val is not None:
                metrics[m["name"]] = {"value": val, "unit": m["unit"]}
    else:
        e2e = {entry.e2e: window_s / steps, "setup_s": setup_s}
        for m in cell.end_to_end:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu", "kind": kind,
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": steps, "failed": 0,
           "metrics": metrics, "device": dev}
    if summary is not None:
        dev["busy_s"] = summary["busy_s"]
        dev["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["card"] = power_limit() if on_card else None
    out["setup"] = dict(entry.timings, setup_s=setup_s, window_s=window_s,
                        steps=steps, step_s=np.diff(marks).tolist(),
                        storage_write_bytes=after["fields"][
                            "storage_write_bytes"])
    out["checks"] = checks
    return out
