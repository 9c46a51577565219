"""Multi-pod dry run (the reference's ``launch/dryrun.py``): trace every
(arch x shape) on the production meshes over placeholder ranks and read
the roofline's terms from the trace.

Usage:
  python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all [--jobs 4] [--mesh both]
  python -m repro_torch.launch.dryrun --report            # summarize results dir

``--device cuda`` (the default) traces on the card's device type, ``cpu``
the CPU route (the kernels' plain versions), as the tests do.

Where the reference compiles each cell for 256 or 512 forced host devices,
the port starts the ``fake`` backend as rank 0 of 256 or 512 placeholder
ranks (``launch.mesh.init_placeholder_group``), builds the cell on
``make_production_mesh`` and runs ``built.fn`` once under
``FakeTensorMode``: every tensor has a shape, a dtype and a device and no
memory, and every collective returns at once. The trace is rank 0's view;
the step is one SPMD program, so rank 0 stands for every rank (a shard
that does not divide evenly is the largest, rank 0's, which the padded GNN
partitions and ``best_spec``'s divisible dims make the common case).

A ``"per_rank"`` step (the GNN steps) takes fake local shards and calls its
collectives itself. A ``"global"`` step (LM, recsys) takes ``DTensor``s
of its placements: DTensor's propagation and the ``constrain`` pins stand
in for GSPMD's. Every count is made on the local ops, below DTensor, so
each is per device.

Per cell the record keeps the reference's keys:

- ``memory``: per device. ``argument_bytes`` the local shards of the
  arguments, ``output_bytes`` the outputs' storages, ``alias_bytes`` those
  of them that are argument storages (a train step's parameters and
  optimizer state, updated in place, a decode step's cache),
  ``temp_bytes`` the rest of the peak of live storages, so that argument +
  output - alias + temp is the predicted peak; ``code_bytes`` 0.
- ``hlo_flops``: the FLOPs of the traced local ops by
  ``torch.utils.flop_counter``'s formulas (the matrix-product family, and
  the ``flash_attention`` and ``embedding_bag`` formulas their wrappers
  register). XLA's count also has the elementwise ops, so the port's is
  lower by those. ``flops_by_dtype`` splits it by the first input's dtype.
- ``hlo_bytes``: every local op's tensor inputs and outputs (views left
  out), unfused, so an upper bound on XLA's fused count.
- ``collectives`` / ``collective_counts``: output bytes and calls per
  collective (the functional collectives of DTensor's redistributions and
  the c10d collectives of the per-rank steps; send / recv as
  collective-permute); ``collective_bytes_by_dim`` the same bytes per mesh
  dim, weighted; ``collective_bytes`` their total, an all-reduce weighted
  x2 (``_COLL_FACTOR``).
- ``calibration``: None. The reference compiles two cut depths because
  XLA counts a scanned layer once; the port's layer loop is traced in
  full. For the same reason ``meta``'s attention correction, which stands
  in for the reference's undercounted attention scans, is kept in ``meta``
  and not added: the port's trace counts every attention block.
- ``model_flops``, ``useful_flops_ratio`` (``model_flops`` per device over
  ``hlo_flops``), ``meta``; ``local_ops``, the local ops traced.
- ``roofline``: ``t_compute`` the FLOPs of each dtype over the H100's peak
  for it (``launch.mesh``: bf16 989.4e12, float32 66.9e12 with TF32 off),
  ``t_memory`` ``hlo_bytes`` over 3.35e12 B/s, ``t_collective`` each mesh
  dim's weighted bytes over its link (every production-mesh dim crosses
  nodes: the NIC's 50e9 B/s), and ``dominant``.

Failures (no sharding strategy, a shape error) are bugs in the system:
they are recorded with their traceback, not skipped.
"""
from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import json
import logging
import os
import subprocess
import sys
import time
import traceback
import weakref
from collections import defaultdict
from typing import Dict, Optional

import torch
from torch import nn

from repro_torch.launch import mesh as meshlib

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

COLLECTIVE_OPS = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)
# ring/bidirectional cost multiplier on output bytes
_COLL_FACTOR = {
    "all-gather": 1.0, "all-reduce": 2.0, "reduce-scatter": 1.0,
    "all-to-all": 1.0, "collective-permute": 1.0,
}
# op name (namespace._c10d_functional / c10d) -> collective, and which of
# its arguments (or the output, -1) holds the bytes it delivers; a
# broadcast delivers what a gather of one shard would
_COLLECTIVES = {
    "all_gather_into_tensor": ("all-gather", -1),
    "all_gather_into_tensor_coalesced": ("all-gather", -1),
    "all_reduce": ("all-reduce", -1),
    "all_reduce_coalesced": ("all-reduce", -1),
    "reduce_scatter_tensor": ("reduce-scatter", -1),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", -1),
    "all_to_all_single": ("all-to-all", -1),
    "broadcast": ("all-gather", -1),
    "allgather_": ("all-gather", 0),
    "_allgather_base_": ("all-gather", 0),
    "allgather_into_tensor_coalesced_": ("all-gather", 0),
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "reduce_scatter_": ("reduce-scatter", 0),
    "_reduce_scatter_base_": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 0),
    "alltoall_": ("all-to-all", 0),
    "alltoall_base_": ("all-to-all", 0),
    "broadcast_": ("all-gather", 0),
    "send": ("collective-permute", 0),
    "recv_": ("collective-permute", 0),
}


def _tensors(x):
    """The tensors in a nest of lists / tuples / dicts / modules."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, nn.Module):
        yield from x.state_dict(keep_vars=True).values()
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)


@functools.lru_cache(maxsize=None)
def _is_view(func) -> bool:
    rets = getattr(func, "_schema", None)
    return bool(rets and rets.returns and any(
        r.alias_info is not None and not r.alias_info.is_write
        for r in rets.returns))


@functools.lru_cache(maxsize=None)
def _composite(func) -> bool:
    """An op FlopCounterMode would count through its decomposition."""
    from torch.utils.flop_counter import flop_registry

    return (func._overloadpacket not in flop_registry
            and func is not torch.ops.prim.device.default
            and torch._C._dispatch_has_kernel_for_dispatch_key(
                func.name(), "CompositeImplicitAutograd"))


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


class _Trace:
    """Counts of one traced call, kept by :func:`_trace_mode`'s mode."""

    def __init__(self, group_dims: Dict[str, str]):
        self.group_dims = group_dims
        self.flops = 0
        self.flops_by_dtype: Dict[str, float] = defaultdict(float)
        self.bytes = 0
        self.coll = {k: 0.0 for k in COLLECTIVE_OPS}
        self.counts = {k: 0 for k in COLLECTIVE_OPS}
        self.by_dim: Dict[str, float] = defaultdict(float)
        self.live: Dict[int, list] = {}     # storage -> [nbytes, tensors]
        self.live_bytes = 0
        self.peak = 0
        self.n_ops = 0
        self.shadow = 0                     # inside DTensor's shape pass

    # -- live storages ----------------------------------------------------
    def hold(self, t: torch.Tensor) -> None:
        key = _storage_key(t)
        ent = self.live.get(key)
        if ent is None:
            ent = self.live[key] = [t.untyped_storage().nbytes(), 0]
            self.live_bytes += ent[0]
            self.peak = max(self.peak, self.live_bytes)
        ent[1] += 1
        weakref.finalize(t, self._drop, key)

    def _drop(self, key: int) -> None:
        ent = self.live.get(key)
        if ent is None:
            return
        ent[1] -= 1
        if ent[1] == 0:
            self.live_bytes -= ent[0]
            del self.live[key]

    # -- one local op -----------------------------------------------------
    def op(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        self.n_ops += 1
        outs = list(_tensors(out))
        for t in outs:
            self.hold(t)
        name = func._schema.name.split("::")[-1]
        ns = func.namespace
        if ns in ("_c10d_functional", "c10d") and name in _COLLECTIVES:
            self._collective(name, args, kwargs, outs)
            return
        packet = func._overloadpacket
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            first = next(_tensors(args), None)
            dt = str(first.dtype).replace("torch.", "") if first is not None \
                else "none"
            self.flops += f
            self.flops_by_dtype[dt] += f
        if not _is_view(func):
            self.bytes += sum(t.nbytes for t in _tensors((args, kwargs)))
            self.bytes += sum(t.nbytes for t in outs)

    def _collective(self, name, args, kwargs, outs) -> None:
        kind, where = _COLLECTIVES[name]
        moved = outs if where < 0 else list(_tensors(args[where]))
        nbytes = sum(t.nbytes for t in moved)
        self.coll[kind] += nbytes
        self.counts[kind] += 1
        self.by_dim[self._dim(args, kwargs)] += nbytes * _COLL_FACTOR[kind]

    def _dim(self, args, kwargs) -> str:
        """The mesh dim of a collective's group: a functional collective
        names it, a c10d one passes the group itself."""
        import torch.distributed as dist

        for a in list(args) + list(kwargs.values()):
            if isinstance(a, torch.ScriptObject) and \
                    "ProcessGroup" in str(a._type()):
                a = dist.ProcessGroup.unbox(a).group_name
            if isinstance(a, str) and a in self.group_dims:
                return self.group_dims[a]
        return "other"


@contextlib.contextmanager
def _replayed_attention(trace: _Trace):
    """Forward ``chunked_attention`` calls (grad mode off: a prefill) on
    local tensors repeat with the same shapes in every layer, and each is
    some 10^5 fake ops at 32k tokens: the first call of a shape is traced
    op by op, the others add its counts, its transient peak over the live
    bytes and an output of its shape. Under grad mode, or on ``DTensor``s,
    every call is traced."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.lm import attention

    plain = attention.chunked_attention
    memo = {}

    def counts():
        return (trace.flops, dict(trace.flops_by_dtype), trace.bytes,
                dict(trace.coll), dict(trace.counts), dict(trace.by_dim),
                trace.n_ops)

    def replayed(q, k, v, **kw):
        if torch.is_grad_enabled() or isinstance(q, DTensor):
            return plain(q, k, v, **kw)
        key = tuple((tuple(t.shape), t.dtype, t.device)
                    for t in (q, k, v)) + tuple(sorted(kw.items()))
        if key not in memo:
            before, live, peak = counts(), trace.live_bytes, trace.peak
            trace.peak = live
            out = plain(q, k, v, **kw)
            after = counts()
            memo[key] = (tuple(out.shape), out.dtype, before, after,
                         trace.peak - live)
            trace.peak = max(peak, trace.peak)
            return out
        shape, dtype, before, after, transient = memo[key]
        trace.flops += after[0] - before[0]
        for dt, f in after[1].items():
            trace.flops_by_dtype[dt] += f - before[1].get(dt, 0.0)
        trace.bytes += after[2] - before[2]
        for k_ in COLLECTIVE_OPS:
            trace.coll[k_] += after[3][k_] - before[3][k_]
            trace.counts[k_] += after[4][k_] - before[4][k_]
        for d, b in after[5].items():
            trace.by_dim[d] += b - before[5].get(d, 0.0)
        trace.n_ops += after[6] - before[6]
        trace.peak = max(trace.peak, trace.live_bytes + transient)
        trace.shadow += 1
        try:
            out = torch.empty(shape, dtype=dtype, device=q.device)
        finally:
            trace.shadow -= 1
        trace.hold(out)
        return out

    attention.chunked_attention = replayed
    try:
        yield
    finally:
        attention.chunked_attention = plain


def _trace_mode(trace: _Trace, fake_mode):
    """A dispatch mode that hands every ``DTensor`` op on to DTensor (so
    that it sees the local ops DTensor issues) and counts each local op
    on ``fake_mode``'s tensors (not the ones DTensor's propagation makes
    in its own fake mode)."""
    from torch._subclasses.fake_tensor import FakeTensor
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode

    def ours(x) -> bool:
        ts = list(_tensors(x))
        return bool(ts) and all(isinstance(t, FakeTensor)
                                and t.fake_mode is fake_mode for t in ts)

    class Mode(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            if trace.shadow:
                return func(*args, **kwargs)
            if _composite(func):
                # as FlopCounterMode: count a composite through its parts
                with self:
                    r = func.decompose(*args, **kwargs)
                if r is not NotImplemented:
                    return r
            out = func(*args, **kwargs)
            if ours(out) or ours((args, kwargs)):
                trace.op(func, args, kwargs, out)
            return out

    return Mode()


# ---------------------------------------------------------------------------
# arguments
# ---------------------------------------------------------------------------

def _is_placements(x) -> bool:
    from torch.distributed.tensor import Placement

    return isinstance(x, tuple) and len(x) > 0 and all(
        isinstance(p, Placement) for p in x)


def _local(t: torch.Tensor, pl, mesh, device, layout: str):
    """Rank 0's shard of the abstract ``t`` on ``device`` (a fake tensor
    under the ambient ``FakeTensorMode``), as a ``DTensor`` of ``pl`` for a
    ``"global"`` step."""
    from torch.distributed.tensor import DTensor, Shard

    shape = list(t.shape)
    for i, p in enumerate(pl):
        if isinstance(p, Shard):        # rank 0's chunk: the first, largest
            n = mesh.size(i)
            shape[p.dim] = -(-shape[p.dim] // n)
    loc = torch.empty(shape, dtype=t.dtype, device=device)
    if layout != "global":
        return loc
    return DTensor.from_local(loc, mesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())


def materialize(arg, shard, mesh, device, layout: str):
    """``arg`` (an abstract tree: modules, dicts, lists, ``meta`` tensors)
    with every tensor replaced by rank 0's fake shard of its placements
    (``shard``: one placement tuple for the whole tree, or a tree of them
    keyed like ``arg``, a module's by parameter name)."""
    def pick(key):
        return shard if _is_placements(shard) else shard[key]

    if isinstance(arg, nn.Module):
        from torch._subclasses.fake_tensor import unset_fake_temporarily

        with unset_fake_temporarily():      # the meta module's copy
            mod = copy.deepcopy(arg)
        for key, t in list(mod.state_dict(keep_vars=True).items()):
            owner, _, leaf = key.rpartition(".")
            sub = mod.get_submodule(owner) if owner else mod
            new = _local(t, pick(key), mesh, device, layout)
            if isinstance(t, nn.Parameter):
                new = nn.Parameter(new, requires_grad=t.requires_grad)
            setattr(sub, leaf, new)
        return mod
    if isinstance(arg, dict):
        return {k: materialize(v, pick(k), mesh, device, layout)
                for k, v in arg.items()}
    if isinstance(arg, (list, tuple)):
        return type(arg)(materialize(v, pick(i), mesh, device, layout)
                         for i, v in enumerate(arg))
    if isinstance(arg, torch.Tensor):
        return _local(arg, shard, mesh, device, layout)
    return arg


def _local_tensors(x):
    """The local (fake) tensors of a tree of modules / DTensors."""
    from torch.distributed.tensor import DTensor

    for t in _tensors(x):
        yield t._local_tensor if isinstance(t, DTensor) else t


def _unique_bytes(ts) -> Dict[int, int]:
    return {_storage_key(t): t.untyped_storage().nbytes() for t in ts}


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

def _peak_flops(dtype: str) -> float:
    if dtype in ("bfloat16", "float16"):
        return meshlib.CHIP_PEAK_FLOPS
    return meshlib.CHIP_PEAK_FLOPS_F32


def trace_built(built, mesh, device) -> dict:
    """Trace ``built.fn`` once on rank 0's fake shards of ``built.args``
    over ``mesh`` on ``device``; returns the record's measured part
    (``memory``, FLOPs, bytes, collectives, roofline) for a cell of
    ``mesh.size()`` devices."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    group_dims = {mesh.get_group(d).group_name: d
                  for d in mesh.mesh_dim_names}
    trace = _Trace(group_dims)
    fake = FakeTensorMode(allow_non_fake_inputs=False)
    # DTensor runs each new op once on global-shaped fake tensors of the
    # ambient fake mode, for the output's shape: not a local op
    meta = ShardingPropagator._propagate_tensor_meta_non_cached

    def shadowed(self, *a, **kw):
        trace.shadow += 1
        try:
            return meta(self, *a, **kw)
        finally:
            trace.shadow -= 1

    ShardingPropagator._propagate_tensor_meta_non_cached = shadowed
    # a step that deep-copies a module of fake tensors (adamw_update's
    # rebuild) must keep them in this mode, not copy the mode with them,
    # and copies a DTensor leaf as a clone (Tensor.__deepcopy__ would give
    # the wrapper a storage of its own)
    FakeTensorMode.__deepcopy__ = lambda self, memo: self
    DTensor.__deepcopy__ = _dtensor_deepcopy
    try:
        return _trace(built, mesh, device, fake, trace)
    finally:
        del FakeTensorMode.__deepcopy__, DTensor.__deepcopy__
        ShardingPropagator._propagate_tensor_meta_non_cached = meta


def _dtensor_deepcopy(self, memo):
    out = self.detach().clone().requires_grad_(self.requires_grad)
    if getattr(self, "_is_param", False):
        out = nn.Parameter(out, requires_grad=self.requires_grad)
    memo[id(self)] = out
    return out


def _arguments(built, mesh, device):
    """Rank 0's shards of ``built.args`` (fake under the ambient fake
    mode) and the bytes of their storages."""
    args = [materialize(a, s, mesh, device, built.layout)
            for a, s in zip(built.args, built.in_shardings)]
    arg_bytes = _unique_bytes(_local_tensors(args))
    if built.meta.get("kind") == "decode":
        # decode_step(model, cache, token, cache_len: int): the whole
        # cache valid, every position attended
        args[-1] = int(next(iter(built.args[1].values())).shape[2])
    return args, arg_bytes


def argument_bytes(built, mesh, device) -> int:
    """The record's ``memory.argument_bytes`` of ``built`` over ``mesh``,
    without the trace."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        return sum(_arguments(built, mesh, device)[1].values())


def _trace(built, mesh, device, fake, trace) -> dict:
    from torch.distributed.tensor.experimental import implicit_replication

    with fake:
        args, arg_bytes = _arguments(built, mesh, device)
        for t in _local_tensors(args):
            trace.hold(t)
        trace.peak = trace.live_bytes
        with contextlib.ExitStack() as stack:
            if built.layout == "global":
                stack.enter_context(implicit_replication())
            stack.enter_context(_replayed_attention(trace))
            stack.enter_context(_trace_mode(trace, fake))
            out = built.fn(*args)
        out_bytes = _unique_bytes(_local_tensors(out))
    argument = sum(arg_bytes.values())
    output = sum(out_bytes.values())
    alias = sum(v for k, v in out_bytes.items() if k in arg_bytes)
    temp = max(trace.peak - (argument + output - alias), 0)
    t_compute = sum(f / _peak_flops(dt)
                    for dt, f in trace.flops_by_dtype.items())
    t_memory = trace.bytes / meshlib.CHIP_HBM_BW
    by_dim = dict(trace.by_dim)
    t_coll = sum(b / (meshlib.link_bandwidth(mesh, d)
                      if d in mesh.mesh_dim_names else meshlib.NIC_BW)
                 for d, b in by_dim.items())
    coll_total = sum(by_dim.values())
    del out, args
    return dict(
        memory=dict(argument_bytes=argument, output_bytes=output,
                    temp_bytes=temp, alias_bytes=alias, code_bytes=0),
        hlo_flops=float(trace.flops),
        flops_by_dtype=dict(trace.flops_by_dtype),
        hlo_bytes=float(trace.bytes),
        collective_bytes=coll_total,
        collectives=trace.coll,
        collective_counts=trace.counts,
        collective_bytes_by_dim=by_dim,
        local_ops=trace.n_ops,
        roofline=dict(
            t_compute=t_compute, t_memory=t_memory, t_collective=t_coll,
            dominant=max([("compute", t_compute), ("memory", t_memory),
                          ("collective", t_coll)], key=lambda kv: kv[1])[0],
        ),
    )


def _mesh_tag(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def run_cell(arch_name: str, shape: str, multi_pod: bool,
             variant: Optional[str] = None, device: str = "cuda",
             mesh=None) -> dict:
    """Build and trace one cell on ``make_production_mesh`` (over the
    placeholder group, which the caller starts) or on ``mesh``; returns
    its record. ``device`` is the trace's device type: ``"cuda"``, the
    card (resolved as every entry point resolves it), or ``"cpu"``."""
    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device

    t0 = time.perf_counter()
    dev = resolve_device(device)
    if mesh is None:
        mesh = meshlib.make_production_mesh(multi_pod=multi_pod,
                                            device_type=dev.type)
    arch = get_arch(arch_name)
    cell = arch.cells[shape]
    rec = dict(
        arch=arch_name, shape=shape,
        mesh="x".join(str(s) for s in mesh.mesh.shape),
        n_chips=int(mesh.size()), kind=cell.kind, variant=variant or "base",
        device=dev.type,
    )
    if cell.skip:
        rec.update(status="skipped", reason=cell.skip)
        return rec
    try:
        kw = {"variant": variant} if variant else {}
        built = arch.build(shape, mesh, **kw)
        meas = trace_built(built, mesh, dev)
        model_flops = float(built.meta.get("model_flops", 0.0))
        n = rec["n_chips"]
        rec.update(
            status="ok",
            seconds=round(time.perf_counter() - t0, 1),
            calibration=None,
            model_flops=model_flops,
            useful_flops_ratio=(model_flops / max(n, 1))
            / max(meas["hlo_flops"], 1.0),
            meta={k: v for k, v in built.meta.items()
                  if isinstance(v, (int, float, str, list))},
            **meas,
        )
    except Exception as e:  # a failure here is a bug to fix
        rec.update(
            status="fail", error=f"{type(e).__name__}: {e}"[:2000],
            traceback=traceback.format_exc()[-12000:],
            seconds=round(time.perf_counter() - t0, 1),
        )
    return rec


def _result_path(arch, shape, mesh_tag, out_dir):
    return os.path.join(out_dir, f"{arch}__{shape}__{mesh_tag}.json")


def summary_line(rec: dict, tag: str) -> str:
    status = rec["status"]
    extra = (
        f" dominant={rec['roofline']['dominant']}"
        f" flops={rec['hlo_flops']:.3g}"
        f" coll={rec['collective_bytes']:.3g}B"
        f" peak={_peak_bytes(rec) / 1e9:.3f}GB"
        if status == "ok" else " " + rec.get("reason",
                                             rec.get("error", ""))[:120])
    return (f"[{status}] {rec['arch']} {rec['shape']} {tag} "
            f"({rec.get('seconds', 0)}s){extra}")


def _peak_bytes(rec: dict) -> int:
    m = rec["memory"]
    return (m["argument_bytes"] + m["output_bytes"] - m["alias_bytes"]
            + m["temp_bytes"])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--variant", default=None,
                    help="build variant (gnn: base|unsharded|halo)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the trace's device type (cpu: the kernels' "
                         "plain versions)")
    args = ap.parse_args(argv)
    # DTensor's advice on sequential collectives, once per redistribution
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    out_dir = os.path.abspath(args.out)
    os.makedirs(out_dir, exist_ok=True)

    if args.report:
        report(out_dir)
        return 0
    if args.all:
        return orchestrate(args, out_dir)
    if not (args.arch and args.shape):
        ap.error("--arch and --shape (or --all / --report)")

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    ok = True
    for m in meshes:
        multi = m == "multi"
        meshlib.init_placeholder_group(512 if multi else 256)
        try:
            rec = run_cell(args.arch, args.shape, multi_pod=multi,
                           variant=args.variant, device=args.device)
        finally:
            torch.distributed.destroy_process_group()
        tag = _mesh_tag(multi)
        if args.variant:
            tag = f"{tag}__{args.variant}"
        with open(_result_path(args.arch, args.shape, tag, out_dir),
                  "w") as f:
            json.dump(rec, f, indent=1)
        print(summary_line(rec, tag), flush=True)
        ok &= rec["status"] in ("ok", "skipped")
    return 0 if ok else 1


def command(arch: str, shape: str, mesh: str = "single",
            device: Optional[str] = None, out: Optional[str] = None):
    """``(argv, env)`` of one cell's dry run in a process of its own (its
    placeholder group needs one), this package on its ``PYTHONPATH``."""
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
    env = dict(os.environ)
    env["PYTHONPATH"] = src + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
           "--shape", shape, "--mesh", mesh]
    if device:
        cmd += ["--device", device]
    if out:
        cmd += ["--out", out]
    return cmd, env


def orchestrate(args, out_dir) -> int:
    """Run every (arch x shape x mesh) as a subprocess, ``--jobs`` at a
    time, each with its own placeholder group; cells already recorded
    ``ok`` or ``skipped`` are kept unless ``--force``."""
    from repro_torch.configs import list_cells

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    work = []
    for arch, shape, _cell in list_cells():
        for m in meshes:
            path = _result_path(arch, shape, _mesh_tag(m == "multi"),
                                out_dir)
            if not args.force and os.path.exists(path):
                with open(path) as f:
                    if json.load(f).get("status") in ("ok", "skipped"):
                        continue
            work.append((arch, shape, m))
    print(f"dry-run: {len(work)} cells to trace, jobs={args.jobs}",
          flush=True)

    def launch(item):
        arch, shape, m = item
        cmd, env = command(arch, shape, m, args.device, out_dir)
        return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True), item

    t0 = time.perf_counter()
    procs, queue, fails, done = [], list(work), 0, 0
    while queue or procs:
        while queue and len(procs) < args.jobs:
            procs.append(launch(queue.pop(0)))
        for p, item in list(procs):
            if p.poll() is not None:
                procs.remove((p, item))
                done += 1
                out = p.stdout.read().strip().splitlines()
                line = out[-1] if out else ""
                print(f"({done}/{len(work)}) {line}", flush=True)
                if p.returncode != 0:
                    fails += 1
        time.sleep(0.5)
    print(f"dry-run complete: {done - fails} ok, {fails} failed, "
          f"{time.perf_counter() - t0:.1f} s wall", flush=True)
    report(out_dir)
    return 1 if fails else 0


def report(out_dir):
    rows = []
    for fn in sorted(os.listdir(out_dir)):
        if not fn.endswith(".json"):
            continue
        with open(os.path.join(out_dir, fn)) as f:
            rows.append(json.load(f))
    print(f"\n=== dry-run report ({len(rows)} cells) ===")
    hdr = (f"{'arch':22s} {'shape':14s} {'mesh':8s} {'status':8s} "
           f"{'GFLOPs':>9s} {'GB':>8s} {'collGB':>8s} {'dom':>10s} "
           f"{'tempGB/dev':>10s}")
    print(hdr)
    for r in rows:
        if r["status"] == "ok":
            print(
                f"{r['arch']:22s} {r['shape']:14s} {r['mesh']:8s} ok       "
                f"{r['hlo_flops'] / 1e9:9.1f} {r['hlo_bytes'] / 1e9:8.2f} "
                f"{r['collective_bytes'] / 1e9:8.3f} "
                f"{r['roofline']['dominant']:>10s} "
                f"{r['memory']['temp_bytes'] / 1e9:10.2f}"
            )
        else:
            why = r.get("reason", r.get("error", ""))[:60]
            print(f"{r['arch']:22s} {r['shape']:14s} {r['mesh']:8s} "
                  f"{r['status']:8s} {why}")


if __name__ == "__main__":
    sys.exit(main())
