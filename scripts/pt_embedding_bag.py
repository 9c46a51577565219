#!/usr/bin/env python3
"""Variants of the ``embedding_bag`` kernel on the card, at the main path's
shapes, timed alternately in one process.

    PYTHONPATH=src python scripts/pt_embedding_bag.py [--baseline OLD.cu]
        [--out DIR] [--shapes serve_bulk,corpus,...] [--variants a,b,...]

Each build is the committed ``csrc/embedding_bag.cu`` with substitutions
(asserted to apply): as committed; ``cp.async`` copies (16 bytes from
every producer lane in place of one ``cp.async.bulk`` a row); a 4-stage
one-block ring; ids 2 or 8 items ahead (4 committed); ``__stcs`` output
stores; an L2 evict-first policy on the row copies; registers for three
or four blocks a SM. Each is built with ``nvcc`` and the flags of
``repro_torch.kernels._build`` into ``DIR`` (default
``checkout/variants``, git-ignored), all at once, and its C entry point is
called directly, on one preallocated output, with the committed plan of
``ops.launch_plan`` or that plan with fields replaced
(``dataclasses.replace``): another tile, one or two blocks a SM for every
shape, stage sizes, or a wider small-batch split. ``--baseline`` adds a
source with the earlier C signature (``embedding_bag_f32(table, ids, out,
V, n_bags, bag_size, D, mean, stream)``), such as the kernel before the
redesign, timed beside them.

Shapes (``chip_smoke.py`` phase H's, tables from ``torch.Generator`` seed 0):
``serve_bulk`` (10,000,000 x 256, ids (2,097,152, 16) uniform, numpy seed
0), ``corpus`` (the same table, (262,144, 16) uniform, seed 2),
``serve_p99`` ((4,096, 16), seed 1), ``training_user`` and
``training_item`` (2,000,000 x 256, the training example's step-0 batch
of 16,384: a user's 128 ids one id, an item's 70% of them),
``resume_user`` and ``resume_item`` (250,000 x 256, the example's own
config: batch 1,024, bags of 8). Each output is
checked bitwise against the plain version (``ref.embedding_bag_ref``);
times are ``chip_smoke.queued_ms`` medians (launches queued behind a sleep,
the variants in the order a b ... b a). A variant whose plan the shape
cannot take (a tile of more than 128 ids) is left out there. Prints the
card's name and power limit, then one JSON object a line per (shape,
variant) and, last, the fastest variant of each shape. Needs one CUDA
card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import functools
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu"

BUILDS = {
    "committed": [],
    "cp.async copies": [
        ("  constexpr bool kBulk = W == 4;", "  constexpr bool kBulk = false;"),
        ("// one arrival on the barrier once every cp.async",
         """__device__ __forceinline__ void cp_async(uint32_t dst,
                                         const float4* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(dst),
               "l"(src) : "memory");
}

// one arrival on the barrier once every cp.async"""),
    ],
    "4 stages": [("constexpr int kStages = 3;", "constexpr int kStages = 4;")],
    "ids 2 items ahead": [("constexpr int kAhead = 4;",
                           "constexpr int kAhead = 2;")],
    "ids 8 items ahead": [("constexpr int kAhead = 4;",
                           "constexpr int kAhead = 8;")],
    "stream stores": [(
        """          dst[0] = p.mean ? div_v(acc0, fbag, rcp) : acc0;
          if (cv + half < wv) dst[half] = p.mean ? div_v(acc1, fbag, rcp) : acc1;""",
        """          __stcs(dst, p.mean ? div_v(acc0, fbag, rcp) : acc0);
          if (cv + half < wv)
            __stcs(dst + half, p.mean ? div_v(acc1, fbag, rcp) : acc1);""")],
    "evict first": [(
        """      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\\n" ::"r"(dst),""",
        """      "{\\n.reg .b64 pol;\\n"
      "createpolicy.fractional.L2::evict_first.b64 pol, 1.0;\\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], pol;\\n}\\n" ::"r"(dst),""")],
    "3 blocks a SM": [("__launch_bounds__(kThreads, B)",
                       "__launch_bounds__(kThreads, B == 2 ? 3 : B)")],
    "4 blocks a SM": [("__launch_bounds__(kThreads, B)",
                       "__launch_bounds__(kThreads, B == 2 ? 4 : B)")],
}
# (build, fields of the committed plan to replace: see replan)
VARIANTS = {
    "committed": ("committed", {}),
    "1 block a SM of 3 x 64 KB": ("committed", dict(blocks=1,
                                                    stage_bytes=65536)),
    "2 blocks a SM of 2 x 48 KB": ("committed", dict(blocks=2,
                                                     stage_bytes=49152)),
    "tile 4": ("committed", dict(tile=4)),
    "tile 16": ("committed", dict(tile=16)),
    "cp.async copies": ("cp.async copies", {}),
    "1 block a SM of 4 x 48 KB": ("4 stages", dict(
        blocks=1, stages=4, stage_bytes=49152)),
    "3 blocks a SM of 2 x 32 KB": ("3 blocks a SM", dict(
        blocks=2, stage_bytes=32768, per_sm=3)),
    "4 blocks a SM of 2 x 24 KB": ("4 blocks a SM", dict(
        blocks=2, stage_bytes=24576, per_sm=4)),
    "ids 2 items ahead": ("ids 2 items ahead", dict(ahead=2)),
    "ids 8 items ahead": ("ids 8 items ahead", dict(ahead=8)),
    "split to 8 items a SM": ("committed", dict(min_items=8)),
    "stream stores": ("stream stores", {}),
    "evict first": ("evict first", {}),
}
SHAPES = ("serve_bulk", "corpus", "serve_p99", "training_user",
          "training_item", "resume_user", "resume_item")
LAUNCHES_A_ROUND = {"serve_bulk": 10, "corpus": 40}

P, I64, I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def build(name: str, subs, src: Path, out: Path) -> Path:
    from repro_torch.kernels import _build

    text = src.read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: substitution does not apply")
        text = text.replace(old, new)
    stem = f"embedding_bag_{name.replace(' ', '_')}"
    cu, lib = out / f"{stem}.cu", out / f"lib{stem}.so"
    cu.write_text(text)
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS,
                          "-o", str(lib), str(cu)],
                         capture_output=True, text=True)
    if res.returncode:
        print(f"nvcc failed for {name} (its variants are left out):\n"
              f"{res.stdout}{res.stderr}", flush=True)
        return None
    return lib


def bind(lib: Path, old: bool):
    fn = ctypes.CDLL(str(lib)).embedding_bag_f32
    fn.argtypes = ([P, P, P, I64, I64, I64, I64, I32, P] if old else
                   [P, P, P, I64, I64, I64, I64, I32, I32, I32, I32, I32,
                    I32, I32, I32, I64, I64, P])
    fn.restype = ctypes.c_int
    return fn


def replan(p, n_bags: int, D: int, sms: int, *, tile=None, blocks=None,
           stage_bytes=None, stages=None, per_sm=None, ahead=None,
           min_items=None):
    """The committed plan ``p`` with fields replaced: ``tile`` bags (the
    slab the consumers then sum), ``blocks`` (1: the one-block ring, 2: the
    two-stage one) of ``stages`` stages of ``stage_bytes``, ``per_sm``
    resident blocks (the grid), ``ahead`` items of ids (shared memory),
    ``min_items`` items a SM (halving the slab); the shared memory and
    grid follow. None where the kernel cannot take it."""
    from repro_torch.kernels.embedding_bag import ops

    W = 4 if p.vec else 1
    tile = tile or p.tile
    if tile * p.chunk > ops.FILL_IDS:
        return None
    blocks = blocks or p.blocks
    stages = stages or (ops.STAGES if blocks == 1 else ops.STAGES_TWO_BLOCKS)
    stage = stage_bytes // 4 // W * W if stage_bytes else p.stage
    slab = p.slab if tile == p.tile else min(2 * (ops.CONSUMERS // tile) * W,
                                             -(-D // W) * W)
    n_tiles = -(-n_bags // tile)
    while min_items and n_tiles * -(-D // slab) < min_items * sms \
            and slab > ops.MIN_SLAB:
        slab = max(ops.MIN_SLAB, slab // 2 // W * W)
    parts = -(-D // slab)
    smem = ops._meta_bytes(stages) + (stages * stage + slab) * 4 + \
        4 * ops.FILL_IDS * ((ahead or ops.ID_AHEAD) - ops.ID_AHEAD)
    return dataclasses.replace(
        p, tile=tile, slab=slab, parts=parts, stage=stage, blocks=blocks,
        grid=min(n_tiles * parts, sms * (per_sm or blocks)), smem=smem)


def shape_inputs(name: str, dev, tables: dict):
    import numpy as np
    import torch

    from repro_torch.configs.two_tower_retrieval import CONFIG
    from repro_torch.examples.train_two_tower import make_batch_fn, make_config

    def table(V):
        if V not in tables:
            tables.clear()
            torch.cuda.empty_cache()
            gen = torch.Generator(device=dev).manual_seed(0)
            tables[V] = torch.randn((V, CONFIG.embed_dim), generator=gen,
                                    device=dev)
        return tables[V]

    def uniform(seed, n):
        return torch.from_numpy(np.random.default_rng(seed).integers(
            0, CONFIG.user_vocab, (n, CONFIG.bag_size)).astype(np.int32)
        ).to(dev)

    if name == "serve_bulk":
        return table(CONFIG.user_vocab), uniform(0, 2097152)
    if name == "corpus":
        return table(CONFIG.user_vocab), uniform(2, 262144)
    if name == "serve_p99":
        return table(CONFIG.user_vocab), uniform(1, 4096)
    if name.startswith("training"):
        u, i = make_batch_fn(CONFIG, 16384, 2_000_000, dev)(0)
        ids = u if name == "training_user" else i
        return table(2_000_000), ids.reshape(-1, CONFIG.bag_size).contiguous()
    cfg = make_config(250_000)
    u, i = make_batch_fn(cfg, 1024, 250_000, dev)(0)
    ids = u if name == "resume_user" else i
    return table(250_000), ids.reshape(-1, cfg.bag_size).contiguous()


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=ROOT / "checkout/variants")
    ap.add_argument("--shapes", default=",".join(SHAPES))
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pt_embedding_bag: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke
    from repro_torch.kernels.embedding_bag import ops, ref

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    variants = args.variants.split(",")
    builds = sorted({VARIANTS[v][0] for v in variants})
    args.out.mkdir(parents=True, exist_ok=True)
    jobs = {b: (BUILDS[b], SRC) for b in builds}
    if args.baseline is not None:
        jobs["baseline"] = ([], args.baseline.resolve())
    with ThreadPoolExecutor(len(jobs)) as ex:
        libs = dict(zip(jobs, ex.map(
            lambda kv: build(kv[0], kv[1][0], kv[1][1], args.out),
            jobs.items())))
    fns = {b: bind(lib, b == "baseline") for b, lib in libs.items()
           if lib is not None}
    variants = [v for v in variants if VARIANTS[v][0] in fns]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream(dev).cuda_stream

    tables, best, all_same = {}, {}, True
    for shape in args.shapes.split(","):
        table, ids = shape_inputs(shape, dev, tables)
        (V, D), (n_bags, bag) = table.shape, ids.shape
        out = torch.empty((n_bags, D), device=dev)
        want = ref.embedding_bag_ref(table, ids, "mean")
        calls, plans = {}, {}
        committed = ops.launch_plan(n_bags, bag, D, True, sms)
        for v in variants:
            b, kw = VARIANTS[v]
            plan = replan(committed, n_bags, D, sms, **kw)
            if plan is None:
                continue
            plans[v] = plan
            calls[v] = functools.partial(
                fns[b], table.data_ptr(), ids.data_ptr(), out.data_ptr(), V,
                n_bags, bag, D, 1, int(plan.vec), plan.tile, plan.chunk,
                plan.slab, plan.parts, plan.stage, plan.blocks, plan.grid,
                plan.smem, stream)
        if "baseline" in fns:
            calls["baseline"] = functools.partial(
                fns["baseline"], table.data_ptr(), ids.data_ptr(),
                out.data_ptr(), V, n_bags, bag, D, 1, stream)
        same = {}
        for v, call in calls.items():
            out.fill_(7.0)
            err = call()
            torch.cuda.synchronize()
            if err:
                raise SystemExit(f"{shape} {v}: launch refused ({err})")
            same[v] = chip_smoke.bits_equal(out, want)
            all_same &= same[v]
        del want
        n = LAUNCHES_A_ROUND.get(shape, 100)
        times = chip_smoke.queued_ms(calls, launches=n)
        for v, ms in times.items():
            row = dict(shape=shape, variant=v, ms=ms, bitwise=same[v],
                       plan=str(plans.get(v, "earlier C signature")))
            print(json.dumps(row), flush=True)
        best[shape] = min(times, key=times.get)
        del out, ids
    print(json.dumps({"fastest": best, "all_bitwise": all_same}),
          flush=True)
    return 0 if all_same else 1


if __name__ == "__main__":
    sys.exit(main())
