#!/usr/bin/env python3
"""Variants of two CUDA kernels of the port on the card, against their plain
versions, timed alternately in one process.

    PYTHONPATH=src python scripts/pt_kernel_variants.py [--out DIR]

Each variant is the committed source with one substitution (asserted to
apply), built with ``nvcc`` and the flags of ``repro_torch.kernels._build``
into ``DIR`` (default ``checkout/variants``, git-ignored), and bound in
place of the package's own library:

- ``flash_attention`` (bf16): P V with P in 3 bf16 terms (as committed), 2
  terms, 1 term; and p by ``expf`` in place of ``ex2.approx``. Each is held
  to ``chip_smoke.py``'s checks: within 1 bf16 ulp (or 1e-6) of the plain
  version on the card tests' grid (shapes x masks, numpy seed 0 inputs),
  and at one prefill launch (B 1, S 32,768, 40 / 10 heads of 128, causal)
  within 2^-7 |plain| + 1e-6, the share of outputs bitwise equal to plain,
  a rerun bitwise; timed over 5 launches (CUDA events), twice, in the order
  a b c d d c b a.
- ``bsr_spmm``: 512-column parts of D (as committed) against one
  1,024-column part, at the row's main shape (``chip_smoke.bsr_main_inputs``):
  bitwise equal outputs, 5 launches each, a b b a.

Prints the card's name and power limit, then one JSON object a line per
variant. Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

FLASH = {
    "3 terms": [],
    "2 terms": [("constexpr int kTerms = 3;", "constexpr int kTerms = 2;")],
    "1 term": [("constexpr int kTerms = 3;", "constexpr int kTerms = 1;")],
    "expf": [("""        float pa = ex2_approx((s[2 * i] - mn) * kLog2e),
              pb = ex2_approx((s[2 * i + 1] - mn) * kLog2e);""",
              """        float pa = expf(s[2 * i] - mn), pb = expf(s[2 * i + 1] - mn);""")],
}
BSR = {
    "512-column parts": [],
    "one 1024-column part": [("constexpr int kPartCols = 512;",
                              "constexpr int kPartCols = 1024;")],
}
FA_SHAPES = [(1, 128, 128, 4, 4, 32), (2, 256, 256, 8, 2, 64),
             (1, 512, 512, 4, 1, 128), (1, 200, 200, 4, 2, 128),
             (1, 96, 200, 8, 2, 64), (1, 200, 160, 4, 2, 64),
             (2, 40, 40, 8, 2, 8)]
FA_MASKS = [(True, None), (True, 64), (False, None)]


def build(pkg: str, name: str, subs, out: Path) -> Path:
    from repro_torch.kernels import _build

    text = (ROOT / "src/repro_torch/kernels" / pkg / "csrc" / f"{pkg}.cu"
            ).read_text()
    for old, new in subs:
        if text.count(old) != 1:
            raise SystemExit(f"{pkg} {name}: substitution does not apply")
        text = text.replace(old, new)
    stem = f"{pkg}_{name.replace(' ', '_')}"
    src, lib = out / f"{stem}.cu", out / f"lib{stem}.so"
    src.write_text(text)
    res = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                          str(lib), str(src)], capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed for {stem}:\n{res.stdout}{res.stderr}")
    return lib


def bind_flash(lib: Path):
    from repro_torch.kernels.flash_attention import ops

    cdll = ctypes.CDLL(str(lib))
    fn = cdll.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + \
        [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_longlong,
                                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    ops._bound = cdll


def bind_bsr(lib: Path):
    from repro_torch.kernels.bsr_spmm import ops

    cdll = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_longlong
    cdll.bsr_spmm_f32.argtypes = [P, P, P, P, P, I, I, I, I, P]
    cdll.bsr_spmm_bf16x.argtypes = [P, P, P, P, P, P, I, I, I, I, P]
    cdll.bsr_spmm_f32.restype = cdll.bsr_spmm_bf16x.restype = ctypes.c_int
    ops._bound = cdll


def flash_grid(dev) -> dict:
    """Cases of the card tests' grid past 1 bf16 ulp (and 1e-6) of plain."""
    import numpy as np
    import torch

    from repro_torch.kernels.flash_attention import ops, ref

    rng = np.random.default_rng(0)
    cases = missed = past = 0
    worst = 0.0
    for (B, Sq, Skv, Hq, Hkv, D) in FA_SHAPES:
        arrays = [rng.standard_normal(s, dtype=np.float32) for s in
                  ((B, Sq, Hq, D), (B, Skv, Hkv, D), (B, Skv, Hkv, D))]
        q, k, v = (torch.from_numpy(a).to(dev).bfloat16() for a in arrays)
        for causal, window in FA_MASKS:
            if window is not None and Sq > Skv + window - 1:
                continue
            got = ops.flash_attention(q, k, v, causal, window)
            plain = ref.flash_attention_ref(q, k, v, causal, window)
            diff = (got.float() - plain.float()).abs()
            bad = (ref.bf16_ulp_distance(got, plain) > 1) & \
                (diff > ref.BF16_ABS_FLOOR)
            cases += 1
            missed += int(bool(bad.any()))
            past += int(bad.sum())
            if bool(bad.any()):
                worst = max(worst, float(diff[bad].max()))
    return dict(grid_cases=cases, grid_cases_past_1ulp=missed,
                grid_elements_past_1ulp=past, grid_worst_abs_past=worst)


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "checkout" / "variants"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pt_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    jobs = [("flash_attention", n, s) for n, s in FLASH.items()] + \
        [("bsr_spmm", n, s) for n, s in BSR.items()]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(jobs)) as ex:
        libs = dict(zip([(p, n) for p, n, _ in jobs],
                        ex.map(lambda j: build(j[0], j[1], j[2], out), jobs)))
    print(f"builds: {time.perf_counter() - t0:.1f} s", flush=True)

    from repro_torch.kernels.bsr_spmm import ops as bs_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    B, S, Hq, Hkv, D = 1, chip_smoke.PREFILL_SEQ, 40, 10, 128
    q = torch.randn((B, S, Hq, D), generator=gen, device=dev).bfloat16()
    k = torch.randn((B, S, Hkv, D), generator=gen, device=dev).bfloat16()
    v = torch.randn((B, S, Hkv, D), generator=gen, device=dev).bfloat16()
    plain = fa_ref.flash_attention_ref(q, k, v)
    rows = {}
    for name in FLASH:
        bind_flash(libs[("flash_attention", name)])
        row = flash_grid(dev)
        got = fa_ops.flash_attention(q, k, v)
        err = (got.float() - plain.float()).abs()
        row.update(
            prefill_within_2_7=bool(torch.all(
                err <= 2.0 ** -7 * plain.float().abs() + 1e-6)),
            prefill_bitwise_share=float((got == plain).float().mean()),
            prefill_rerun_bitwise=torch.equal(fa_ops.flash_attention(q, k, v),
                                              got),
            ms=[])
        rows[name] = row
        del got, err
    order = list(FLASH) + list(reversed(FLASH))
    for name in order:
        bind_flash(libs[("flash_attention", name)])
        rows[name]["ms"].append(
            chip_smoke.time_ms(lambda: fa_ops.flash_attention(q, k, v)))
    for name, row in rows.items():
        print(json.dumps(dict(kernel="flash_attention", variant=name, **row)),
              flush=True)
    del q, k, v, plain
    fa_ops._bound = None
    torch.cuda.empty_cache()

    mi = chip_smoke.bsr_main_inputs(dev)
    outs, ms = {}, {name: [] for name in BSR}
    for name in list(BSR) + list(reversed(BSR)):
        bind_bsr(libs[("bsr_spmm", name)])
        outs.setdefault(name, bs_ops.bsr_spmm(mi.x, mi.a, mi.rows, mi.cols,
                                              mi.nb))
        ms[name].append(chip_smoke.time_ms(
            lambda: bs_ops.bsr_spmm(mi.x, mi.a, mi.rows, mi.cols, mi.nb)))
    first = outs[next(iter(BSR))]
    for name in BSR:
        print(json.dumps(dict(kernel="bsr_spmm", variant=name, ms=ms[name],
                              bitwise_equal_to_first=torch.equal(outs[name],
                                                                 first))),
              flush=True)
    bs_ops._bound = None
    return 0


if __name__ == "__main__":
    sys.exit(main())
