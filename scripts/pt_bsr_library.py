#!/usr/bin/env python3
"""PyTorch's own block-sparse product beside the port's ``bsr_spmm`` kernel,
at the GCN main path's aggregate shape, on one CUDA card.

    python scripts/pt_bsr_library.py [--nodes 65536] [--dim 1024]

Takes the ``bsr_spmm`` row's inputs from ``chip_smoke.bsr_main_inputs``
(phase C's reordered Kronecker graph as nonzero blocks of 128 with GCN
weights, and the layer-0 features) and multiplies them through
``torch.sparse_bsr_tensor(...) @ x``. Prints which route PyTorch took (its
Triton kernel, ``torch.sparse._triton_ops``, or cuSPARSE), the first call's
seconds, the first block row where the result leaves the port plain
version's bound (``bsr_spmm_tolerance``) and the value entry its blocks
start at, then the library's and the kernel's times (``chip_smoke.time_ms``)
on the leading block rows whose values lie below 2^31 entries, and the
kernel's on the whole matrix. The last line is one JSON
object. Needs a CUDA card (exit 2 without one); float32, no TF32.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BLOCK = 128


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=65536)
    ap.add_argument("--dim", type=int, default=1024)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("pt_bsr_library: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import bsr_main_inputs, time_ms
    from repro_torch.kernels.bsr_spmm import ops, ref

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    mi = bsr_main_inputs(dev, args.nodes, args.dim)
    a_d, r_d, c_d, x, nb = mi.a, mi.rows, mi.cols, mi.x, mi.nb
    nnz = a_d.shape[0]
    n, D = x.shape
    xb = x.view(nb, BLOCK, D)
    plain = ref.bsr_spmm_ref(a_d, r_d, c_d, xb, nb).view(-1, D)
    tol = ref.bsr_spmm_tolerance(a_d, r_d, c_d, xb, nb).view(-1, D)
    crow = torch.searchsorted(
        r_d, torch.arange(nb + 1, device=dev, dtype=torch.int32),
        out_int32=True)
    # the leading block rows whose values lie below 2^31 entries
    fit = int(torch.searchsorted(
        crow, torch.tensor(2 ** 31 // BLOCK ** 2, device=dev,
                           dtype=torch.int32), right=True)) - 1
    fit = min(fit, nb)
    k = int(crow[fit])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)   # "BSR is beta"
        bsr = torch.sparse_bsr_tensor(crow, c_d, a_d, size=(n, n))
        triton_before = "torch.sparse._triton_ops" in sys.modules
        t0 = time.perf_counter()
        lib = bsr @ x
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        route = ("triton" if not triton_before
                 and "torch.sparse._triton_ops" in sys.modules else "cusparse")
        bad = ((lib - plain).abs() > tol).view(nb, -1).any(1).nonzero()[:, 0]
        del lib, bsr
        head = torch.sparse_bsr_tensor(crow[:fit + 1], c_d[:k], a_d[:k],
                                       size=(fit * BLOCK, n))
        head_ok = bool(torch.all(
            (head @ x - plain[:fit * BLOCK]).abs() <= tol[:fit * BLOCK]))
        lib_head_ms = time_ms(lambda: head @ x)
    out = dict(
        device=card, torch=torch.__version__, nodes=n, dim=D, block=BLOCK,
        nnz_blocks=nnz, value_entries=nnz * BLOCK ** 2, route=route,
        first_call_s=first_s,
        first_wrong_block_row=int(bad[0]) if bad.numel() else None,
        its_first_value_entry=int(crow[int(bad[0])]) * BLOCK ** 2
        if bad.numel() else None,
        wrong_block_rows=int(bad.numel()),
        head_block_rows=fit, head_blocks=k, head_within_bound=head_ok,
        library_head_ms=lib_head_ms,
        kernel_head_ms=time_ms(lambda: ops.bsr_spmm_kernel(
            a_d[:k], r_d[:k], c_d[:k], xb, fit)),
        kernel_ms=time_ms(lambda: ops.bsr_spmm(x, a_d, r_d, c_d, nb)),
    )
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
