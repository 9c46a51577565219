"""Wrapper over the CUDA flash-attention kernel (``csrc/flash_attention.cu``).

On CUDA tensors :func:`flash_attention` checks its inputs, allocates the
output with ``torch.empty``, launches the kernel on the current stream and
adds one to :data:`LAUNCHES`; a refused launch raises. On CPU tensors it
runs :func:`~repro_torch.kernels.flash_attention.ref.flash_attention_ref` —
the only reason it ever does. There is no fallback from a CUDA tensor to
the plain version.

The kernel is forward-only, as the Pallas kernel is: with grad mode on and
any of q, k, v requiring grad, :func:`flash_attention` raises on every
device (the raw launch's output would carry no ``grad_fn``, so no gradient
would reach q, k or v). Training attends through the plain
``chunked_attention``, the reference's own training path.

The reference wrapper (``src/repro/kernels/flash_attention/ops.py``)
flattened the heads into ``B * Hq`` rows, repeated each KV head ``G`` times
and cut ``S`` into blocks of 128; this one passes q, k and v in their own
layouts, and the kernel reads KV head ``h // G`` for query head ``h`` and
masks the ragged edges itself.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import numpy as np
import torch
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.experimental import register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref

# launches since the last reset_launches(); bumped only where the kernel is
# launched (never by the plain version)
LAUNCHES: Dict[str, int] = {"flash_attention": 0}

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 128

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_bound = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    """The kernel library with its C signature set (built on first use)."""
    global _bound
    if _bound is None:
        lib = _build.load("flash_attention")
        lib.flash_attention_fwd.argtypes = [
            _P, _P, _P, _P, ctypes.c_int, _I64, _I64, _I64, _I64, _I64, _I64,
            ctypes.c_int, _I64, _P,
        ]
        lib.flash_attention_fwd.restype = ctypes.c_int
        _bound = lib
    return _bound


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(
            f"flash_attention wants q (B, Sq, Hq, D) and k, v (B, Skv, Hkv, "
            f"D); got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, Hq, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(
            f"k and v must both be (B={B}, Skv, Hkv, D={D}); got "
            f"{tuple(k.shape)} and {tuple(v.shape)}")
    Skv, Hkv = k.shape[1], k.shape[2]
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    if window is not None and (window < 1 or Sq > Skv + window - 1):
        raise ValueError(
            f"window={window} leaves query rows with no key to attend to "
            f"(Sq={Sq}, Skv={Skv}: rows from Skv + window - 1 on); the "
            f"reference would return the mean of v there, and this kernel "
            f"refuses such shapes")
    if Skv == 0 and Sq > 0:
        raise ValueError("no keys (Skv = 0)")


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} is {t.dtype}, expected {dtype} (q's dtype)")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """Causal / sliding-window GQA attention: q ``(B, Sq, Hq, D)``, k and v
    ``(B, Skv, Hkv, D)`` -> ``(B, Sq, Hq, D)`` in q's dtype (float32 or
    bfloat16, the same for all three). Positions start at 0 for q and k.
    ``Sq`` and ``Skv`` are any lengths; ``D <= 128`` on the card. Shapes
    that leave a query row with no unmasked key (a window that ends before
    the last key it could reach) are refused on every device, and so are
    inputs that require grad while grad mode is on (the kernel has no
    backward)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention is forward-only: q, k or v requires grad with "
            "grad mode on, and the kernel's output would carry no gradient; "
            "run it under torch.no_grad() or train through "
            "chunked_attention")
    _check_shapes(q, k, v, window)
    dev = q.device
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q on {dev}")
    if q.dtype not in DTYPES:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if B == 0 or Sq == 0 or Hq == 0 or D == 0:
        return q.new_zeros(q.shape)
    if not q.is_cuda:
        for name, t in (("k", k), ("v", v)):
            if t.dtype != q.dtype:
                raise TypeError(f"{name} is {t.dtype}, expected {q.dtype} "
                                f"(q's dtype)")
        return ref.flash_attention_ref(q, k, v, causal, window)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check(name, t, q.dtype, dev)
    if D > MAX_D:
        raise ValueError(f"head dim D={D} > {MAX_D} is not supported by the "
                         f"kernel")
    # a window wider than every distance is no window
    w = -1 if window is None or window > Sq + Skv else int(window)
    return torch.ops.repro_torch.flash_attention_fwd(q, k, v, bool(causal), w)


# The launch as an operator of its own: a fake tensor (the dry run's trace)
# gets the output's shape from the fake implementation and launches nothing,
# the FLOP counter reads the formula below and a DTensor the sharding rule.

@torch.library.custom_op("repro_torch::flash_attention_fwd", mutates_args=())
def _flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, window: int) -> torch.Tensor:
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _lib().flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        DTYPES[q.dtype], B, Sq, Skv, Hq, Hkv, D, int(causal), window, stream,
    )
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed: cudaError {err}")
    LAUNCHES["flash_attention"] += 1
    return out


@_flash_attention_fwd.register_fake
def _(q, k, v, causal, window):
    return torch.empty_like(q)


def attended_pairs(Sq: int, Skv: int, causal: bool, window: int) -> int:
    """The (query, key) pairs a call attends: query ``i`` sees keys ``j <=
    i`` when ``causal``, and ``i - j < window`` when ``window > 0``."""
    i = np.arange(Sq, dtype=np.int64)
    hi = np.minimum(i, Skv - 1) if causal else np.full(Sq, Skv - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else np.zeros(Sq,
                                                                  np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


@register_flop_formula(torch.ops.repro_torch.flash_attention_fwd)
def _flash_flops(q_shape, k_shape, v_shape, causal, window, *args,
                 out_shape=None, **kwargs) -> int:
    """Two products a pair and head: ``q k^T`` (2 D) and ``p v`` (2 D)."""
    B, Sq, Hq, D = q_shape
    return B * Hq * attended_pairs(Sq, k_shape[1], causal, window) * 4 * D


@register_sharding(torch.ops.repro_torch.flash_attention_fwd.default)
def _flash_sharding(q, k, v, causal, window):
    """Batch and heads shard (a query head and its KV head on one rank),
    the sequence stays whole."""
    return [([Replicate()], [Replicate()] * 3 + [None, None]),
            ([Shard(0)], [Shard(0)] * 3 + [None, None]),
            ([Shard(2)], [Shard(2)] * 3 + [None, None])]
