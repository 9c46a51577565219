"""Device resolution shared by the port's entry points."""
from __future__ import annotations

from typing import Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on. ``None`` means the CUDA card and
    raises when there is none — the port never drops to the CPU on its own;
    a caller that wants the CPU (the tests) passes ``device="cpu"``. A bare
    ``"cuda"`` is pinned to the current device index so that device
    comparisons against tensors' ``.device`` hold."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def torch_dtype(np_dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (``np.float32`` -> ``torch.float32``)."""
    return torch.from_numpy(np.empty(0, np_dtype)).dtype
