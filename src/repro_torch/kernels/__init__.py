"""Hand-written Hopper kernels for the port's hot paths.

Each subpackage ships ``csrc/*.cu`` (CUDA C++ for sm_90a with a plain C
interface), ``ops.py`` (the ctypes-bound wrappers, their checks and launch
counts) and ``ref.py`` (the plain PyTorch versions the wrappers run on CPU
tensors, plus numpy oracles). ``_build.py`` compiles the sources with
``nvcc`` at first use; ``dispatch.py`` routes the engine's hot loops to the
kernels or to the reference path by mode and device.

- gather_scatter: ``gather_rows`` (forward and backward regather of the
  staged partition stack), ``gather_aggregate`` (one-kernel GCN
  gather+aggregate) and ``scatter_add_`` (the backward's sorted grad
  write-back).
"""
