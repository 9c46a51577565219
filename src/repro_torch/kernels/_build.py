"""Build the port's CUDA kernels with ``nvcc`` and load them with ctypes.

Each kernel source (``kernels/<name>/csrc/<name>.cu``) is compiled at first
use into a shared library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o lib<name>.so <name>.cu

into ``kernels/build/<name>-<hash>/`` (listed in ``.gitignore``), keyed by a
hash of the sources and the flags, so an edited source rebuilds and an
unchanged one is reused within a checkout. ``nvcc``'s own output (``-Xptxas
-v``: registers, shared memory, spills per kernel) is kept beside the
library as ``build.log``. A failed build raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + [
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built"
        )
    return found


def sources(name: str) -> list:
    srcs = sorted((KERNELS_DIR / name / "csrc").glob("*.cu"))
    if not srcs:
        raise FileNotFoundError(f"no CUDA sources for kernel package {name!r}")
    return srcs


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for p in sources(name):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def _compile(name: str, lib: Path) -> None:
    """Run ``nvcc`` for ``name`` into ``lib`` (via a temporary file, so a
    half-written library is never loaded). Raises if it fails."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".so.tmp{os.getpid()}")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           *[str(p) for p in sources(name)]]
    res = subprocess.run(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
    (lib.parent / "build.log").write_text(" ".join(cmd) + "\n" + res.stdout)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed for {name} (exit {res.returncode}):\n{res.stdout}"
        )
    os.replace(tmp, lib)


def build_log(name: str) -> str:
    """``nvcc``'s output for the current build of ``name`` (``-Xptxas -v``)."""
    return (library_path(name).parent / "build.log").read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel package ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = library_path(name)
            if not path.is_file():
                _compile(name, path)
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
    return lib
