"""Fault-tolerant checkpointing (the port's ``train/checkpoint.py``).

Checkpoints are written atomically (tmp dir + per-file fsync + rename +
directory fsync) with a JSON manifest carrying the step, caller extras
(loss history, data cursor) and the shape and dtype of every leaf. Leaves
are flattened from trees (``repro_torch.tree``): nested dicts, lists and
modules' ``state_dict``s over tensors and ndarrays. Restore rebuilds each
tree from its template and puts each leaf on the device, and in the dtype,
of its template leaf — the saved artifact is device-independent.

Crash consistency contract: a checkpoint either exists completely (the
rename published it, and every file inside was fsynced first) or not at
all. ``latest_checkpoint`` only returns directories whose manifest parses
and whose referenced payload files exist, so a torn save — including a
``.tmp_*`` directory stranded by a crash mid-write — is never restored;
``_gc`` sweeps those strays up on the next successful save.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves, rebuild


def _fsync_path(path: str) -> None:
    """fsync a file (or directory — required for the rename itself to be
    durable on POSIX filesystems)."""
    flags = os.O_RDONLY
    if os.path.isdir(path) and hasattr(os, "O_DIRECTORY"):
        flags |= os.O_DIRECTORY
    try:
        fd = os.open(path, flags)
    except OSError:
        return  # platform without directory fds: best effort
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _flatten(tree) -> Dict[str, Any]:
    return dict(leaves(tree))


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(
    ckpt_dir: str,
    step: int,
    params,
    opt_state=None,
    extra: Optional[Dict[str, Any]] = None,
    keep: int = 3,
) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=ckpt_dir, prefix=".tmp_")
    trees = {"params": params}
    if opt_state is not None:
        trees["opt_state"] = opt_state
    manifest = {
        "step": int(step),
        "time": time.time(),  # repro: allow[R6] -- manifest wants wall clock
        "extra": extra or {},
        "leaves": {},
    }
    for tname, tree in trees.items():
        flat = _flatten(tree)
        arrays = {}
        for k, v in flat.items():
            arr = _to_numpy(v)
            arrays[k] = arr
            manifest["leaves"][f"{tname}:{k}"] = {
                "shape": list(arr.shape), "dtype": str(arr.dtype),
            }
        fname = os.path.join(tmp, f"{tname}.npz")
        np.savez(fname, **arrays)
        _fsync_path(fname)
    mpath = os.path.join(tmp, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    _fsync_path(tmp)               # payload durable before the publish
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)          # atomic publish
    _fsync_path(ckpt_dir)          # ... and the rename itself durable
    _gc(ckpt_dir, keep)
    return final


def _is_complete(path: str) -> bool:
    """A checkpoint directory is restorable iff its manifest parses and
    every payload file the manifest references exists — a torn save
    (crash between file writes, or a stray rename of garbage) fails this."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError):
        return False
    if not isinstance(manifest, dict) or "step" not in manifest:
        return False
    tnames = {k.split(":", 1)[0] for k in manifest.get("leaves", {})}
    return all(
        os.path.exists(os.path.join(path, f"{t}.npz")) for t in tnames
    )


def _gc(ckpt_dir: str, keep: int) -> None:
    for d in os.listdir(ckpt_dir):
        path = os.path.join(ckpt_dir, d)
        if d.startswith(".tmp_"):
            # stranded by a crash mid-save (our own tmp dir was already
            # renamed away) — never restorable, reclaim the space
            shutil.rmtree(path, ignore_errors=True)
        elif d.startswith("step_") and not _is_complete(path):
            shutil.rmtree(path, ignore_errors=True)
    steps = sorted(
        d for d in os.listdir(ckpt_dir) if d.startswith("step_")
    )
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Newest *complete* checkpoint (torn saves and ``.tmp_*`` strays are
    skipped, never restored)."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = sorted(
        d for d in os.listdir(ckpt_dir) if d.startswith("step_")
    )
    for d in reversed(steps):
        path = os.path.join(ckpt_dir, d)
        if _is_complete(path):
            return path
    return None


def _like(arr: np.ndarray, tpl):
    """``arr`` as the template leaf's kind: a tensor on the template's
    device in its dtype, an ndarray in its dtype, or a Python number."""
    if isinstance(tpl, torch.Tensor):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=tpl.device, dtype=tpl.dtype)
    if isinstance(tpl, np.ndarray):
        return arr.astype(tpl.dtype)
    return type(tpl)(arr.item())


def restore_checkpoint(
    path: str,
    params_template,
    opt_template=None,
) -> Tuple[Any, Any, int, Dict]:
    """Restore ``(params, opt_state, step, extra)``: each tree is rebuilt
    from its template (modules as updated deep copies), each leaf on its
    template leaf's device and in its dtype."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    def load_tree(tname, template):
        data = np.load(os.path.join(path, f"{tname}.npz"))
        values = {}
        for k, tpl in _flatten(template).items():
            arr = data[k]
            shape = tuple(getattr(tpl, "shape", ()))
            assert tuple(arr.shape) == shape, (
                f"{tname}:{k} shape {arr.shape} != template {shape}"
            )
            values[k] = _like(arr, tpl)
        return rebuild(template, values)

    params = load_tree("params", params_template)
    opt_state = None
    if opt_template is not None and os.path.exists(
        os.path.join(path, "opt_state.npz")
    ):
        opt_state = load_tree("opt_state", opt_template)
    return params, opt_state, manifest["step"], manifest.get("extra", {})
