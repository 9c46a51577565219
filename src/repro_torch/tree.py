"""Nested containers of tensors ("trees") for the optimizer and checkpoints.

The reference package keeps parameters and optimizer state as JAX pytrees;
the port keeps parameters as ``nn.Module``s and state as plain nested dicts
and lists of tensors. A tree here is any nesting of ``dict``, ``list``,
``tuple`` and ``nn.Module`` (read through its ``state_dict``) over leaves
(tensors, ndarrays, numbers). Leaves are named by their path, joined with
``/`` (a module's ``state_dict`` key is one path part).
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch import nn


def _join(prefix: str, key) -> str:
    return f"{prefix}/{key}" if prefix else str(key)


def leaves(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(path, leaf)`` pairs in traversal order (dict insertion order,
    list order, ``state_dict`` order)."""
    if isinstance(tree, nn.Module):
        return [(_join(prefix, k), v)
                for k, v in tree.state_dict(keep_vars=True).items()]
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += leaves(v, _join(prefix, k))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += leaves(v, _join(prefix, i))
        return out
    return [(prefix, tree)]


def rebuild(template, values: Dict[str, Any], prefix: str = ""):
    """A tree shaped like ``template`` with the leaf at each path taken from
    ``values``. A module comes back as a deep copy of the template with its
    ``state_dict`` entries overwritten in place (the template is left
    unchanged); plain containers come back as new containers."""
    if isinstance(template, nn.Module):
        mod = copy.deepcopy(template)
        with torch.no_grad():
            for k, t in mod.state_dict(keep_vars=True).items():
                t.copy_(values[_join(prefix, k)])
        return mod
    if isinstance(template, dict):
        return {k: rebuild(v, values, _join(prefix, k))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(rebuild(v, values, _join(prefix, i))
                              for i, v in enumerate(template))
    return values[prefix]


def plain(tree, fn: Callable[[Any], Any] = lambda x: x):
    """``tree`` with every module replaced by a dict of its ``state_dict``
    entries and ``fn`` applied to each leaf (e.g. ``torch.zeros_like``)."""
    if isinstance(tree, nn.Module):
        return {k: fn(v) for k, v in tree.state_dict(keep_vars=True).items()}
    if isinstance(tree, dict):
        return {k: plain(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(plain(v, fn) for v in tree)
    return fn(tree)
