"""Plain PyTorch versions of the embedding-bag kernel and of its backward.

:func:`embedding_bag_ref` is the reference package's ``embedding_bag_ref``
(``src/repro/kernels/embedding_bag/ref.py``) over fixed-size bags, with the
ids read as ``jnp.take`` reads them (the reference model's lookup): an id
in ``[-V, 0)`` wraps to ``id + V``, any other id outside ``[0, V)`` makes
its bag a NaN row. It sums the ``bag_size`` rows of each bag in ``k``
order, one gather and one add per ``k``, then divides by ``bag_size`` in
mean mode — the kernel's order, so the two agree bitwise on the card. The
wrapper in ``ops.py`` runs it on CPU tensors.

:func:`embedding_bag_backward_ref` is the backward: the table gradient is
dense and deterministic, each row the sum of its lookups' output
gradients in input order (``np.add.at``), with no atomics.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.kernels.gather_scatter.ref import scatter_add_ref

MODES = ("sum", "mean")


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode={mode!r} not in {MODES}")


def _rows(ids: torch.Tensor, V: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ids`` as row numbers (int64, an id in ``[-V, 0)`` wrapped) and the
    mask of ids that name a row; an invalid id's row number is 0."""
    r = ids.long()
    r = torch.where(r < 0, r + V, r)
    valid = (r >= 0) & (r < V)
    return torch.where(valid, r, 0), valid


def _divisor(bag_size: int, like: torch.Tensor) -> torch.Tensor:
    # a 0-d tensor on the data's device, so the division is a true division
    # on the card too (a Python scalar divisor becomes a multiplication by
    # its reciprocal there)
    return torch.tensor(float(bag_size), dtype=like.dtype, device=like.device)


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      mode: str = "sum") -> torch.Tensor:
    """``table`` ``(V, D)``, ``ids`` ``(n_bags, bag_size)`` -> ``(n_bags,
    D)``: each bag's rows summed in ``k`` order, divided by ``bag_size`` in
    mean mode. An empty bag (``bag_size == 0``) is a zero row."""
    _check_mode(mode)
    n_bags, bag_size = ids.shape
    V, D = table.shape
    if n_bags == 0 or bag_size == 0 or D == 0:
        return table.new_zeros((n_bags, D))
    rows, valid = _rows(ids, V)
    nan = table.new_full((), float("nan"))
    out = None
    for k in range(bag_size):
        x = torch.where(valid[:, k, None], table.index_select(0, rows[:, k]),
                        nan)
        out = x if out is None else out + x
    if mode == "mean":
        out = out / _divisor(bag_size, out)
    return out


def embedding_bag_backward_ref(
    d_out: torch.Tensor, ids: torch.Tensor, V: int, mode: str = "sum",
    scatter_add: Callable = scatter_add_ref,
) -> torch.Tensor:
    """The table gradient ``(V, D)`` of :func:`embedding_bag_ref` for the
    output gradient ``d_out`` ``(n_bags, D)``: row ``r`` is the sum, in
    input order, of ``d_out[b]`` (``/ bag_size`` in mean mode) over the
    lookups ``(b, k)`` of ``r``. Ids that name no row add nothing.

    The flat ids are stable-sorted, so equal rows meet in one run in input
    order, and ``scatter_add(grad, rows, values)`` (the plain
    ``scatter_add_ref``, or the ``scatter_add_`` kernel wrapper on the
    card) adds the runs into a zero gradient — bitwise ``np.add.at``.
    ``index_add_`` and PyTorch's embedding backward would use float atomics
    on the card."""
    _check_mode(mode)
    n_bags, bag_size = ids.shape
    D = d_out.shape[1]
    grad = d_out.new_zeros((V, D))
    if n_bags == 0 or bag_size == 0 or D == 0:
        return grad
    rows, valid = _rows(ids.reshape(-1), V)
    rows, order = torch.sort(rows, stable=True)
    # one value row per lookup (in place from here: at a training batch of
    # the published shape it is 2 M x 256 floats)
    vals = d_out.index_select(0, torch.div(order, bag_size,
                                           rounding_mode="floor"))
    if mode == "mean":
        vals.div_(_divisor(bag_size, vals))
    vals.masked_fill_(~valid.index_select(0, order)[:, None], 0.0)
    return scatter_add(grad, rows.to(torch.int32), vals)
