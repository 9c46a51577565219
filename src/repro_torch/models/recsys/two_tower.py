"""Two-tower retrieval model (YouTube/RecSys'19) with in-batch softmax — the
port of the reference's ``models/recsys/two_tower.py``.

Each tower averages its fields' multi-hot bags of embedding rows (the
``embedding_bag`` kernel on the card, through the ``EmbeddingBag`` autograd
function and its deterministic ``scatter_add_`` backward), then runs a
ReLU MLP and L2-normalises the result. The embedding tables are this
family's memory-capacity wall: at the published widths each holds 10 M rows
of 256 floats (10.24 GB).

The parameters are a :class:`TwoTower` ``nn.Module`` (``user_table``,
``item_table`` and two ``nn.ModuleList`` towers of :class:`Dense` layers
with ``w (in, out)`` and ``b``), so ``repro_torch.tree``, ``optim.adamw``
and ``train.checkpoint`` take it as they take the GNN layers. The functions
take the model where the reference takes its params pytree.

``kernels`` picks the bag reduction's route: ``"auto"`` runs the kernel on a
CUDA tensor and the plain version on a CPU one (as
``kernels/dispatch.py`` does); ``"kernel"`` the kernel wrapper (which runs
the plain version only for a CPU tensor); ``"reference"`` the plain
version on any device — an explicit request, which the card's smoke uses
to hold the kernel path against it bitwise, never a fallback.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels.embedding_bag import EmbeddingBag
from repro_torch.kernels.gather_scatter.ref import scatter_add_ref
from repro_torch.models.lm.layers import init_dense
from repro_torch.models.lm.sharding import DB, constrain, on_shards, rows_of

KERNEL_ROUTES = ("auto", "kernel", "reference")


@dataclasses.dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    embed_dim: int = 256
    tower_mlp: Tuple[int, ...] = (1024, 512, 256)
    n_user_fields: int = 8        # multi-hot categorical fields per user
    n_item_fields: int = 4
    bag_size: int = 16            # ids per multi-hot bag (padded)
    user_vocab: int = 2_000_000
    item_vocab: int = 2_000_000
    dtype: torch.dtype = torch.float32
    temperature: float = 0.05


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  bag_ids: torch.Tensor, n_bags: int, mode: str = "sum",
                  weights: torch.Tensor = None) -> torch.Tensor:
    """EmbeddingBag over arbitrary bags: ``ids`` ``(N,)`` rows of ``table``
    (read as ``jnp.take`` reads them: ``[-V, 0)`` wraps, any other id
    outside ``[0, V)`` gives a NaN row), ``bag_ids`` ``(N,)`` the bag of
    each lookup, reduced to ``(n_bags, dim)``; ``mode`` sum or mean (over
    each bag's count, at least 1), ``weights`` ``(N,)`` scales each row.

    A plain, deterministic segment sum: the lookups are stable-sorted by
    bag and added in input order (``scatter_add_ref``, bitwise
    ``np.add.at``), on either device. The towers do not use it: their bags
    have one fixed size and go through :class:`EmbeddingBag`."""
    if mode not in ("sum", "mean"):
        raise ValueError(f"mode={mode!r} not in ('sum', 'mean')")
    V = table.shape[0]
    r = ids.long()
    r = torch.where(r < 0, r + V, r)
    valid = (r >= 0) & (r < V)
    rows = torch.where(valid[:, None],
                       table.index_select(0, torch.where(valid, r, 0)),
                       table.new_full((), float("nan")))
    if weights is not None:
        rows = rows * weights[:, None]
    seg, order = torch.sort(bag_ids.long(), stable=True)
    out = scatter_add_ref(table.new_zeros((n_bags, table.shape[1])), seg,
                          rows.index_select(0, order))
    if mode == "mean":
        cnt = torch.bincount(seg, minlength=n_bags).to(table.dtype)
        out = out / torch.clamp_min(cnt, 1.0)[:, None]
    return out


class Dense(nn.Module):
    """One tower layer, ``x @ w + b`` with ``w`` ``(in, out)`` (the
    reference's layout)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


class TwoTower(nn.Module):
    """The model's parameters: ``user_table`` ``(user_vocab, embed)``,
    ``item_table`` ``(item_vocab, embed)``, and the ``user_mlp`` /
    ``item_mlp`` towers (``nn.ModuleList`` of :class:`Dense`)."""

    def __init__(self, user_table: torch.Tensor, item_table: torch.Tensor,
                 user_mlp: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                 item_mlp: Sequence[Tuple[torch.Tensor, torch.Tensor]]):
        super().__init__()
        self.user_table = nn.Parameter(user_table)
        self.item_table = nn.Parameter(item_table)
        self.user_mlp = nn.ModuleList(Dense(w, b) for w, b in user_mlp)
        self.item_mlp = nn.ModuleList(Dense(w, b) for w, b in item_mlp)


def _tower_init(gen: torch.Generator, cfg: TwoTowerConfig, n_fields: int,
                device) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    dims = [n_fields * cfg.embed_dim] + list(cfg.tower_mlp)
    return [
        (init_dense(gen, (dims[i], dims[i + 1]), dtype=cfg.dtype,
                    device=device),
         torch.zeros((dims[i + 1],), dtype=cfg.dtype, device=device))
        for i in range(len(cfg.tower_mlp))
    ]


def init_two_tower(cfg: TwoTowerConfig, generator: torch.Generator,
                   device=None) -> TwoTower:
    """Random weights from ``generator`` on ``device`` (the generator's
    device by default): the tables normal × 0.01, the tower weights
    normal × ``1/sqrt(fan_in)``, the biases zero — the reference's rule,
    drawn in the order user table, item table, user tower, item tower."""
    device = generator.device if device is None else device
    user_table = init_dense(generator, (cfg.user_vocab, cfg.embed_dim),
                            scale=0.01, dtype=cfg.dtype, device=device)
    item_table = init_dense(generator, (cfg.item_vocab, cfg.embed_dim),
                            scale=0.01, dtype=cfg.dtype, device=device)
    return TwoTower(
        user_table, item_table,
        _tower_init(generator, cfg, cfg.n_user_fields, device),
        _tower_init(generator, cfg, cfg.n_item_fields, device),
    )


def _route(kernels: str, table: torch.Tensor) -> str:
    if kernels not in KERNEL_ROUTES:
        raise ValueError(f"kernels={kernels!r} not in {KERNEL_ROUTES}")
    if kernels == "auto":
        return "kernel" if table.is_cuda else "reference"
    return kernels


def _mlp(layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
    for i, l in enumerate(layers):
        x = x @ l.w + l.b
        if i < len(layers) - 1:
            x = torch.relu(x)
    # L2-normalised output embeddings (standard for dot retrieval); over a
    # mesh the rows whole first (the norm's backward writes in place)
    x = constrain(x, DB, None)
    return x / torch.clamp_min(
        torch.linalg.vector_norm(x, dim=-1, keepdim=True), 1e-6)


def _tower(table: torch.Tensor, mlp: nn.ModuleList, ids: torch.Tensor,
           cfg: TwoTowerConfig, n_fields: int, kernels: str) -> torch.Tensor:
    """``ids`` ``(B, n_fields, bag_size)`` int32: the mean of each field's
    bag of rows, the fields side by side, through the tower."""
    B = ids.shape[0]
    bags = ids.reshape(B * n_fields, cfg.bag_size).to(torch.int32)
    emb = EmbeddingBag.apply(table, bags.contiguous(), "mean",
                             _route(kernels, table))
    emb = rows_of(emb, B)        # a mesh's split of the bags, per user
    # pinned, so that the tower's gradient comes back in rows the view
    # can split
    return _mlp(mlp, constrain(emb.reshape(B, n_fields * cfg.embed_dim),
                               DB, None))


def user_embedding(model: TwoTower, user_ids: torch.Tensor,
                   cfg: TwoTowerConfig, kernels: str = "auto") -> torch.Tensor:
    return _tower(model.user_table, model.user_mlp, user_ids, cfg,
                  cfg.n_user_fields, kernels)


def item_embedding(model: TwoTower, item_ids: torch.Tensor,
                   cfg: TwoTowerConfig, kernels: str = "auto") -> torch.Tensor:
    return _tower(model.item_table, model.item_mlp, item_ids, cfg,
                  cfg.n_item_fields, kernels)


def two_tower_loss(model: TwoTower, user_ids: torch.Tensor,
                   item_ids: torch.Tensor, cfg: TwoTowerConfig,
                   kernels: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """In-batch sampled softmax: ``(loss, acc)``, the mean negative
    log-likelihood of each user's own item among the batch's items and the
    share of users whose own item scores highest."""
    u = user_embedding(model, user_ids, cfg, kernels)      # (B, d)
    v = item_embedding(model, item_ids, cfg, kernels)      # (B, d)
    logits = (u @ v.T) / cfg.temperature                   # (B, B)
    if isinstance(logits, DTensor):
        return _in_batch_on_shards(logits)
    labels = torch.arange(u.shape[0], device=u.device)
    lp = torch.log_softmax(logits, dim=-1)
    loss = -lp.diagonal().mean()
    acc = (logits.argmax(dim=-1) == labels).to(torch.float32).mean()
    return loss, acc


def _in_batch_on_shards(logits):
    """:func:`two_tower_loss`'s loss and accuracy over a mesh, rank by
    rank: each rank's users (a split of the rows) against every item, its
    own items at its row offset, the means averaged over the ranks."""
    mesh = logits.device_mesh
    split = [isinstance(p, Shard) and p.dim == 0 for p in logits.placements]
    rows, first = logits.shape[0], 0
    for i, s in enumerate(split):
        if s:
            rows //= mesh.size(i)
            first = first * mesh.size(i) + mesh.get_local_rank(i)
    first *= rows

    def local(lg):
        own = first + torch.arange(lg.shape[0], device=lg.device)
        lp = torch.log_softmax(lg, dim=-1)
        loss = -lp.gather(1, own[:, None]).mean()
        return loss, (lg.argmax(dim=-1) == own).to(torch.float32).mean()

    pl = tuple(Shard(0) if s else Replicate() for s in split)
    avg = [Partial("avg") if s else Replicate() for s in split]
    return on_shards(local, (logits,), (pl,), (avg, avg))


def two_tower_value_and_grad(
    model: TwoTower, user_ids: torch.Tensor, item_ids: torch.Tensor,
    cfg: TwoTowerConfig, kernels: str = "auto",
) -> Tuple[Tuple[torch.Tensor, torch.Tensor], Dict[str, torch.Tensor]]:
    """``((loss, acc), grads)`` with ``grads`` one tensor per parameter,
    keyed by its ``state_dict`` name in ``state_dict`` order (the layout
    ``optim.adamw`` zips against the model): the port's
    ``jax.value_and_grad(..., has_aux=True)`` of :func:`two_tower_loss`.
    The loss and accuracy come back detached."""
    names, params = zip(*model.named_parameters())
    with torch.enable_grad():
        loss, acc = two_tower_loss(model, user_ids, item_ids, cfg, kernels)
        grads = torch.autograd.grad(loss, params)
    return (loss.detach(), acc), dict(zip(names, grads))


@torch.no_grad()
def serve_user_tower(model: TwoTower, user_ids: torch.Tensor,
                     cfg: TwoTowerConfig, kernels: str = "auto") -> torch.Tensor:
    """Online-inference path (serve_p99 / serve_bulk shapes)."""
    return user_embedding(model, user_ids, cfg, kernels)


@torch.no_grad()
def score_candidates(model: TwoTower, user_ids: torch.Tensor,
                     cand_item_emb: torch.Tensor, cfg: TwoTowerConfig,
                     top_k: int = 100, kernels: str = "auto"):
    """retrieval_cand shape: one (or few) queries × 1 M candidate item
    embeddings — one matrix product and ``torch.topk`` (sorted descending),
    not a loop. Returns ``(values, indices)``, each ``(B, top_k)``."""
    u = user_embedding(model, user_ids, cfg, kernels)       # (B, d)
    scores = u @ cand_item_emb.T                            # (B, N)
    return torch.topk(scores, top_k, dim=-1, largest=True, sorted=True)
