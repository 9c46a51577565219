"""Wrapper over the CUDA embedding-bag kernel (``csrc/embedding_bag.cu``),
its launch plan and its ``torch.autograd.Function``.

On a CUDA tensor :func:`embedding_bag` checks its inputs, allocates the
output with ``torch.empty``, launches the kernel on the calling thread's
current stream with the plan of :func:`launch_plan` and adds one to
:data:`LAUNCHES`; a refused launch raises. On a CPU tensor it runs the
plain version in ``ref.py`` — the only reason it ever does. There is no
fallback from a CUDA tensor to the plain version.

The kernel gives a block a tile of consecutive bags and a part (``slab``
columns) of their rows. It deduplicates the tile's ids, copies each
distinct row's slab once into a ring of shared-memory stages, and sums
each bag from there in ``k`` order. :func:`launch_plan` fixes the route,
the tile, the ids per fill, the column split, the grid and the shared
memory from the shapes alone: no device data, no synchronisation.

The reference wrapper padded the feature axis to a 128-lane block (a TPU
layout constraint); this one takes any ``D``. The degenerate cases (no bag,
empty bags, ``D == 0``) return zeros without a launch.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map, register_sharding
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import _build
from repro_torch.kernels.embedding_bag import ref
from repro_torch.kernels.gather_scatter.ops import scatter_add_
from repro_torch.kernels.gather_scatter.ref import scatter_add_ref

# launches since the last reset_launches(); bumped only where the kernel is
# launched (never by the plain version)
LAUNCHES: Dict[str, int] = {"embedding_bag": 0}

KERNEL_MODES = ("kernel", "reference")

# the kernel's constants (csrc/embedding_bag.cu): ids a fill deduplicates
# (one a producer thread), consumer threads (each sums two values of a bag:
# columns c and c + half a part), and the stages of its ring
FILL_IDS = 128
CONSUMERS = 256
STAGES = 3                    # one block a SM
STAGES_TWO_BLOCKS = 2         # two blocks a SM
ID_AHEAD = 4                  # items ahead a producer copies its ids
SMEM_LIMIT = 232448           # dynamic shared memory a block may have
# the plan's constants (chosen on the H100: scripts/pt_embedding_bag.py)
TILE_BAGS = 8                 # consecutive bags a block deduplicates
# calls of at most this many bags run two blocks a SM with smaller stages
# (their per-item cost, not the memory, bounds them); larger ones one
# block a SM with stages that hold a tile's rows at 512 bytes each. The
# measured shapes either side: the training batch's 131,072 user bags
# (two blocks 19% faster) and a corpus chunk's 262,144 (one block 2%
# faster); the limit sits between them so a batch a little larger than
# the training one keeps its launch shape
TWO_BLOCKS_MAX_BAGS = 196608
# except small calls of full items (128 ids): one block a SM, whose 64 KB
# stages take a tile of distinct rows in two fills of 512-byte copies
# where 48 KB stages take three of 384 bytes (serve_p99's 4,096 bags of 16
# uniform ids: 3-4% faster); at 64 ids an item (the resume batches' bags
# of 8) two blocks stay faster. The limit sits between the measured
# 4,096 and 65,536 bags
ONE_BLOCK_SMALL_BAGS = 16384
STAGE_BYTES = {1: 64 * 1024, 2: 48 * 1024}   # by blocks a SM
MIN_ITEMS_PER_SM = 2          # below this many items a SM, split columns
MIN_SLAB = 32                 # the narrowest split: 128 bytes of a row
SMS = 132                     # H100 SXM

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_bound = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    """The kernel library with its C signature set (built on first use)."""
    global _bound
    if _bound is None:
        lib = _build.load("embedding_bag")
        lib.embedding_bag_f32.argtypes = [
            _P, _P, _P, _I64, _I64, _I64, _I64, _I32,
            _I32, _I32, _I32, _I32, _I32, _I32, _I32, _I64, _I64, _P,
        ]
        lib.embedding_bag_f32.restype = ctypes.c_int
        _bound = lib
    return _bound


def _meta_bytes(stages: int) -> int:
    """Shared memory ahead of the stages (the kernel's ``meta_bytes``)."""
    n = 48 * stages + 16 * FILL_IDS + 4 * FILL_IDS * (stages + ID_AHEAD) + 4 * (
        FILL_IDS // 32)
    return -(-n // 128) * 128


def smem_bytes(blocks: int, stage: int, slab: int) -> int:
    """A block's shared memory: the metadata, the ring of ``stage``-float
    stages (``STAGES`` deep at one block a SM, else ``STAGES_TWO_BLOCKS``)
    and one NaN row of ``slab`` floats."""
    stages = STAGES if blocks == 1 else STAGES_TWO_BLOCKS
    return _meta_bytes(stages) + (stages * stage + slab) * 4


@dataclass(frozen=True)
class BagPlan:
    """One launch: ``vec`` moves 16-byte values (else single floats);
    ``tile`` bags a block deduplicates together; ``chunk`` ids of a bag an
    item holds (``bag_size``, or fewer for a bag that spans items, then
    ``tile == 1``); ``slab`` columns a part; ``parts`` parts a tile;
    ``stage`` floats a stage of the ring holds; ``blocks`` a SM (1: a
    ``STAGES``-deep ring, 2: ``STAGES_TWO_BLOCKS``); ``grid`` persistent
    blocks; ``smem`` bytes of shared memory each."""
    vec: bool
    tile: int
    chunk: int
    slab: int
    parts: int
    stage: int
    blocks: int
    grid: int
    smem: int

    @property
    def route(self) -> str:
        return "vec4" if self.vec else "scalar"


@functools.lru_cache(maxsize=256)
def launch_plan(n_bags: int, bag_size: int, D: int, aligned: bool,
                sms: int = SMS) -> BagPlan:
    """The kernel's launch for ``n_bags`` bags of ``bag_size`` ids into a
    ``(V, D)`` table; ``aligned``: the table and output are 16-byte aligned.
    A function of the shapes alone.

    Route: 16-byte values where ``D % 4 == 0`` and ``aligned``, else single
    floats. An item holds ``tile`` whole bags (at most ``FILL_IDS`` ids), or
    ``FILL_IDS`` ids of one bag where a bag has more. ``slab``: as many
    columns as the consumers sum in one fill (two values each, ``CONSUMERS
    // tile`` threads a bag), at most ``D``; for a bag that spans items, no
    more than a stage holds for every id of the item. The kernel stages an
    item's distinct rows at that width where they fit a stage, and in
    narrower fills where they do not. Two blocks a SM for calls of at most
    ``TWO_BLOCKS_MAX_BAGS`` bags, else one, and one for calls of at most
    ``ONE_BLOCK_SMALL_BAGS`` bags whose items hold ``FILL_IDS`` ids; stages
    of ``STAGE_BYTES`` by blocks. Where the tiles give fewer than ``MIN_ITEMS_PER_SM`` items a
    SM of the ``sms``, the slab is halved (down to ``MIN_SLAB``) so the
    call spreads over the card. The grid is that many persistent blocks a
    SM, or one an item where there are fewer."""
    if min(n_bags, bag_size, D) <= 0:
        raise ValueError(f"no launch for {n_bags} bags of {bag_size} ids, "
                         f"D {D}")
    vec = bool(aligned) and D % 4 == 0
    W = 4 if vec else 1
    chunk = min(bag_size, FILL_IDS)
    tile = 1 if bag_size > FILL_IDS else max(1, min(TILE_BAGS,
                                                    FILL_IDS // bag_size))
    small_full = n_bags <= ONE_BLOCK_SMALL_BAGS and tile * chunk == FILL_IDS
    blocks = 1 if n_bags > TWO_BLOCKS_MAX_BAGS or small_full else 2
    stage = STAGE_BYTES[blocks] // 4 // W * W
    slab = 2 * (CONSUMERS // tile) * W
    if chunk < bag_size:
        slab = min(slab, stage // chunk // W * W)
    slab = max(W, min(slab, -(-D // W) * W))
    parts = -(-D // slab)
    n_tiles = -(-n_bags // tile)
    while n_tiles * parts < MIN_ITEMS_PER_SM * sms and slab > MIN_SLAB:
        slab = max(MIN_SLAB, slab // 2 // W * W)
        parts = -(-D // slab)
    grid = min(n_tiles * parts, sms * blocks)
    return BagPlan(vec, tile, chunk, slab, parts, stage, blocks, grid,
                   smem_bytes(blocks, stage, slab))


def _check(name: str, t: torch.Tensor, dtype: torch.dtype,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


@functools.lru_cache(maxsize=None)
def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  mode: str = "sum") -> torch.Tensor:
    """``out[b] = sum_k table[ids[b, k]]`` over fixed-size bags, divided by
    ``bag_size`` in mean mode: ``table`` ``(V, D)`` float32, ``ids``
    ``(n_bags, bag_size)`` int32 -> ``(n_bags, D)`` float32.

    Ids are read as ``jnp.take`` reads them: an id in ``[-V, 0)`` wraps to
    ``id + V``, any other id outside ``[0, V)`` makes its bag a NaN row."""
    ref._check_mode(mode)
    if table.dim() != 2 or ids.dim() != 2:
        raise ValueError(
            f"embedding_bag wants table (V, D) and ids (n_bags, bag_size); "
            f"got {tuple(table.shape)} and {tuple(ids.shape)}"
        )
    (V, D), (n_bags, bag_size) = table.shape, ids.shape
    if n_bags == 0 or bag_size == 0 or D == 0:
        return table.new_zeros((n_bags, D))
    if V == 0:
        raise ValueError(f"{n_bags} bags of {bag_size} ids into an empty table")
    if not table.is_cuda:
        return ref.embedding_bag_ref(table, ids, mode)
    dev = table.device
    _check("table", table, torch.float32, dev)
    _check("ids", ids, torch.int32, dev)
    return torch.ops.repro_torch.embedding_bag_fwd(table, ids, mode == "mean")


# The launch as an operator of its own: a fake tensor (the dry run's trace)
# gets the output's shape from the fake implementation and launches nothing,
# the FLOP counter reads the formula below and a DTensor the sharding rule.

@torch.library.custom_op("repro_torch::embedding_bag_fwd", mutates_args=())
def _embedding_bag_fwd(table: torch.Tensor, ids: torch.Tensor,
                       mean: bool) -> torch.Tensor:
    (V, D), (n_bags, bag_size) = table.shape, ids.shape
    dev = table.device
    out = torch.empty((n_bags, D), dtype=table.dtype, device=dev)
    plan = launch_plan(n_bags, bag_size, D, table.data_ptr() % 16 == 0
                       and out.data_ptr() % 16 == 0, sms=_sms(dev))
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib().embedding_bag_f32(
        table.data_ptr(), ids.data_ptr(), out.data_ptr(), V, n_bags,
        bag_size, D, int(mean), int(plan.vec), plan.tile,
        plan.chunk, plan.slab, plan.parts, plan.stage, plan.blocks, plan.grid,
        plan.smem, stream,
    )
    if err != 0:
        raise RuntimeError(f"embedding_bag kernel launch failed: cudaError "
                           f"{err} ({plan})")
    LAUNCHES["embedding_bag"] += 1
    return out


@_embedding_bag_fwd.register_fake
def _(table, ids, mean):
    return table.new_empty((ids.shape[0], table.shape[1]))


@register_flop_formula(torch.ops.repro_torch.embedding_bag_fwd)
def _bag_flops(table_shape, ids_shape, mean, *args, out_shape=None,
               **kwargs) -> int:
    """One add per looked-up element."""
    return ids_shape[0] * ids_shape[1] * table_shape[1]


@register_sharding(torch.ops.repro_torch.embedding_bag_fwd.default)
def _bag_sharding(table, ids, mean):
    """The bags shard (the table whole), or the columns (the ids whole)."""
    return [([Replicate()], [Replicate(), Replicate(), None]),
            ([Shard(0)], [Replicate(), Shard(0), None]),
            ([Shard(1)], [Shard(1), Replicate(), None])]


class EmbeddingBag(torch.autograd.Function):
    """The bag reduction with a dense, deterministic table gradient:
    ``EmbeddingBag.apply(table, ids, mode, kernels)``.

    ``kernels="kernel"``: the forward is :func:`embedding_bag` (the kernel on
    a CUDA tensor) and the backward writes the rows with the ``scatter_add_``
    kernel wrapper; ``"reference"``: the plain versions of both, on any
    device (an explicit request, never a fallback). The two agree bitwise.
    The reference has no backward kernel for the bag, so the backward is
    :func:`ref.embedding_bag_backward_ref` around the scatter; ``ids`` gets
    no gradient."""

    @staticmethod
    def forward(ctx, table: torch.Tensor, ids: torch.Tensor, mode: str,
                kernels: str) -> torch.Tensor:
        if kernels not in KERNEL_MODES:
            raise ValueError(f"kernels={kernels!r} not in {KERNEL_MODES}")
        fwd = embedding_bag if kernels == "kernel" else ref.embedding_bag_ref
        out = fwd(table, ids, mode)
        ctx.save_for_backward(ids)
        ctx.V, ctx.mode, ctx.kernels = table.shape[0], mode, kernels
        return out

    @staticmethod
    def backward(ctx, d_out: torch.Tensor):
        (ids,) = ctx.saved_tensors
        scatter = scatter_add_ if ctx.kernels == "kernel" else scatter_add_ref

        def backward(d_out, ids):
            return ref.embedding_bag_backward_ref(d_out, ids, ctx.V,
                                                  ctx.mode, scatter)

        if not isinstance(d_out, DTensor):
            return backward(d_out, ids), None, None, None
        # over a mesh, rank by rank: a split of the bags gives each rank a
        # partial sum of the table's gradient, a split of the columns its
        # columns of it
        d_pl, i_pl, g_pl = [], [], []
        for p in d_out.placements:
            col = isinstance(p, Shard) and p.dim == 1
            row = isinstance(p, Shard) and p.dim == 0
            d_pl.append(p if row or col else Replicate())
            i_pl.append(Shard(0) if row else Replicate())
            g_pl.append(Partial() if row else d_pl[-1])
        grad = local_map(backward, out_placements=g_pl,
                         in_placements=(tuple(d_pl), tuple(i_pl)),
                         device_mesh=d_out.device_mesh,
                         redistribute_inputs=True)(d_out, ids)
        return grad, None, None, None
