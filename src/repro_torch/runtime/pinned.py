"""Page-locked host arrays of their exact size, and the pool that reuses them
for the ∇A write-back's grad buffers inside the host cache's budget.

``pin_memory=True`` takes its blocks from PyTorch's caching host allocator,
which rounds each one up to a power of two (an 18 MB buffer pins 32 MB) and
keeps it after use. Here ordinary numpy memory is page-locked in place
instead (``cudaHostRegister``, portable and mapped): the array's own
pages, its bytes rounded up to a page, become page-locked, so the card reads
and writes the array in place through its mapped address and a
``non_blocking`` copy from it is real DMA. Unregistering waits for the card
(``cudaHostUnregister`` synchronises the device), so it is never done
under the cache's lock.
"""
from __future__ import annotations

import ctypes
import mmap
import threading
import weakref
from typing import Dict, List, Optional

import numpy as np

_PORTABLE_MAPPED = 1 | 2   # cudaHostRegisterPortable | cudaHostRegisterMapped


class _Block:
    """``nbytes`` of registered pages at ``addr``, inside ``raw``."""

    __slots__ = ("addr", "nbytes", "raw")

    def __init__(self, addr: int, nbytes: int, raw: np.ndarray):
        self.addr, self.nbytes, self.raw = addr, nbytes, raw


def _cudart():
    import torch

    return torch.cuda.cudart()


def _register(nbytes: int) -> _Block:
    import torch

    span = -(-max(nbytes, 1) // mmap.PAGESIZE) * mmap.PAGESIZE
    raw = np.empty(span + mmap.PAGESIZE, np.uint8)
    addr = raw.ctypes.data + (-raw.ctypes.data) % mmap.PAGESIZE
    torch.cuda.check_error(
        _cudart().cudaHostRegister(addr, span, _PORTABLE_MAPPED))
    return _Block(addr, nbytes, raw)


def _unregister(block: _Block) -> None:
    import torch

    torch.cuda.check_error(_cudart().cudaHostUnregister(block.addr))


def _array(block: _Block, shape: tuple, dtype, on_dead) -> np.ndarray:
    """``block`` as an array; ``on_dead(block)`` runs when the last reference
    to it and to every view of it goes."""
    # every view keeps ``flat`` alive: numpy collapses a view's base onto
    # the first array over the foreign buffer, not onto ``block.raw``
    flat = np.frombuffer(
        (ctypes.c_byte * max(block.nbytes, 1)).from_address(block.addr),
        np.uint8)
    weakref.finalize(flat, on_dead, block).atexit = False
    return flat[:block.nbytes].view(dtype).reshape(shape)


def _nbytes(shape: tuple, dtype) -> int:
    return int(np.prod(shape)) * np.dtype(dtype).itemsize


def page_locked_empty(shape: tuple, dtype) -> np.ndarray:
    """An uninitialised page-locked array of its own pages, unregistered when
    it goes."""
    return _array(_register(_nbytes(shape, dtype)), shape, dtype,
                  _unregister)


class PageLockedPool:
    """The engine's host grad buffers: page-locked blocks of their exact size,
    counted in ``cache``'s budget while in use or parked, and reused across
    layers and epochs.

    - :meth:`take` hands out a parked block of the same byte size, or None.
      A parked block's bytes are a reservation in the cache, which passes to
      the caller: it consumes it with ``put(..., reserved_bytes=...)`` or
      gives it up with ``unreserve``. :meth:`new`, for a caller that
      reserved first, takes a block set aside (below) of the same byte
      size, else registers one.
    - When the last reference to an array and its views goes, on whatever
      thread, its block is set aside and nothing else is done there.
    - :meth:`settle`, on the compute thread between units, parks each block
      set aside where the budget has room for it without evicting
      (``HostCache.reserve_idle``) and unregisters the others.
    - The pool is one of the cache's reclaimers: before the cache evicts an
      entry it takes back parked blocks, which the thread that asked for
      room unregisters.

    So the pool holds no page-locked memory beyond the budget but the blocks
    of arrays in use that the cache does not hold (degraded mode, spill
    writes in flight, as pageable buffers would be) and those set aside
    since the last :meth:`settle`. ``bytes`` counts every block registered
    and not unregistered, ``parked_bytes`` those parked, ``peak_bytes`` the
    most of ``bytes``. With ``pin=False`` (a CPU device) it hands out plain
    numpy arrays and parks nothing.
    """

    def __init__(self, cache, pin: bool):
        self.cache = cache
        self.pin = bool(pin)
        # a finalizer may run inside these locked sections (a collection)
        self._lock = threading.RLock()
        self._parked: Dict[int, List[_Block]] = {}
        self._dead: List[_Block] = []
        self._closed = False
        self.bytes = 0
        self.parked_bytes = 0
        self.peak_bytes = 0
        if self.pin:
            cache.add_reclaimer(self)

    def take(self, shape: tuple, dtype) -> Optional[np.ndarray]:
        if not self.pin:
            return None
        nb = _nbytes(shape, dtype)
        with self._lock:
            blocks = self._parked.get(nb)
            if not blocks:
                return None
            block = blocks.pop()
            self.parked_bytes -= nb
        return _array(block, shape, dtype, self._set_aside)

    def new(self, shape: tuple, dtype) -> np.ndarray:
        if not self.pin:
            return np.empty(shape, dtype)
        nb = _nbytes(shape, dtype)
        with self._lock:
            block = next((b for b in self._dead if b.nbytes == nb), None)
            if block is not None:
                self._dead.remove(block)
        if block is None:
            block = _register(nb)
            with self._lock:
                self.bytes += nb
                self.peak_bytes = max(self.peak_bytes, self.bytes)
        return _array(block, shape, dtype, self._set_aside)

    def _set_aside(self, block: _Block) -> None:
        with self._lock:
            if not self._closed:
                self._dead.append(block)
                return
        self._free(block)

    def _park(self, block: _Block) -> None:
        # under the cache's lock, with the block's bytes reserved there
        with self._lock:
            self._parked.setdefault(block.nbytes, []).append(block)
            self.parked_bytes += block.nbytes

    def settle(self) -> None:
        with self._lock:
            dead, self._dead = self._dead, []
        for block in dead:
            if not self.cache.reserve_idle(block.nbytes,
                                           lambda b=block: self._park(b)):
                self._free(block)

    def _free(self, block: _Block) -> None:
        _unregister(block)
        with self._lock:
            self.bytes -= block.nbytes

    # the cache's reclaimer
    def reclaim(self, need: int) -> List[_Block]:
        out, got = [], 0
        with self._lock:
            for blocks in self._parked.values():
                while blocks and got < need:
                    out.append(blocks.pop())
                    got += out[-1].nbytes
            self.parked_bytes -= got
        return out

    def release(self, blocks: List[_Block]) -> None:
        for block in blocks:
            self._free(block)

    def close(self) -> None:
        """Unregister every parked and set-aside block; a block still in use
        is unregistered when its array goes."""
        if self.pin:
            self.cache.remove_reclaimer(self)
        with self._lock:
            self._closed = True
            parked = [b for bs in self._parked.values() for b in bs]
            self._parked.clear()
            self.parked_bytes = 0
            dead, self._dead = self._dead, []
        for block in parked:
            self.cache.unreserve(block.nbytes)
        for block in parked + dead:
            self._free(block)
