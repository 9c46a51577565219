"""The port's pipeline runtime: the pinned/event-gated ``BufferPool``, the
event-waiting D2H retire, stage-error propagation, and a faulted layer
pass unwinding with every pin and pooled buffer returned. CPU tensors here;
the CUDA stream/event path runs on the card (``chip_smoke.py``)."""
import gc
import tempfile

import numpy as np
import pytest
import torch

from repro_torch.core.cache import HostCache
from repro_torch.core.counters import Counters
from repro_torch.core.storage import StorageTier
from repro_torch.runtime import BufferPool, PipelineConfig, PipelineExecutor


class FakeEvent:
    """Stands in for a CUDA event: complete once ``done`` is set."""

    def __init__(self):
        self.done = False
        self.waited = False

    def query(self):
        return self.done

    def synchronize(self):
        self.waited = True
        self.done = True


def test_buffer_pool_recycles_only_after_the_copy_event():
    pool = BufferPool()
    a = pool.acquire((8, 4), np.float32)
    ev = FakeEvent()
    pool.release(a, event=ev)              # H2D copy still reading `a`
    assert pool.pending == 1 and pool.outstanding == 0
    b = pool.acquire((8, 4), np.float32)
    assert b is not a and pool.allocations == 2
    ev.done = True
    pool.release(b)
    got = {id(pool.acquire((8, 4), np.float32)) for _ in range(2)}
    assert got == {id(a), id(b)} and pool.pending == 0
    assert pool.allocations == 2


def test_buffer_pool_byte_cap_and_release_guards(rng):
    c = Counters()
    one = 32 * 32 * 4
    pool = BufferPool(max_bytes=2 * one, counters=c)
    bufs = [pool.acquire((32, 32), np.float32) for _ in range(2)]
    bufs += [pool.acquire((16, 64), np.float32) for _ in range(2)]
    for b in bufs:
        pool.release(b)
    assert pool.trims >= 1 and c.pool_trims == pool.trims
    assert pool.free_bytes <= pool.max_bytes
    a = pool.acquire((16, 8), np.float32)
    pool.release(a[:4])                          # view of a pooled buffer
    pool.release(np.zeros((4, 4))[::2])          # non-contiguous
    pool.release(torch.zeros(4))                 # not an ndarray
    pool.release(np.zeros((4, 4), np.float32))   # never issued
    pool.release(a)
    pool.release(a)                              # double release
    assert pool.rejected == 5 and c.pool_release_rejects == 5

    # a buffer the write-behind queue still owns must not recycle
    pool2 = BufferPool(counters=c, owner_check=lambda arr: True)
    pool2.release(pool2.acquire((8, 8), np.float32))
    assert pool2.rejected == 1


def test_retire_write_lands_and_waits_on_the_event(rng, monkeypatch):
    c = Counters()
    st_ = StorageTier(tempfile.mkdtemp(), counters=c)
    st_.alloc("a", (64, 8), np.float32)
    rt = PipelineExecutor(PipelineConfig(depth=2), c, st_, device="cpu")
    events = []

    def start(dev):
        events.append(FakeEvent())
        return dev.numpy().copy(), events[-1]

    monkeypatch.setattr(rt, "_start_d2h", start)
    x = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
    for i in range(8):
        rt.retire_write("a", i * 8, x[i * 8 : (i + 1) * 8])
    rt.drain_writes()
    assert len(events) == 8 and all(e.waited for e in events)
    np.testing.assert_array_equal(st_.read_rows("a", 0, 64), x.numpy())
    assert c.stage_busy_seconds.get("d2h", 0.0) > 0.0
    assert c.d2h_bytes == x.numel() * 4
    rt.close()
    st_.close()


@pytest.mark.parametrize("workers", [1, 3])
def test_pipeline_stage_error_propagates(workers):
    c = Counters()
    st_ = StorageTier(tempfile.mkdtemp(), counters=c)
    rt = PipelineExecutor(PipelineConfig(depth=2, gather_workers=workers), c,
                          st_, device="cpu")

    def bad_gather(it):
        raise ValueError(f"boom {it}")

    with pytest.raises(ValueError, match="boom"):
        for _ in rt.run_stream(list(range(8)), bad_gather):
            pass
    rt.close()
    st_.close()


class FailingTier(StorageTier):
    """Raises on the ``fail_at``-th read of an activation file."""

    fail_at = 3

    def _count(self):
        self.reads = getattr(self, "reads", 0) + 1
        if self.reads == self.fail_at:
            raise OSError("injected read failure")

    def read_rows(self, name, row0, row1):
        self._count()
        return super().read_rows(name, row0, row1)

    def read_rows_batched(self, reqs):
        self._count()
        return super().read_rows_batched(reqs)


@pytest.mark.parametrize("kernels", ["reference", "kernel"])
def test_faulted_layer_pass_unwinds_pins_and_buffers(kernels):
    from repro_torch.core.plan import build_plan
    from repro_torch.graph import kronecker_graph, switching_aware_partition
    from repro_torch.graph.csr import add_self_loops, gcn_norm_coeffs
    from repro_torch.infer import OffloadedInference
    from repro_torch.models.gnn.layers import get_gnn

    g = add_self_loops(kronecker_graph(600, 6, seed=0))
    parts = switching_aware_partition(g, 6, max_iters=4, seed=0).parts
    plan = build_plan(g, parts, 6, edge_weight=gcn_norm_coeffs(g),
                      device="cpu")
    dims = [8, 16, 4]
    params = get_gnn("gcn").init(torch.Generator().manual_seed(0), 8, 16, 4,
                                 2, device="cpu")
    c = Counters()
    st_ = FailingTier(tempfile.mkdtemp(), counters=c)
    cache = HostCache(2 << 10, st_, c)
    inf = OffloadedInference(
        get_gnn("gcn"), plan, dims, st_, cache, c,
        pipeline=PipelineConfig(depth=2, gather_workers=2, kernels=kernels),
        device="cpu",
    )
    inf.initialize(np.ones((g.n_nodes, 8), np.float32))
    with pytest.raises(OSError, match="injected"):
        inf.run(params)
    assert cache.total_pins == 0
    gc.collect()
    assert inf._rt.pool.outstanding == 0
    inf.close()
    st_.close()
