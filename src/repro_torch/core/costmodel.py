"""Tier-bandwidth cost model.

The port of the reference's ``core/costmodel.py``: the same terms and
formulas, in the same order. It turns the engine's byte counters and an
epoch's FLOPs into modeled per-tier times, so an engine or a storage
setting can be compared without running it on that hardware. The paper's
backward inequality B_host/B_SSD > 2(α+1)/(α+3) (§5) is evaluated with
exactly these terms.

The default profile, :data:`H100_MACHINE`, holds the rates of the machine
that carries the port's card, each tier measured by ``chip_smoke.py``
phase J there, the peak from the data sheet: one NVIDIA H100 80GB HBM3 at
a 700.00 W power limit (``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader``). :data:`GEN4_SSD` and
:data:`RAID5` replace its ``ssd`` with the paper's two other storage
settings, what-ifs, not rates of any card.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core.counters import Counters


@dataclasses.dataclass(frozen=True)
class TierBandwidths:
    # bytes/second. The defaults are H100_MACHINE's: each measured by
    # chip_smoke.py phase J (measure_tiers) on the machine of an "NVIDIA
    # H100 80GB HBM3, 700.00 W" (nvidia-smi name, power limit), except
    # peak_flops
    hbm: float = 2588.7e9         # 1 GiB device-to-device copy, read + written
    host_link: float = 54.57e9    # pinned 1 GiB H2D + D2H (53.86 / 55.31)
    # a StorageTier file read after fsync + evict; there the eviction did
    # not take (no bytes fetched from a device, /proc/self/io), so this is
    # the rate of reads through the file's mapping from the page cache
    ssd: float = 2.022e9
    host_mem: float = 4.63e9      # np.take of 1,024-wide float32 rows
    peak_flops: float = 67e12     # H100 SXM float32 (data sheet; TF32 off)


H100_MACHINE = TierBandwidths()
# the paper's other storage settings (PCIe 4.0 NVMe; RAID 5 of NVMe) on the
# same machine
GEN4_SSD = dataclasses.replace(H100_MACHINE, ssd=7e9)
RAID5 = dataclasses.replace(H100_MACHINE, ssd=25.9e9)


@dataclasses.dataclass
class ModeledTime:
    t_storage: float
    t_link: float
    t_host: float
    t_compute: float

    @property
    def serial(self) -> float:
        """No overlap (naive baselines)."""
        return self.t_storage + self.t_link + self.t_host + self.t_compute

    @property
    def overlapped(self) -> float:
        """Aggressive I/O-compute overlap (paper Appendix G)."""
        return max(self.t_storage, self.t_link, self.t_host, self.t_compute)


def modeled_time(
    counters: Counters,
    bw: TierBandwidths = H100_MACHINE,
    flops: float = 0.0,
) -> ModeledTime:
    t_storage = (
        counters.storage_read_paged_bytes + counters.storage_write_paged_bytes
    ) / bw.ssd
    t_link = (counters.h2d_bytes + counters.d2h_bytes) / bw.host_link
    t_host = (
        counters.host_gather_bytes + counters.host_scatter_bytes
    ) / bw.host_mem
    t_compute = flops / bw.peak_flops
    return ModeledTime(t_storage, t_link, t_host, t_compute)


def gnn_epoch_flops(n_nodes: int, n_edges: int, dims) -> float:
    """FLOPs for one full-graph GCN-style epoch (fwd + bwd ≈ 3× forward).

    Per layer ``i``: edge-side aggregation is one multiply-add per edge per
    input channel (``2·E·d_in``), and the vertex-side matmul is
    ``2·V·d_in·d_out`` — the dominant term for realistic widths. The host
    gather is pure data movement and contributes no FLOPs. The backward
    recomputes both matmul operands' grads, ≈ 2× the forward matmul work,
    hence the 3× blow-up."""
    f = 0.0
    for i in range(len(dims) - 1):
        f += 2.0 * n_edges * dims[i]                 # edge aggregation
        f += 2.0 * n_nodes * dims[i] * dims[i + 1]   # vertex-side matmul
    return 3.0 * f
