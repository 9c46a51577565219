"""The port's tier cost model (``repro_torch.core.costmodel``) against the
reference's, on the CPU.

- ``modeled_time`` is bitwise the reference's — every term, ``serial`` and
  ``overlapped`` — for the same counter fields (seeded byte counts, and the
  counters of one real engine epoch in each package) and an explicit
  ``TierBandwidths`` carrying the same rates;
- ``gnn_epoch_flops`` is bitwise the reference's for the same dims;
- the port's default profile is ``H100_MACHINE``: ``modeled_time``'s default
  and ``TierBandwidths()``, with the float32 data-sheet peak (the port
  trains in float32 with TF32 off), and ``GEN4_SSD`` / ``RAID5`` differ
  from it in ``ssd`` alone.
"""
import dataclasses
import tempfile
import types

import numpy as np
import pytest

from repro.core import Counters as JCounters
from repro.core import HostCache as JHostCache
from repro.core import SSOEngine as JSSOEngine
from repro.core import StorageTier as JStorageTier
from repro.core.costmodel import TierBandwidths as JTierBandwidths
from repro.core.costmodel import gnn_epoch_flops as jax_gnn_epoch_flops
from repro.core.costmodel import modeled_time as jax_modeled_time

from repro_torch.core import H100_MACHINE
from repro_torch.core.cache import HostCache
from repro_torch.core.costmodel import (
    GEN4_SSD, RAID5, TierBandwidths, gnn_epoch_flops, modeled_time,
)
from repro_torch.core.counters import Counters
from repro_torch.core.engine import SSOEngine
from repro_torch.core.storage import StorageTier

FIELDS = ("storage_read_paged_bytes", "storage_write_paged_bytes",
          "h2d_bytes", "d2h_bytes", "host_gather_bytes", "host_scatter_bytes")
RATES = dict(hbm=2.9e12, host_link=53.1e9, ssd=3.3e9, host_mem=11.7e9,
             peak_flops=67e12)


def terms(mt):
    return (mt.t_storage, mt.t_link, mt.t_host, mt.t_compute, mt.serial,
            mt.overlapped)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("flops", [0.0, 3.7e12])
def test_modeled_time_bitwise_reference(seed, flops):
    rng = np.random.default_rng(seed)
    counts = {f: int(rng.integers(0, 1 << 40)) for f in FIELDS}
    ns = types.SimpleNamespace(**counts)
    want = jax_modeled_time(ns, JTierBandwidths(**RATES), flops)
    got = modeled_time(ns, TierBandwidths(**RATES), flops)
    assert terms(got) == terms(want)


@pytest.mark.parametrize("dims", [[1024, 256, 256, 19], [24, 32, 8],
                                  [128] * 5 + [16], [7, 3]])
@pytest.mark.parametrize("n,e", [(262144, 6063044), (2000, 16000), (1, 0)])
def test_gnn_epoch_flops_bitwise_reference(dims, n, e):
    assert gnn_epoch_flops(n, e, dims) == jax_gnn_epoch_flops(n, e, dims)


def test_modeled_time_of_engine_counters_bitwise_reference():
    """One regather epoch of the same graph in each package: equal byte
    counters, so the modeled times agree bit for bit."""
    from test_torch_families import jax_params, make_setup

    from repro.models.gnn.layers import get_gnn as jax_get_gnn
    from repro_torch.models.gnn.layers import get_gnn
    from repro_torch.params import params_from_jax

    jplan, plan, X, Y = make_setup()
    dims = [24, 32, 10]
    jp = jax_params("gcn")
    jc = JCounters()
    jst = JStorageTier(tempfile.mkdtemp(), counters=jc)
    jeng = JSSOEngine(jax_get_gnn("gcn"), jplan, dims, jst,
                      JHostCache(256 << 10, jst, jc), jc)
    jeng.initialize(X)
    jeng.run_epoch(jp, Y)
    jst.close()
    c = Counters()
    st = StorageTier(tempfile.mkdtemp(), counters=c)
    eng = SSOEngine(get_gnn("gcn"), plan, dims, st,
                    HostCache(256 << 10, st, c), c, device="cpu")
    eng.initialize(X)
    eng.run_epoch(params_from_jax(jp, device="cpu"), Y)
    eng.close()
    st.close()
    assert {f: getattr(c, f) for f in FIELDS} == \
        {f: getattr(jc, f) for f in FIELDS}
    assert c.storage_read_paged_bytes > 0 and c.host_gather_bytes > 0
    flops = gnn_epoch_flops(plan.n_nodes, plan.ro.graph.n_edges, dims)
    assert terms(modeled_time(c, TierBandwidths(**RATES), flops)) == \
        terms(jax_modeled_time(jc, JTierBandwidths(**RATES), flops))


def test_default_profile_is_the_h100_machine():
    assert TierBandwidths() == H100_MACHINE
    assert H100_MACHINE.peak_flops == 67e12
    c = Counters()
    c.bump_many(h2d_bytes=1 << 30, storage_read_paged_bytes=1 << 31,
                host_gather_bytes=1 << 29)
    assert terms(modeled_time(c)) == terms(modeled_time(c, H100_MACHINE))
    for what_if, ssd in ((GEN4_SSD, 7e9), (RAID5, 25.9e9)):
        assert what_if == dataclasses.replace(H100_MACHINE, ssd=ssd)
