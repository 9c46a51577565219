"""Port ``build_plan`` (and the copied graph tooling it stands on) against
the reference ``build_plan``: the same graph and partition must give an
exactly equal plan — requirement sets, partition-boundary pointers,
paddings, schedule, and every topology array."""
import numpy as np
import pytest

from repro.core import build_plan as jax_build_plan
from repro.graph import switching_aware_partition as jax_partition
from repro.graph.csr import gcn_norm_coeffs as jax_norm

from repro_torch.core.plan import build_plan
from repro_torch.graph import (
    kronecker_graph, switching_aware_partition,
)
from repro_torch.graph.csr import CSRGraph, add_self_loops, gcn_norm_coeffs

TOPO_FIELDS = ("src", "dst", "edge_weight", "edge_mask", "in_deg", "dst_self")


def _port_graph(g):
    return CSRGraph(g.indptr.copy(), g.indices.copy(), g.n_nodes)


def _assert_plans_equal(ref, got):
    assert got.n_parts == ref.n_parts and got.n_nodes == ref.n_nodes
    assert got.schedule == ref.schedule
    assert got.alpha == ref.alpha
    for f in ("parts", "part_ptr", "perm", "inv_perm"):
        np.testing.assert_array_equal(getattr(got.ro, f), getattr(ref.ro, f))
    np.testing.assert_array_equal(got.ro.graph.indptr, ref.ro.graph.indptr)
    np.testing.assert_array_equal(got.ro.graph.indices, ref.ro.graph.indices)
    np.testing.assert_array_equal(got.edge_weight, ref.edge_weight)
    for ur, ug in zip(ref.units, got.units):
        for f in ("p", "v0", "v1", "n_dst", "n_req", "n_edges",
                  "r_pad", "d_pad", "e_pad"):
            assert getattr(ug, f) == getattr(ur, f), f
        for f in ("req_global", "req_part_ptr", "req_parts"):
            a, b = getattr(ug, f), getattr(ur, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b)
        assert ug.topo.n_dst == ur.topo.n_dst
        for f in TOPO_FIELDS:
            t = getattr(ug.topo, f)
            assert t.device.type == "cpu"
            np.testing.assert_array_equal(t.numpy(),
                                          np.asarray(getattr(ur.topo, f)))
    assert got.device.type == "cpu"


@pytest.mark.parametrize("graph", ["tiny_graph", "small_graph"])
@pytest.mark.parametrize("n_parts", [4, 7])
def test_plan_exactly_equals_reference(graph, n_parts, request):
    g = request.getfixturevalue(graph)
    parts = jax_partition(g, n_parts, max_iters=6, seed=3).parts
    ref = jax_build_plan(g, parts, n_parts, edge_weight=jax_norm(g))
    pg = _port_graph(g)
    got = build_plan(pg, parts, n_parts, edge_weight=gcn_norm_coeffs(pg),
                     device="cpu")
    _assert_plans_equal(ref, got)


def test_plan_without_weights_and_padding_equals_reference(tiny_graph):
    parts = jax_partition(tiny_graph, 5, max_iters=4, seed=0).parts
    ref = jax_build_plan(tiny_graph, parts, 5, pad_pow2=False)
    got = build_plan(_port_graph(tiny_graph), parts, 5, pad_pow2=False,
                     device="cpu")
    _assert_plans_equal(ref, got)


def test_copied_generator_and_partitioner_match_reference(tiny_graph):
    """The port's own graph tooling (copies) reproduces the reference's
    graph and partition from the same seeds."""
    g = add_self_loops(kronecker_graph(400, 6, seed=2))
    np.testing.assert_array_equal(g.indptr, tiny_graph.indptr)
    np.testing.assert_array_equal(g.indices, tiny_graph.indices)
    a = switching_aware_partition(g, 4, max_iters=6, seed=1).parts
    b = jax_partition(tiny_graph, 4, max_iters=6, seed=1).parts
    np.testing.assert_array_equal(a, b)
