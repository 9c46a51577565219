from repro_torch.graph.csr import CSRGraph, coo_to_csr, gcn_norm_coeffs
from repro_torch.graph.synthetic import kronecker_graph, watts_strogatz, erdos_renyi
from repro_torch.graph.partition import (
    switching_aware_partition,
    random_partition,
    spinner_like_partition,
    expansion_ratio,
    partition_dependency_matrix,
    PartitionResult,
)
from repro_torch.graph.reorder import reorder_by_partition
from repro_torch.graph.sampler import NeighborSampler, MessageFlowGraph

__all__ = [
    "CSRGraph", "coo_to_csr", "gcn_norm_coeffs",
    "kronecker_graph", "watts_strogatz", "erdos_renyi",
    "switching_aware_partition", "random_partition", "spinner_like_partition",
    "expansion_ratio", "partition_dependency_matrix", "PartitionResult",
    "reorder_by_partition", "NeighborSampler", "MessageFlowGraph",
]
