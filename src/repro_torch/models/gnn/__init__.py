from repro_torch.models.gnn.layers import LocalTopo, GNN_REGISTRY, GNNSpec, get_gnn

__all__ = ["LocalTopo", "GNN_REGISTRY", "GNNSpec", "get_gnn"]
