"""Paper's own primary configuration: 3-/5-layer GCN, hidden 256, on
IGBM-scale graphs (10M nodes / 120M edges / 1024 features) — the GriNNder
evaluation setting (paper §8.1). Used by the SSO-engine benchmarks and the
end-to-end offloaded-training example, not a dry-run cell."""
from repro_torch.configs.builders import GNNArch, make_gnn_arch

CONFIG_3L = GNNArch(
    name="gcn-igbm-3l", model="gcn", n_layers=3, d_hidden=256,
    note="paper default (Table 1, L=3)",
)
CONFIG_5L = GNNArch(
    name="gcn-igbm-5l", model="gcn", n_layers=5, d_hidden=256,
    note="paper deep setting (Table 1, L=5)",
)

# IGBM-scale dataset constants (paper Table 9)
IGBM = dict(n_nodes=10_000_000, n_edges=120_100_000, d_feat=1024, classes=19)
PRODUCTS = dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100, classes=47)
PAPERS = dict(n_nodes=111_000_000, n_edges=1_600_000_000, d_feat=128, classes=172)

ARCH = make_gnn_arch(CONFIG_3L, __doc__.strip())
