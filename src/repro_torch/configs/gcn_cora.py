"""gcn-cora [gnn]: n_layers=2 d_hidden=16 aggregator=mean norm=sym.
[arXiv:1609.02907; paper]"""
from repro_torch.configs.builders import GNNArch, make_gnn_arch

CONFIG = GNNArch(
    name="gcn-cora", model="gcn", n_layers=2, d_hidden=16,
    note="symmetric normalization",
)

ARCH = make_gnn_arch(CONFIG, __doc__.strip())
