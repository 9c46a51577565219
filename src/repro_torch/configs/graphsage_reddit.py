"""graphsage-reddit [gnn]: n_layers=2 d_hidden=128 aggregator=mean
sample_sizes=25-10. [arXiv:1706.02216; paper]"""
from repro_torch.configs.builders import GNNArch, make_gnn_arch

CONFIG = GNNArch(
    name="graphsage-reddit", model="sage", n_layers=2, d_hidden=128,
    note="mean aggregator; sample_sizes 25-10 (cell fanout from shape)",
)

ARCH = make_gnn_arch(CONFIG, __doc__.strip())
