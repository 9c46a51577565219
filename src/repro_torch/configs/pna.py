"""pna [gnn]: n_layers=4 d_hidden=75 aggregators=mean-max-min-std
scalers=id-amp-atten. [arXiv:2004.05718; paper]"""
from repro_torch.configs.builders import GNNArch, make_gnn_arch

CONFIG = GNNArch(
    name="pna", model="pna", n_layers=4, d_hidden=75,
    note="4 aggregators x 3 degree scalers",
)

ARCH = make_gnn_arch(CONFIG, __doc__.strip())
