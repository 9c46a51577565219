"""graphcast [gnn]: n_layers=16 d_hidden=512 mesh_refinement=6
aggregator=sum n_vars=227 — encoder-processor-decoder mesh GNN.
[arXiv:2212.12794; unverified]

Adaptation note (DESIGN.md §4): the processor is node-centric here (edge
latents recomputed from endpoint features per layer) so the SSO engine's
per-layer node state management applies; output = 227 regression vars (MSE).
The assigned generic graph shapes stand in for the refinement-6 icosahedral
mesh (40,962 nodes)."""
from repro_torch.configs.builders import GNNArch, make_gnn_arch

CONFIG = GNNArch(
    name="graphcast", model="graphcast", n_layers=16, d_hidden=512,
    loss_kind="mse", d_out_override=227,
    note="encoder-processor-decoder; sum aggregation; 227 output vars",
)

ARCH = make_gnn_arch(CONFIG, __doc__.strip())
