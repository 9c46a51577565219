"""two-tower-retrieval [recsys]: embed_dim=256 tower_mlp=1024-512-256
interaction=dot — sampled-softmax retrieval. [RecSys'19 (YouTube);
unverified]

``CONFIG`` is the published configuration (10 M rows in each table);
``SMOKE`` the reference launcher's ``--smoke`` size (``make_recsys_arch``'s
smoke: embed 16, MLP (32, 16), bags of 4, vocab 1000)."""
import dataclasses

from repro_torch.configs.builders import make_recsys_arch
from repro_torch.models.recsys.two_tower import TwoTowerConfig

CONFIG = TwoTowerConfig(
    name="two-tower-retrieval",
    embed_dim=256, tower_mlp=(1024, 512, 256),
    n_user_fields=8, n_item_fields=4, bag_size=16,
    user_vocab=10_000_000, item_vocab=10_000_000,
)

SMOKE = dataclasses.replace(
    CONFIG, embed_dim=16, tower_mlp=(32, 16), bag_size=4,
    user_vocab=1000, item_vocab=1000,
)

# the registry's description is the docstring's first paragraph (the
# reference module's whole docstring)
ARCH = make_recsys_arch(CONFIG, __doc__.split("\n\n", 1)[0].strip(), SMOKE)
