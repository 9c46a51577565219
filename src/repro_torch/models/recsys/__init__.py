from repro_torch.models.recsys.two_tower import (
    TwoTower, TwoTowerConfig, embedding_bag, init_two_tower, item_embedding,
    score_candidates, serve_user_tower, two_tower_loss,
    two_tower_value_and_grad, user_embedding,
)

__all__ = [
    "TwoTowerConfig", "init_two_tower", "two_tower_loss", "score_candidates",
    "serve_user_tower", "embedding_bag", "TwoTower", "item_embedding",
    "two_tower_value_and_grad", "user_embedding",
]
