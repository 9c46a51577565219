from repro_torch.optim.adamw import (
    adamw_init, adamw_update, adamw_update_, sgd_update,
)

__all__ = ["adamw_init", "adamw_update", "adamw_update_", "sgd_update"]
