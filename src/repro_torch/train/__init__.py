from repro_torch.train.checkpoint import (
    latest_checkpoint, restore_checkpoint, save_checkpoint,
)
from repro_torch.train.loop import (
    EpochLoopConfig, LoopConfig, LoopState, run_epoch_loop, run_training_loop,
)

__all__ = [
    "save_checkpoint", "restore_checkpoint", "latest_checkpoint",
    "LoopConfig", "LoopState", "run_training_loop",
    "EpochLoopConfig", "run_epoch_loop",
]
