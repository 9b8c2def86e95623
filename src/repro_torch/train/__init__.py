"""Training of the port: AdamW and its schedules, the train step and
the loop (counterpart of ``repro.train``)."""
from repro_torch.train.optim import AdamWConfig, adamw_init, adamw_update, lr_at
from repro_torch.train.loop import TrainConfig, make_train_step, train_loop

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "lr_at",
    "TrainConfig",
    "make_train_step",
    "train_loop",
]
