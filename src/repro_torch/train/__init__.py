from repro_torch.train.optimizer import adamw_init, adamw_update, clip_by_global_norm
from repro_torch.train.schedule import make_schedule, wsd_schedule
from repro_torch.train.trainer import Trainer, make_train_step

__all__ = [
    "adamw_init", "adamw_update", "clip_by_global_norm",
    "make_schedule", "wsd_schedule", "Trainer", "make_train_step",
]
