"""Training on one device: AdamW (``optimizer``) and the train step (``train``)."""

from .optimizer import OptConfig, adamw_init, adamw_update, global_norm, lr_at
from .train import init_train_state, make_train_step

__all__ = ["OptConfig", "adamw_init", "adamw_update", "global_norm", "lr_at",
           "init_train_state", "make_train_step"]
