from .optimizer import AdamConfig, adam_init, adam_update, lr_schedule
from .state import TrainState, init_train_state
from .trainer import TrainConfig, make_train_step

__all__ = [
    "AdamConfig", "adam_init", "adam_update", "lr_schedule",
    "TrainState", "init_train_state", "TrainConfig", "make_train_step",
]
