from .optimizer import AdamConfig, adam_init, adam_state_axes, adam_update, lr_schedule
from .state import TrainState, init_train_state, train_state_axes, train_state_shapes
from .trainer import TrainConfig, make_train_step

__all__ = [
    "AdamConfig", "adam_init", "adam_state_axes", "adam_update", "lr_schedule",
    "TrainState", "init_train_state", "train_state_axes", "train_state_shapes",
    "TrainConfig", "make_train_step",
]
