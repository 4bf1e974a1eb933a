"""Training substrate: optimizer, schedules, train step, compression."""
from .optim import AdamWConfig, OptState, adamw_init, adamw_update, lr_at
from .train_step import TrainState, make_train_step, train_state_init
