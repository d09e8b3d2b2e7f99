from repro_torch.training.optimizer import adamw_init, adamw_update  # noqa: F401
from repro_torch.training.train_step import TrainState, make_train_step, init_train_state  # noqa: F401
