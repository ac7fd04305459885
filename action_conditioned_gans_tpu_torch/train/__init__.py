"""Training: the fused G+D step, its state and losses, and the loop (port of
``train/``)."""

from action_conditioned_gans_tpu_torch.train.state import TrainState, init_state  # noqa: F401
from action_conditioned_gans_tpu_torch.train.step import (  # noqa: F401
    make_multi_train_step,
    make_train_step,
)
