"""Training: the fused G+D step, its state and losses (port of ``train/``)."""

from action_conditioned_gans_tpu_torch.train.state import TrainState, init_state  # noqa: F401
from action_conditioned_gans_tpu_torch.train.step import make_train_step  # noqa: F401
