"""Layer ops: plain PyTorch versions and the Hopper kernels behind one API."""

from action_conditioned_gans_tpu_torch.ops.api import (  # noqa: F401
    conv_norm_act,
    dense,
    leaky_relu,
    norm_act,
)
