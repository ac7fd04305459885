"""PyTorch + CUDA port of ``action_conditioned_gans_tpu`` for NVIDIA Hopper.

The JAX package beside it is the reference. This package imports neither
JAX nor anything of that package. Layouts at its public functions are the
JAX package's (NHWC activations, HWIO kernels). On a CUDA tensor every fused
conv block runs a hand-written sm_90a kernel (``csrc/``), and under autograd
its GroupNorm backward runs one too; on a CPU tensor the plain PyTorch
versions run. ``infer`` serves the generator; ``train`` takes fused G+D
training steps and runs the training loop (``train.loop``) on synthetic clips
made on the device or on TFRecord clip files (``data``), with checkpoints
(``utils.checkpoint``); ``bench`` times the training step.
"""

from action_conditioned_gans_tpu_torch.config import (  # noqa: F401
    PRESETS,
    Config,
    DataConfig,
    MeshConfig,
    ModelConfig,
    TrainConfig,
    get_preset,
)

__version__ = "0.1.0"
