"""Training data (port of the JAX package's ``data/``): the seeded synthetic
clip stream, generated on the device, and BAIR-schema TFRecord clips read on
the host (``native_tfrecord``: the repo's C reader; ``tfrecord``: tf.data)
and placed by ``pipeline``. Batches are the unified clip dict: ``frames``
(B, T+1, H, W, C) in [-1, 1], ``actions`` (B, T, A) and ``states`` (B, T, 3)."""

from action_conditioned_gans_tpu_torch.data.pipeline import make_dataset
from action_conditioned_gans_tpu_torch.data.synthetic import SyntheticClips, generate_clips

__all__ = ["SyntheticClips", "generate_clips", "make_dataset"]
