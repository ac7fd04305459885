"""The port's crop stage (``data/cropping.py``) against the JAX package's:
the same offsets from the same (seed, stream position), in numpy and in
TensorFlow, and the same crops through both file readers."""

import numpy as np
import pytest
import tensorflow as tf
import torch

from action_conditioned_gans_tpu.data import cropping as ref
from action_conditioned_gans_tpu_torch.data import cropping
from action_conditioned_gans_tpu_torch.data.native_tfrecord import NativeTFRecordClips
from tests.test_torch_native_tfrecord import write_files

torch.set_num_threads(1)
SEEDS = (0, 1, 11, 12345, 2**31, 2**32 + 3, 2**63 - 1, 2**64 - 1)
INDICES = (0, 1, 7, 511, 12345, 2**31 + 1, 2**32 + 9, 2**40)


@pytest.mark.parametrize("raw,crop", [(64, 48), (64, 64), (16, 12), (16, 1), (256, 200)])
@pytest.mark.parametrize("random", [False, True])
def test_crop_offsets_equal_the_reference(raw, crop, random):
    for seed in SEEDS:
        for index in INDICES + tuple(range(64)):
            got = cropping.crop_offsets(seed, index, raw, crop, random)
            assert got == ref.crop_offsets(seed, index, raw, crop, random), (seed, index)
            assert all(0 <= o <= raw - crop for o in got)


@pytest.mark.parametrize("random", [False, True])
def test_crop_offsets_tf_equal_the_reference_and_numpy(random):
    for seed in SEEDS[:6]:
        for index in INDICES:
            got = tuple(cropping.crop_offsets_tf(seed, tf.constant(index, tf.int64), 64, 48,
                                                 random).numpy())
            want = tuple(ref.crop_offsets_tf(seed, tf.constant(index, tf.int64), 64, 48,
                                             random).numpy())
            assert got == want == cropping.crop_offsets(seed, index, 64, 48, random)


def test_invalid_crop_is_refused(tmp_path):
    for crop in (0, -1, 65):
        with pytest.raises(ValueError, match="crop"):
            cropping.crop_offsets(0, 0, 64, crop, True)
        with pytest.raises(ValueError, match="crop"):
            cropping.crop_offsets_tf(0, tf.constant(0, tf.int64), 64, crop, True)
    write_files(tmp_path)
    with pytest.raises(ValueError, match="crop"):
        NativeTFRecordClips(str(tmp_path), 1, 2, 16, clip_len=6, raw_image_size=16, crop=32)


def test_random_crop_moves_and_survives_the_resume(tmp_path):
    """Random crops differ from the centre crop, and a reader started at
    batch 2 crops its clips as the uninterrupted reader did."""
    frames, _, _ = write_files(tmp_path, files=1)
    kw = dict(data_dir=str(tmp_path), batch=2, seq_len=6, image_size=10, clip_len=6,
              raw_image_size=16, crop=10, seed=3)
    centre = NativeTFRecordClips(**kw).batch_at(0)["frames"]
    u8 = frames[:2, :, 3:13, 3:13].astype(np.float32) / 255.0 * 2 - 1
    assert np.array_equal(centre, u8)
    full = NativeTFRecordClips(**kw, crop_random=True)
    batches = [full.batch_at(i)["frames"] for i in range(4)]
    assert not np.array_equal(batches[0], centre)
    resumed = NativeTFRecordClips(**kw, crop_random=True, start_batch=2)
    for i in (2, 3):
        assert np.array_equal(resumed.batch_at(i)["frames"], batches[i])
