"""The port's tf.data reader (``data/tfrecord.py``) against the JAX
package's ``TFRecordClips``, bit for bit, and its refusal without
TensorFlow."""

import dataclasses
import sys

import numpy as np
import pytest
import tensorflow as tf  # noqa: F401  (the readers import it; loaded once here)
import torch

from action_conditioned_gans_tpu.data import native_tfrecord as ref_native
from action_conditioned_gans_tpu.data import tfrecord as ref
from action_conditioned_gans_tpu_torch.data import make_dataset
from action_conditioned_gans_tpu_torch.data import native_tfrecord as nt
from action_conditioned_gans_tpu_torch.data import tfrecord
from tests.test_torch_native_tfrecord import clip_arrays, write_files

torch.set_num_threads(1)

CASES = {
    "raw": dict(encoding="raw", shuffle_buffer=8),
    "raw-no-shuffle-full-window": dict(encoding="raw", shuffle_buffer=1, seq_len=6),
    "raw-crop-random-resize": dict(encoding="raw", crop=10, crop_random=True, image_size=12),
    "raw-resume": dict(encoding="raw", shuffle_buffer=8, start_batch=3),
    "auto-png-crop": dict(encoding="auto", files="png", crop=12),
    "image-png-resize": dict(encoding="image", files="png", image_size=8),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_batches_bit_identical_to_the_reference(tmp_path, case):
    kw = dict(CASES[case])
    write_files(tmp_path, kw.pop("files", "raw"))
    common = dict(data_dir=str(tmp_path), batch=3, seq_len=3, image_size=16, clip_len=6,
                  raw_image_size=16, seed=4)
    common.update(kw)
    mine, theirs = tfrecord.TFRecordClips(**common), ref.TFRecordClips(**common)
    for i in range(5):
        a, b = mine.batch_at(i), theirs.batch_at(i)
        assert sorted(a) == sorted(b)
        for key in a:
            want = np.asarray(b[key])
            assert a[key].dtype == want.dtype and np.array_equal(a[key], want), (i, key)


def test_placed_batches_and_the_writers(tmp_path):
    """On a device the batch is tensors (frames in bf16, the reference's
    ml_dtypes cast); the port's TensorFlow writer writes the reference's
    bytes, and the TF-free writer's file reads back the same."""
    frames, actions, states = clip_arrays(n=4, t=6)
    for name, fn in (("port", tfrecord.write_clips_tfrecord), ("ref", ref.write_clips_tfrecord),
                     ("native", nt.write_clips_tfrecord_native)):
        (tmp_path / name).mkdir()
        fn(str(tmp_path / name / "c.tfrecord"), frames, actions, states)
    assert (tmp_path / "port" / "c.tfrecord").read_bytes() == (
        tmp_path / "ref" / "c.tfrecord").read_bytes()
    for name in ("port", "native"):
        clips = list(nt.read_clips(str(tmp_path / name / "c.tfrecord"), 6, 16, 16))
        assert np.array_equal(np.stack([c[0] for c in clips]), frames)
        assert np.array_equal(np.stack([c[2] for c in clips]), states)
    common = dict(data_dir=str(tmp_path / "port"), batch=2, seq_len=3, image_size=16,
                  clip_len=6, raw_image_size=16, seed=0, frames_dtype="bfloat16")
    a = tfrecord.TFRecordClips(**common, device="cpu").batch_at(0)
    b = ref.TFRecordClips(**common).batch_at(0)
    assert a["frames"].dtype == torch.bfloat16 and a["actions"].dtype == torch.float32
    assert np.array_equal(a["frames"].view(torch.int16).numpy(),
                          np.asarray(b["frames"]).view(np.int16))
    assert np.array_equal(a["states"].numpy(), np.asarray(b["states"]))


def test_without_tensorflow_the_source_names_tfrecord_native(tmp_path, monkeypatch):
    write_files(tmp_path)
    from tests.test_torch_resume_data import file_config

    cfg = file_config(tmp_path, "tfrecord")
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(ImportError, match="tfrecord_native"):
        tfrecord.TFRecordClips(str(tmp_path), 1, 2, 16, clip_len=6, raw_image_size=16)
    with pytest.raises(ImportError, match="tfrecord_native"):
        make_dataset(cfg, device="cpu")
    with pytest.raises(ImportError, match="tfrecord_native"):
        tfrecord.write_clips_tfrecord(str(tmp_path / "x.tfrecord"), *clip_arrays(n=1))
    # The native reader needs no TensorFlow, and is never swapped in.
    native = cfg.replace(data=dataclasses.replace(cfg.data, source="tfrecord_native"))
    ds = make_dataset(native, device="cpu")
    try:
        assert ds.batch_at(0)["frames"].shape == (2, 3, 16, 16, 3)
    finally:
        ds.close()
    assert ref_native.tfrecord_file_pattern(str(tmp_path)) == nt.tfrecord_file_pattern(
        str(tmp_path))
