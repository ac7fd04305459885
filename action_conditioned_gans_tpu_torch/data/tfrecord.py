"""BAIR-style TFRecord clips through tf.data (port of the JAX package's
``data/tfrecord.py``).

Schema, one record a clip of ``clip_len`` timesteps:
``{t}/image_aux1/encoded`` (raw RGB24, or a JPEG / PNG frame),
``{t}/action`` float32[A] and ``{t}/endeffector_pos`` float32[S]. tf.data
parses, decodes, crops, resizes, normalises to [-1, 1] and slices a random
window of ``seq_len`` frames, on the host; batches come back as float32
numpy arrays, or as tensors on a device (``data.pipeline.place_batch``).
For the same files and seed they are the JAX package's, bit for bit.

TensorFlow is imported when the reader is built, with its GPUs hidden.
Where it is missing, ``source="tfrecord"`` raises an ImportError that names
``tfrecord_native``, which reads the same files without it but shuffles
differently: one is never swapped for the other.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np


def _tf():
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError("data.source='tfrecord' reads through tf.data and needs TensorFlow, "
                          "which is not installed; data.source='tfrecord_native' reads the same "
                          "files without it (its shuffle differs from tf.data's)") from e
    tf.config.set_visible_devices([], "GPU")
    return tf


class TFRecordClips:
    """Clip batches through tf.data, stream-ordered: ``batch_at(i)`` ignores
    ``i``. Every random draw is keyed on (seed, stream position): the
    shuffle, the window start (``stateless_uniform``) and the crop
    (``data.cropping``), so ``start_batch`` skips to where an uninterrupted
    run stood without parsing the records it skips."""

    def __init__(self, data_dir: str, batch: int, seq_len: int, image_size: int,
                 action_dim: int = 4, state_dim: int = 3, clip_len: int = 30,
                 image_key: str = "image_aux1", encoding: str = "auto",
                 raw_image_size: int = 64, crop: int = 0, crop_random: bool = False,
                 shuffle_buffer: int = 256, seed: int = 0, host_id: int = 0, num_hosts: int = 1,
                 repeat: bool = True, device=None, start_batch: int = 0,
                 frames_dtype: str = "float32"):
        from action_conditioned_gans_tpu_torch.data.native_tfrecord import shard_files

        if not data_dir:
            raise ValueError("tfrecord source requires data_dir")
        self._files = shard_files(data_dir, host_id, num_hosts)
        if crop and not 0 < crop <= raw_image_size:
            raise ValueError(f"crop={crop} must be in [1, raw_image_size={raw_image_size}]")
        self.batch, self.seq_len, self.image_size = batch, seq_len, image_size
        self.action_dim, self.state_dim, self.clip_len = action_dim, state_dim, clip_len
        self.image_key, self.encoding, self.raw_image_size = image_key, encoding, raw_image_size
        self.crop, self.crop_random = crop, crop_random
        self.shuffle_buffer, self.seed, self.repeat = shuffle_buffer, seed, repeat
        self.start_batch = start_batch
        self.device, self.frames_dtype = device, frames_dtype
        self._tf = _tf()  # here, not in the fill thread: a missing TensorFlow fails at once
        self._it = None

    def _build(self):
        tf = self._tf
        T, A, S = self.clip_len, self.action_dim, self.state_dim
        feature_spec = {}
        for t in range(T):
            feature_spec[f"{t}/{self.image_key}/encoded"] = tf.io.FixedLenFeature([], tf.string)
            feature_spec[f"{t}/action"] = tf.io.FixedLenFeature([A], tf.float32)
            feature_spec[f"{t}/endeffector_pos"] = tf.io.FixedLenFeature([S], tf.float32)
        raw_hw = self.raw_image_size

        def decode_frame(b):
            if self.encoding == "raw":
                return tf.reshape(tf.io.decode_raw(b, tf.uint8), (raw_hw, raw_hw, 3))
            if self.encoding == "image":
                img = tf.io.decode_image(b, channels=3, expand_animations=False)
                img.set_shape((None, None, 3))
                return img

            def compressed():
                # Any stored size, resized to the raw grid and rounded to nearest.
                dec = tf.io.decode_image(b, channels=3, expand_animations=False)
                dec.set_shape((None, None, 3))
                return tf.cast(tf.round(tf.image.resize(tf.cast(dec, tf.float32),
                                                        (raw_hw, raw_hw))), tf.uint8)

            # auto: raw iff the payload is exactly H*W*3 bytes
            return tf.cond(tf.equal(tf.strings.length(b), raw_hw * raw_hw * 3),
                           lambda: tf.reshape(tf.io.decode_raw(b, tf.uint8), (raw_hw, raw_hw, 3)),
                           compressed)

        crop = self.crop

        def parse(index, record):
            ex = tf.io.parse_single_example(record, feature_spec)
            frames = tf.stack([decode_frame(ex[f"{t}/{self.image_key}/encoded"])
                               for t in range(T)])  # (T, raw, raw, 3) uint8
            if crop:
                # Before the resize, one offset a clip, keyed on the stream
                # position as the native reader keys it.
                from action_conditioned_gans_tpu_torch.data.cropping import crop_offsets_tf

                offs = crop_offsets_tf(self.seed, index, raw_hw, crop, self.crop_random)
                zero = tf.constant(0, tf.int64)
                frames = tf.slice(frames, tf.stack([zero, offs[0], offs[1], zero]),
                                  (T, crop, crop, 3))
            frames = tf.cast(frames, tf.float32)
            if self.image_size != (crop or raw_hw):
                frames = tf.image.resize(frames, (self.image_size, self.image_size))
            frames = frames / 255.0 * 2.0 - 1.0
            actions = tf.stack([ex[f"{t}/action"] for t in range(T)])
            states = tf.stack([ex[f"{t}/endeffector_pos"] for t in range(T)])
            # action[t] takes frame[t] to frame[t + 1].
            max_start = T - self.seq_len
            start = (tf.random.stateless_uniform(
                [], seed=tf.stack([tf.constant(self.seed, tf.int64), tf.cast(index, tf.int64)]),
                minval=0, maxval=max_start + 1, dtype=tf.int32) if max_start > 0 else 0)
            return {"frames": frames[start:start + self.seq_len],
                    "actions": actions[start:start + self.seq_len - 1],
                    "states": states[start:start + self.seq_len - 1]}

        ds = tf.data.TFRecordDataset(self._files, num_parallel_reads=4)
        if self.repeat:
            ds = ds.repeat()
        ds = ds.shuffle(self.shuffle_buffer, seed=self.seed)
        ds = ds.enumerate()  # the stream position keys the window draw
        if self.start_batch > 0:
            ds = ds.skip(self.start_batch * self.batch)
        ds = ds.map(parse, num_parallel_calls=tf.data.AUTOTUNE)
        ds = ds.batch(self.batch, drop_remainder=True)
        ds = ds.prefetch(tf.data.AUTOTUNE)
        return ds.as_numpy_iterator()

    def host_batch(self) -> Dict[str, np.ndarray]:
        """The next batch on the host: float32 arrays."""
        if self._it is None:
            self._it = self._build()
        return next(self._it)

    def batch_at(self, index):
        del index  # stream-ordered
        out = self.host_batch()
        if self.device is None:
            return out
        from action_conditioned_gans_tpu_torch.data.pipeline import place_batch

        return place_batch(out, self.device, self.frames_dtype)

    def __iter__(self):
        i = 0
        while True:
            yield self.batch_at(i)
            i += 1


def write_clips_tfrecord(path: str, frames: np.ndarray, actions: np.ndarray, states: np.ndarray,
                         image_key: str = "image_aux1") -> None:
    """Clips in the BAIR per-timestep schema (raw RGB24 frames) through
    TensorFlow's writer. ``frames`` (N, T, H, W, 3) uint8 or floats in [-1, 1]."""
    tf = _tf()
    if frames.dtype != np.uint8:
        frames = np.round((np.clip(frames, -1, 1) + 1) * 127.5).astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with tf.io.TFRecordWriter(path) as w:
        for n in range(frames.shape[0]):
            feat = {}
            for t in range(frames.shape[1]):
                feat[f"{t}/{image_key}/encoded"] = tf.train.Feature(
                    bytes_list=tf.train.BytesList(value=[frames[n, t].tobytes()]))
                feat[f"{t}/action"] = tf.train.Feature(
                    float_list=tf.train.FloatList(value=actions[n, t].tolist()))
                feat[f"{t}/endeffector_pos"] = tf.train.Feature(
                    float_list=tf.train.FloatList(value=states[n, t].tolist()))
            w.write(tf.train.Example(features=tf.train.Features(feature=feat)).SerializeToString())
