"""The crop stage of both file readers (port of the JAX package's
``data/cropping.py``).

The input transform is frame decode -> crop -> resize -> normalise. The crop
is taken from the stored frame before the resize, with one offset per clip:
every frame of a clip is cropped alike. Random offsets come from a stateless
splitmix64 hash of (seed, the clip's position in the stream), integer
arithmetic that numpy (the native reader) and TensorFlow (the tf.data
reader) compute alike, so the two readers crop the same records identically
and a resumed stream crops as the uninterrupted one did.
"""

from __future__ import annotations

from typing import Tuple

_M64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return (x ^ (x >> 31)) & _M64


def _check(raw: int, crop: int) -> int:
    if crop <= 0 or crop > raw:
        raise ValueError(f"crop={crop} must be in [1, raw={raw}]")
    return raw - crop + 1


def crop_offsets(seed: int, index: int, raw: int, crop: int, random: bool) -> Tuple[int, int]:
    """(oy, ox), the top-left corner of a ``crop`` x ``crop`` window in a
    ``raw`` x ``raw`` frame: centred, or drawn from (seed, ``index``), the
    clip's absolute position in the stream."""
    span = _check(raw, crop)
    if not random or span == 1:
        off = (raw - crop) // 2
        return off, off
    z = _splitmix64(_splitmix64(seed & _M64) ^ (index & _M64))
    return int(z % span), int((z >> 32) % span)


def crop_offsets_tf(seed: int, index, raw: int, crop: int, random: bool):
    """:func:`crop_offsets` in TensorFlow uint64 ops, for the tf.data
    reader's map stage: an int64 (2,) tensor (oy, ox); ``index`` is a scalar
    int tensor. Imports TensorFlow."""
    import tensorflow as tf

    span = _check(raw, crop)
    if not random or span == 1:
        off = (raw - crop) // 2
        return tf.constant([off, off], tf.int64)

    def u64(v):
        return tf.constant(v & _M64, tf.uint64)

    def sm64(x):
        x = x + u64(0x9E3779B97F4A7C15)
        x = tf.bitwise.bitwise_xor(x, tf.bitwise.right_shift(x, u64(30)))
        x = x * u64(0xBF58476D1CE4E5B9)
        x = tf.bitwise.bitwise_xor(x, tf.bitwise.right_shift(x, u64(27)))
        x = x * u64(0x94D049BB133111EB)
        return tf.bitwise.bitwise_xor(x, tf.bitwise.right_shift(x, u64(31)))

    z = sm64(tf.bitwise.bitwise_xor(sm64(u64(seed)), tf.cast(index, tf.uint64)))
    oy = z % u64(span)
    ox = tf.bitwise.right_shift(z, u64(32)) % u64(span)
    return tf.cast(tf.stack([oy, ox]), tf.int64)
