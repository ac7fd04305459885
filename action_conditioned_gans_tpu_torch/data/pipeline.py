"""Dataset construction: config -> batch stream (port of the JAX package's
``data/pipeline.py``).

The synthetic source makes its batches on the device. The file sources
(``tfrecord``: tf.data; ``tfrecord_native``: the C reader) make them on the
host, in a background thread (``Prefetcher``) that parses, stacks
``steps_per_call`` batches (``StackSteps``), casts the frames to
``data.device_dtype`` and places the batch once (``place_batch``): on a CUDA
device through pinned memory and a copy on a side stream.
"""

from __future__ import annotations

import queue
import threading
import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from action_conditioned_gans_tpu_torch.config import Config, resolve_device
from action_conditioned_gans_tpu_torch.data.synthetic import _FRAME_DTYPES, SyntheticClips

FILE_SOURCES = ("tfrecord", "tfrecord_native")
FILL_THREAD = "acgan-prefetch"  # the name of every Prefetcher's fill thread


class DeviceBatch(dict):
    """A batch placed on a CUDA device: its tensors and ``ready``, an event
    recorded after their copies."""

    ready: torch.cuda.Event


def _view(a) -> torch.Tensor:
    """A tensor over an array's memory, read only here (tf.data's arrays are
    read-only, which ``from_numpy`` warns of)."""
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(np.ascontiguousarray(a))


def _host_tensor(value, dtype: Optional[torch.dtype], pin: bool) -> torch.Tensor:
    """An array, or a list of equal arrays stacked on a new first axis, as
    one host tensor of ``dtype`` (its own when None), pinned if asked: one
    pass over the data, the cast included."""
    parts = value if isinstance(value, list) else [value]
    first = _view(parts[0])
    shape = ((len(parts),) if isinstance(value, list) else ()) + tuple(first.shape)
    out = torch.empty(shape, dtype=dtype or first.dtype, pin_memory=pin)
    if not isinstance(value, list):
        return out.copy_(first)
    for j, p in enumerate(parts):
        out[j].copy_(_view(p))
    return out


def adopt(batch):
    """Make the calling thread's current stream wait for a ``DeviceBatch``'s
    copies, and record its tensors on that stream, so that their memory
    (allocated on the copy's side stream) is not reused while it reads
    them. Other batches pass through."""
    ready = getattr(batch, "ready", None)
    if ready is not None:
        stream = torch.cuda.current_stream(next(iter(batch.values())).device)
        stream.wait_event(ready)
        for v in batch.values():
            v.record_stream(stream)
    return batch


def place_batch(np_batch: Dict[str, object], device, frames_dtype: str = "float32"):
    """Host batch (float32 arrays, or lists of them to stack) -> tensors on
    ``device``, frames cast to ``frames_dtype`` on the host; actions and
    states stay float32.

    On a CUDA device the host tensors are pinned and copied on a side
    stream with ``non_blocking``; this thread waits for the event after the
    copies, so the pinned buffers outlive their copy, and the batch comes
    back as a ``DeviceBatch`` adopted by this thread's stream (``adopt``;
    a consumer on another thread adopts it again). Anything else, the CPU
    included, is placed without pinning: pinning follows the target device,
    never whether CUDA happens to be present."""
    dev = torch.device(device)
    frames = _FRAME_DTYPES[frames_dtype]
    pin = dev.type == "cuda"
    host = {k: _host_tensor(v, frames if k == "frames" else None, pin) for k, v in np_batch.items()}
    if not pin:
        return {k: v.to(dev) for k, v in host.items()}
    stream = torch.cuda.Stream(dev)
    ready = torch.cuda.Event()
    with torch.cuda.stream(stream):
        out = DeviceBatch({k: v.to(dev, non_blocking=True) for k, v in host.items()})
        ready.record(stream)
    ready.synchronize()
    out.ready = ready
    return adopt(out)


class Prefetcher:
    """A background thread that fills a bounded queue from a host (file)
    source's ``batch_at``, so that parsing, stacking and placement overlap
    the device's steps.

    The fill thread puts with a timeout and rechecks the stop flag, so a
    closed Prefetcher never leaves it blocked on a full queue; an error in
    it reaches the consumer through a sentinel put the same way. The
    consumer's get is timed, so a dead fill thread or a close from another
    thread surfaces instead of hanging. ``close`` is idempotent.

    ``stats``: batches filled and delivered, the fill thread's seconds in
    ``batch_at`` (parse, stack, cast, pin, copy) over the filled ones, and
    the consumer's seconds waiting on the queue.
    """

    close_timeout_s = 60.0  # how long close waits for the fill thread

    def __init__(self, dataset, depth: int = 2):
        self._ds = dataset
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self.stats = {"filled": 0, "batches": 0, "fill_s": 0.0, "wait_s": 0.0}
        self._thread = threading.Thread(target=self._fill, daemon=True, name=FILL_THREAD)
        self._thread.start()

    def _put(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    def _fill(self):
        i = 0
        try:
            while not self._stop.is_set():
                t0 = time.perf_counter()
                item = self._ds.batch_at(i)
                self.stats["fill_s"] += time.perf_counter() - t0
                self.stats["filled"] += 1
                i += 1
                self._put(item)
        except Exception as e:  # surfaced on the consumer's side
            self._err = e
            self._put(None)

    def batch_at(self, index):
        del index  # stream-ordered, like the file readers
        if self._stop.is_set():
            raise RuntimeError("Prefetcher is closed")
        t0 = time.perf_counter()
        while True:
            try:
                item = self._q.get(timeout=1.0)
                break
            except queue.Empty:
                if self._stop.is_set():
                    raise RuntimeError("Prefetcher is closed")
                if not self._thread.is_alive():
                    if self._err is not None:
                        raise self._err
                    raise RuntimeError("Prefetcher fill thread died without an error")
        self.stats["wait_s"] += time.perf_counter() - t0
        if item is None:
            raise self._err  # type: ignore[misc]
        self.stats["batches"] += 1
        return adopt(item)

    def close(self) -> None:
        """Stop the fill thread, wait for it to end, and close the source.
        Idempotent. The thread ends once the ``batch_at`` in progress
        returns (it checks the stop flag between batches and every 0.1 s
        while putting); a thread still alive after ``close_timeout_s``
        seconds raises RuntimeError, and the source stays open under it."""
        self._stop.set()
        try:  # drain, so that a blocked put returns at once
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=self.close_timeout_s)
        if self._thread.is_alive():
            raise RuntimeError(f"Prefetcher.close: fill thread {self._thread.name!r} is still "
                               f"in the source's batch_at after {self.close_timeout_s} s")
        inner_close = getattr(self._ds, "close", None)
        if inner_close is not None:
            inner_close()

    def __del__(self):
        try:
            if getattr(self, "_stop", None) is not None and not self._stop.is_set():
                self.close()
        except Exception:
            pass  # interpreter shutdown: nothing useful to do

    def __iter__(self):
        i = 0
        while True:
            yield self.batch_at(i)
            i += 1


class StackSteps:
    """(B, ...) host batches -> (k, B, ...) batches for ``steps_per_call``
    steps a call: stacked on the host and placed once, on ``device`` (host
    arrays when None)."""

    def __init__(self, dataset, k: int, device=None, frames_dtype: str = "float32"):
        self._ds, self._k = dataset, k
        self._device, self._frames_dtype = device, frames_dtype

    def close(self) -> None:
        inner_close = getattr(self._ds, "close", None)
        if inner_close is not None:
            inner_close()

    def batch_at(self, index):
        parts = [self._ds.batch_at(index * self._k + j) for j in range(self._k)]
        if self._device is None:
            return {key: np.stack([p[key] for p in parts]) for key in parts[0]}
        return place_batch({key: [p[key] for p in parts] for key in parts[0]}, self._device,
                           self._frames_dtype)

    def __iter__(self):
        i = 0
        while True:
            yield self.batch_at(i)
            i += 1


def make_dataset(cfg: Config, stack: int = 1, start_call: int = 0, device=None,
                 host_id: int = 0, num_hosts: int = 1):
    """The training batch stream of ``cfg``: clips of ``rollout_length + 1``
    frames, (stack, B, ...) when ``stack`` > 1, on ``device`` (cuda unless
    another device is given).

    ``start_call`` is the number of ``batch_at`` calls an interrupted run
    already consumed. The synthetic stream is addressed by the call index
    (the loop asks for ``batch_at(start // k)`` on resume) and ignores it;
    the file readers skip ``start_call * stack`` batches, so a resumed run
    reads what the uninterrupted one would have read next. A file source
    comes wrapped in a ``Prefetcher``: close it (``close()``) when done.

    Host ``host_id`` of ``num_hosts`` (a data index of a parallel run, whose
    model group's ranks read the same rows) gets
    its share of each step's ``train.batch_size`` clips: the synthetic
    stream its rows of the one-host batch, bit for bit; a file source
    reads the host's files (``native_tfrecord.shard_files``:
    ``files[host_id::num_hosts]``), ``batch_size / num_hosts`` clips a step.
    """
    d, t, m = cfg.data, cfg.train, cfg.model
    dev = resolve_device(device)
    seq_len = t.rollout_length + 1
    if d.source == "synthetic":
        return SyntheticClips(batch=t.batch_size, seq_len=seq_len, image_size=m.image_size,
                              action_dim=m.action_dim, with_state=True, seed=t.seed, stack=stack,
                              frames_dtype=d.device_dtype, device=dev, host_id=host_id,
                              num_hosts=num_hosts)
    if d.source not in FILE_SOURCES:
        raise ValueError(f"unknown data source {d.source!r}")
    if t.batch_size % num_hosts:
        raise ValueError(f"batch_size={t.batch_size} must be divisible by "
                         f"num_hosts={num_hosts} for file sources")
    if d.device_dtype not in _FRAME_DTYPES:
        raise ValueError(f"unsupported data.device_dtype {d.device_dtype!r}")
    if d.source == "tfrecord":
        from action_conditioned_gans_tpu_torch.data.tfrecord import TFRecordClips as Reader

        extra = {}
    else:
        from action_conditioned_gans_tpu_torch.data.native_tfrecord import (
            NativeTFRecordClips as Reader,
        )

        extra = {"decode_threads": d.decode_threads}
    reader = Reader(data_dir=d.data_dir, batch=t.batch_size // num_hosts, seq_len=seq_len,
                    image_size=m.image_size, action_dim=m.action_dim,
                    state_dim=m.state_dim or 3, clip_len=d.clip_len,
                    image_key=d.tfrecord_image_key, encoding=d.tfrecord_encoding,
                    raw_image_size=d.raw_image_size, crop=d.crop, crop_random=d.crop_random,
                    shuffle_buffer=d.shuffle_buffer, seed=t.seed, host_id=host_id,
                    num_hosts=num_hosts, device=None if stack > 1 else dev,
                    start_batch=start_call * stack, frames_dtype=d.device_dtype, **extra)
    if stack > 1:
        return Prefetcher(StackSteps(reader, stack, dev, d.device_dtype))
    return Prefetcher(reader)
