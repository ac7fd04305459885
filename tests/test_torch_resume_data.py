"""Resuming a file source (``data/pipeline.py``, the readers' ``start_batch``)
on the CPU: a resumed run reads the batches the uninterrupted run read at
the same step, for both file sources, as the JAX package's readers do; the
loop passes ``start_call`` on resume; the native skim decodes nothing it
drops."""

import dataclasses

import numpy as np
import pytest
import tensorflow as tf  # noqa: F401  (the tf.data reader imports it; loaded once here)
import torch

from action_conditioned_gans_tpu.config import Config, DataConfig, ModelConfig, TrainConfig
from action_conditioned_gans_tpu.data import make_dataset as jax_make_dataset
from action_conditioned_gans_tpu_torch.data import make_dataset
from action_conditioned_gans_tpu_torch.data import native_tfrecord as nt
from action_conditioned_gans_tpu_torch.data import tfrecord
from action_conditioned_gans_tpu_torch.train import loop as loop_mod
from tests.test_torch_native_tfrecord import write_files
from tests.test_torch_train import port_config

torch.set_num_threads(1)


def jax_file_config(tmp_path, source, **train_kw):
    train = dict(batch_size=2, rollout_length=2, steps_per_call=2, seed=5)
    train.update(train_kw)
    return Config(
        name="resume-data",
        model=ModelConfig(image_size=16, g_levels=2, g_base_channels=8, d_levels=2,
                          d_base_channels=8, group_norm_groups=4, compute_dtype="float32",
                          state_dim=3),
        data=DataConfig(source=source, data_dir=str(tmp_path), clip_len=6, raw_image_size=16,
                        shuffle_buffer=4, tfrecord_encoding="raw"),
        train=TrainConfig(**train), workdir=str(tmp_path / "work"))


def file_config(tmp_path, source, **train_kw):
    return port_config(jax_file_config(tmp_path, source, **train_kw))


def host(batch):
    return {k: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in batch.items()}


def collect(ds, n):
    try:
        return [host(ds.batch_at(i)) for i in range(n)]
    finally:
        ds.close()


def assert_same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), k


@pytest.mark.parametrize("source", ["tfrecord", "tfrecord_native"])
def test_reader_start_batch_matches_the_uninterrupted_stream(tmp_path, source):
    write_files(tmp_path, n=24, files=2)
    kw = dict(data_dir=str(tmp_path), batch=3, seq_len=3, image_size=16, clip_len=6,
              raw_image_size=16, shuffle_buffer=8, seed=11, encoding="raw")
    reader = tfrecord.TFRecordClips if source == "tfrecord" else nt.NativeTFRecordClips
    stream = reader(**kw)
    full = [host(stream.batch_at(i)) for i in range(7)]
    resumed = reader(**kw, start_batch=4)
    assert_same([host(resumed.batch_at(i)) for i in range(3)], full[4:])
    assert not np.array_equal(full[0]["frames"], full[4]["frames"])


@pytest.mark.parametrize("source", ["tfrecord", "tfrecord_native"])
def test_make_dataset_start_call_fast_forwards_as_the_reference(tmp_path, source):
    """make_dataset(start_call=c) with steps_per_call stacking resumes at
    stacked batch c; every batch equals the JAX package's make_dataset's."""
    write_files(tmp_path, n=24, files=2)
    cfg = file_config(tmp_path, source)
    full = collect(make_dataset(cfg, stack=2, device="cpu"), 5)
    resumed = collect(make_dataset(cfg, stack=2, start_call=3, device="cpu"), 2)
    assert_same(resumed, full[3:])
    theirs = jax_make_dataset(jax_file_config(tmp_path, source), stack=2)
    try:
        assert_same(full, [host(theirs.batch_at(i)) for i in range(5)])
    finally:
        theirs.close()
    assert full[0]["frames"].shape == (2, 2, 3, 16, 16, 3)


def test_train_loop_passes_start_call_on_resume(tmp_path, monkeypatch):
    """After a run checkpointed at step 4 with k=2, the resumed train()
    builds its dataset with start_call 2, and closes it at the end."""
    write_files(tmp_path, n=24, files=2)
    calls, closed = [], []
    real = loop_mod.make_dataset

    def spy(cfg, **kw):
        calls.append(kw.get("start_call", 0))
        ds = real(cfg, **kw)
        inner = ds.close
        ds.close = lambda: (closed.append(True), inner())
        return ds

    monkeypatch.setattr(loop_mod, "make_dataset", spy)
    cfg = file_config(tmp_path, "tfrecord_native", checkpoint_every=2, log_every=100,
                      sample_every=0)
    loop_mod.train(cfg, max_steps=4, device="cpu")
    loop_mod.train(cfg, max_steps=8, device="cpu")
    assert calls == [0, 2] and closed == [True, True]


def test_native_fast_forward_skips_without_decoding(tmp_path, monkeypatch):
    """Fast-forwarding over 12 consumed clips parses only the clips still in
    the shuffle buffer at the resume point (4), then the 3 of the batch."""
    write_files(tmp_path, n=24, files=2)
    calls = {"n": 0}
    real = nt.parse_clip_record

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(nt, "parse_clip_record", counting)
    reader = nt.NativeTFRecordClips(data_dir=str(tmp_path), batch=3, seq_len=3, image_size=16,
                                    clip_len=6, raw_image_size=16, shuffle_buffer=4, seed=11,
                                    start_batch=4)
    assert reader.batch_at(0)["frames"].shape[0] == 3
    assert calls["n"] <= 4 + 3, calls["n"]
    monkeypatch.setattr(nt, "parse_clip_record", real)
    plain = nt.NativeTFRecordClips(data_dir=str(tmp_path), batch=3, seq_len=3, image_size=16,
                                   clip_len=6, raw_image_size=16, shuffle_buffer=0, seed=11,
                                   start_batch=4)
    monkeypatch.setattr(nt, "parse_clip_record", counting)
    calls["n"] = 0
    plain.batch_at(0)
    assert calls["n"] == 3  # no shuffle: the 12 skipped records are only framed


def test_file_sources_refuse_more_than_one_host(tmp_path):
    """What more than one host cannot share is refused, as the JAX package
    refuses it: a batch the hosts do not divide, a host without a file (a
    repeating reader over no file would spin forever); and a frame dtype
    the card does not take."""
    write_files(tmp_path)
    cfg = file_config(tmp_path, "tfrecord_native")
    with pytest.raises(ValueError, match="must be divisible by num_hosts=3"):
        make_dataset(cfg, device="cpu", num_hosts=3)
    with pytest.raises(ValueError, match="host 2 of 4 gets an empty TFRecord shard"):
        make_dataset(file_config(tmp_path, "tfrecord_native", batch_size=4), device="cpu",
                     host_id=2, num_hosts=4)
    bad = cfg.replace(data=dataclasses.replace(cfg.data, device_dtype="float16"))
    with pytest.raises(ValueError, match="device_dtype"):
        make_dataset(bad, device="cpu")


@pytest.mark.parametrize("source", ["tfrecord", "tfrecord_native"])
def test_hosts_read_disjoint_shards_and_resume_as_the_reference(tmp_path, source):
    """Two hosts read disjoint file shards (``files[host::2]``), batch/2
    clips a step each, exactly what the JAX package's make_dataset gives
    each host; a host resumed at call 3 reads what its uninterrupted stream
    read there."""
    write_files(tmp_path, n=24, files=2)
    cfg = file_config(tmp_path, source, batch_size=4)
    streams = [collect(make_dataset(cfg, stack=2, device="cpu", host_id=r, num_hosts=2), 5)
               for r in range(2)]
    for r, stream in enumerate(streams):
        assert stream[0]["frames"].shape == (2, 2, 3, 16, 16, 3)
        resumed = collect(make_dataset(cfg, stack=2, start_call=3, device="cpu", host_id=r,
                                       num_hosts=2), 2)
        assert_same(resumed, stream[3:])
        theirs = jax_make_dataset(jax_file_config(tmp_path, source, batch_size=4), host_id=r,
                                  num_hosts=2, stack=2)
        try:
            assert_same(stream, [host(theirs.batch_at(i)) for i in range(5)])
        finally:
            theirs.close()
    # Disjoint: each file's clips differ, and a host reads only its file.
    frames = [np.concatenate([b["frames"].reshape(-1, 3, 16, 16, 3) for b in s]) for s in streams]
    assert not any(np.array_equal(a, b) for a in frames[0][:4] for b in frames[1][:4])
