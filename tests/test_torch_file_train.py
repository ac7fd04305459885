"""The slice as a whole on the CPU: the port's ``train`` on clip files
(``data.source="tfrecord_native"``) against the JAX package. The batches the
loop consumes are the JAX package's ``make_dataset`` batches; a step on
them with JAX-drawn randoms matches ``jit_train_step``; ``make-data`` files
read back through both packages' readers; held-out clips come from
``eval_data_dir`` and their reader's thread ends with the loop; a resume is
bit for bit."""

import dataclasses
import json
import threading

import jax
import numpy as np
import pytest
import torch

from action_conditioned_gans_tpu.data import make_dataset as jax_make_dataset
from action_conditioned_gans_tpu.data import native_tfrecord as ref
from action_conditioned_gans_tpu.train import init_state as jax_init_state
from action_conditioned_gans_tpu.train.step import jit_train_step
from action_conditioned_gans_tpu_torch import cli
from action_conditioned_gans_tpu_torch.data import native_tfrecord as nt
from action_conditioned_gans_tpu_torch.data import pipeline
from action_conditioned_gans_tpu_torch.data.synthetic import draw_clip_randoms, render_clips
from action_conditioned_gans_tpu_torch.train import loop as loop_mod
from action_conditioned_gans_tpu_torch.train import make_train_step
from action_conditioned_gans_tpu_torch.train import sample
from action_conditioned_gans_tpu_torch.train.state import restore_state
from action_conditioned_gans_tpu_torch.utils.checkpoint import CheckpointManager
from tests.test_torch_checkpoint import assert_states_equal
from tests.test_torch_native_tfrecord import write_files
from tests.test_torch_resume_data import host, jax_file_config
from tests.test_torch_train import jax_randoms, port_config, port_state

torch.set_num_threads(1)


def configs(tmp_path, **train_kw):
    """(JAX config, port config) of a tiny model training on the files of
    ``tmp_path/data`` with a held-out split in ``tmp_path/eval``."""
    kw = dict(log_every=100, checkpoint_every=0, sample_every=0)
    kw.update(train_kw)
    jc = jax_file_config(tmp_path / "data", "tfrecord_native", **kw)
    jc = dataclasses.replace(jc, workdir=str(tmp_path / "work"),
                             data=dataclasses.replace(jc.data, eval_data_dir=str(tmp_path / "eval")))
    return jc, port_config(jc)


@pytest.fixture
def files(tmp_path):
    (tmp_path / "data").mkdir()
    (tmp_path / "eval").mkdir()
    write_files(tmp_path / "data", n=24, files=2, seed=0)
    write_files(tmp_path / "eval", n=6, files=1, seed=1)
    return tmp_path


def test_the_loop_consumes_the_reference_batches(files, monkeypatch):
    jc, cfg = configs(files)
    seen, real = [], pipeline.Prefetcher.batch_at

    def spy(self, index):
        out = real(self, index)
        seen.append(host(out))
        return out

    monkeypatch.setattr(pipeline.Prefetcher, "batch_at", spy)
    loop_mod.train(cfg, max_steps=6, device="cpu")
    assert len(seen) == 3 and seen[0]["frames"].shape == (2, 2, 3, 16, 16, 3)
    theirs = jax_make_dataset(jc, stack=2)
    try:
        for i, mine in enumerate(seen):
            want = theirs.batch_at(i)
            for k in mine:
                assert np.array_equal(mine[k], np.asarray(want[k])), (i, k)
    finally:
        theirs.close()


def test_a_step_on_file_batches_matches_jit_train_step(files):
    """Two steps on the files' batches, scheduled sampling mixing, the
    draws JAX makes fed to the port: every metric within 1e-5 abs / 1e-4
    rel, as tests/test_torch_train.py holds the steps."""
    jc, cfg = configs(files, scheduled_sampling=True, ss_start_prob=0.5)
    js = jax_init_state(jc, jax.random.PRNGKey(3))
    ts = port_state(jc, js)
    jstep, tstep = jit_train_step(jc), make_train_step(cfg, device="cpu")
    reader = nt.NativeTFRecordClips(str(files / "data"), 2, 3, 16, clip_len=6, raw_image_size=16,
                                    shuffle_buffer=4, seed=5)
    rng = jax.random.PRNGKey(5)
    for i in range(2):
        batch = reader.batch_at(i)
        b, horizon = batch["actions"].shape[:2]
        js, jm = jstep(js, batch, rng)
        ts, tm = tstep(ts, batch, jax_randoms(jc, rng, i, b, horizon))
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=1e-4, err_msg=k)


def test_make_data_round_trips_through_both_readers(tmp_path, capsys):
    out = tmp_path / "d" / "clips.tfrecord"
    rc = cli.main(["make-data", "--device", "cpu", "--preset", "config1", "--num-clips", "70",
                   "--set", "model.image_size=16", "--set", "data.clip_len=5",
                   "--set", "train.seed=3", "--out", str(out)])
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"written": str(out), "clips": 70, "clip_len": 5}
    # The clips the file holds: the port's synthetic clips of seed 3, drawn at
    # once, rendered (in chunks of 64) and rounded to uint8; actions and
    # states padded with a row of zeros.
    gen = torch.Generator().manual_seed(3)
    clips = render_clips(draw_clip_randoms(gen, 70, 5, 4), 5, 16, 4)
    want = np.round((np.clip(clips["frames"].numpy(), -1, 1) + 1) * 127.5).astype(np.uint8)
    mine = list(nt.read_clips(str(out), 5, 16, 16))
    theirs = list(ref.read_clips(str(out), 5, 16, 16))
    assert len(mine) == len(theirs) == 70
    for i, ((mf, ma, ms), (rf, ra, rs)) in enumerate(zip(mine, theirs)):
        assert np.array_equal(mf, rf) and np.array_equal(ma, ra) and np.array_equal(ms, rs)
        assert np.array_equal(mf, want[i])
        assert np.array_equal(ma[:4], clips["actions"][i].numpy()) and not ma[4].any()
        assert np.array_equal(ms[:4], clips["states"][i].numpy()) and not ms[4].any()


def test_held_out_clips_come_from_eval_data_dir(files, monkeypatch):
    jc, cfg = configs(files, sample_every=2)
    dirs, real = [], loop_mod.make_dataset

    def spy(c, **kw):
        dirs.append(c.data.data_dir)
        return real(c, **kw)

    monkeypatch.setattr(pipeline, "make_dataset", spy)
    monkeypatch.setattr(sample, "make_dataset", spy)
    loop_mod.train(cfg, max_steps=4, device="cpu")
    assert dirs == [str(files / "eval")]  # one held-out batch, read once
    assert not [t for t in threading.enumerate() if t.name == pipeline.FILL_THREAD]
    stream = sample.held_out_batches(cfg, 2, 2, seed=7, device="cpu")
    got = next(stream)
    stream.close()
    reader = nt.NativeTFRecordClips(str(files / "eval"), 2, 3, 16, clip_len=6, raw_image_size=16,
                                    shuffle_buffer=4, seed=7)
    want = reader.batch_at(0)
    for k in want:
        assert np.array_equal(got[k].numpy(), want[k]), k
    assert not [t for t in threading.enumerate() if t.name == pipeline.FILL_THREAD]
    # Without eval_data_dir the training files are read.
    no_eval = cfg.replace(data=dataclasses.replace(cfg.data, eval_data_dir=None))
    dirs.clear()
    stream = sample.held_out_batches(no_eval, 2, 2, seed=7, device="cpu")
    next(stream)
    stream.close()
    assert dirs == [str(files / "data")]


def test_a_resume_is_bit_for_bit(files):
    """6 steps, then 6 more from the step-6 checkpoint (the 24 clips wrap
    in the second run), against 12 uninterrupted."""
    _, cfg = configs(files, checkpoint_every=6, sample_every=4)
    split, whole = str(files / "split"), str(files / "whole")
    loop_mod.train(cfg, max_steps=6, workdir=split, device="cpu")
    resumed = loop_mod.train(cfg, max_steps=12, workdir=split, device="cpu")
    straight = loop_mod.train(cfg, max_steps=12, workdir=whole, device="cpu")
    assert resumed.step == straight.step == 12
    assert_states_equal(resumed, straight)
    on_disk = restore_state(cfg, CheckpointManager(f"{split}/checkpoints"), template=straight)
    assert_states_equal(on_disk, straight)
