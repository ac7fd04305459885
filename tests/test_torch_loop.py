"""The port's training loop (``train/loop.py``), multi-step calls
(``make_multi_train_step``), held-out rollouts and metrics
(``train/sample.py``) and the ``train`` subcommand, on the CPU, against the
JAX package where it has the same function.

A config4-like run (scheduled sampling, augmentation, EMA) resumes bit for
bit, and with EMA on the held-out lines carry the EMA weights' metrics as
the JAX loop's do.

Preemption is tested as ``tests/test_preemption.py`` tests the JAX loop:
SIGTERM delivered from ``MetricWriter.tick`` (called once per call of the
step, after it), SIGKILL of a worker process after its first checkpoint.
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from action_conditioned_gans_tpu.train import init_state as jax_init_state
from action_conditioned_gans_tpu.train import loop as jax_loop
from action_conditioned_gans_tpu.train import sample as jax_sample
from action_conditioned_gans_tpu.train.step import make_multi_train_step as jax_multi_step
from action_conditioned_gans_tpu.train.step import stack_batches
from action_conditioned_gans_tpu_torch import cli
from action_conditioned_gans_tpu_torch.convert import flax_to_state_dict
from action_conditioned_gans_tpu_torch.data.synthetic import SyntheticClips
from action_conditioned_gans_tpu_torch.train import init_state, make_multi_train_step, make_train_step
from action_conditioned_gans_tpu_torch.train import sample
from action_conditioned_gans_tpu_torch.train.loop import crossed, train
from action_conditioned_gans_tpu_torch.train.rollout import scheduled_sampling_prob
from action_conditioned_gans_tpu_torch.utils.checkpoint import CheckpointManager
from action_conditioned_gans_tpu_torch.utils.metrics import MetricWriter
from tests import test_preemption
from tests.test_torch_checkpoint import assert_states_equal
from tests.test_torch_train import np_batch, np_tree, port_config, port_state, state_dicts
from tests.test_train_step import make_batch, tiny_config

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_loop_config(workdir, **train_kw):
    """tests/test_preemption.py's tiny config (16 px, float32, B=2, mesh of
    one device), with ``train_kw`` over its train section."""
    cfg = test_preemption.tiny_config(str(workdir))
    return dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, **train_kw))


def loop_config(workdir, **train_kw):
    return port_config(jax_loop_config(workdir, **train_kw))


def metric_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def steps_on_disk(workdir):
    return sorted(int(n) for n in os.listdir(os.path.join(str(workdir), "checkpoints"))
                  if n.isdigit())


def sigterm_after_first_tick(monkeypatch):
    """SIGTERM to this process from inside the first ``tick``: the handler
    runs before the loop looks at its flag, after the first call."""
    orig, fired = MetricWriter.tick, []

    def tick_and_term(self):
        orig(self)
        if not fired:
            fired.append(True)
            os.kill(os.getpid(), signal.SIGTERM)

    monkeypatch.setattr(MetricWriter, "tick", tick_and_term)


def test_crossed():
    assert crossed(0, 2, 2) and crossed(3, 5, 4) and not crossed(4, 6, 4)
    assert not crossed(0, 100, 0)


# -- multi-step calls --------------------------------------------------------------


def test_multi_step_is_two_single_steps():
    """k=2 over a stacked batch: bitwise the two single steps, and the last
    step's metrics."""
    cfg = port_config(tiny_config(steps_per_call=2, adam_moment_dtype="bfloat16"))
    fresh = lambda: init_state(cfg, torch.Generator().manual_seed(4), device="cpu")  # noqa: E731
    stacked = SyntheticClips(2, 2, 16, seed=3, stack=2, device="cpu").batch_at(0)
    multi_state, multi_m = make_multi_train_step(cfg, "cpu")(fresh(), stacked)
    single, state = make_train_step(cfg, "cpu"), fresh()
    for i in range(2):
        state, m = single(state, {k: v[i] for k, v in stacked.items()})
    assert_states_equal(multi_state, state)
    assert multi_state.step == 2
    assert sorted(multi_m) == sorted(m)
    for k in m:
        assert torch.equal(multi_m[k], m[k]), k
    with pytest.raises(ValueError, match="steps_per_call=2"):
        make_multi_train_step(cfg, "cpu")(state, {k: v[:1] for k, v in stacked.items()})
    assert make_multi_train_step(port_config(tiny_config()), "cpu").__name__ == "train_step"


def test_multi_step_matches_jax_multi_step():
    """The port's k=2 call against the jitted JAX ``make_multi_train_step``
    on the same converted state and stacked batches: the last step's
    metrics within 1e-5 abs / 1e-4 rel, parameters within 2e-5."""
    jc = tiny_config(steps_per_call=2)
    js = jax_init_state(jc, jax.random.PRNGKey(6))
    ts = port_state(jc, js)
    batches = stack_batches(make_batch(dataclasses.replace(
        jc, train=dataclasses.replace(jc.train, batch_size=4)), seed=8), 2)
    js, jm = jax.jit(jax_multi_step(jc))(js, batches, jax.random.PRNGKey(0))
    ts, tm = make_multi_train_step(port_config(jc), "cpu")(ts, np_batch(batches))
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=1e-4, err_msg=k)
    assert ts.step == int(js.step) == 2
    g_sd, d_sd = state_dicts(js)
    for mine, theirs in ((ts.g_params, g_sd), (ts.d_params, d_sd)):
        for k in mine:
            np.testing.assert_allclose(mine[k].numpy(), theirs[k].numpy(), atol=2e-5, err_msg=k)


# -- held-out rollouts and their metrics -------------------------------------------


def test_eval_metrics_match_jax():
    rng = np.random.default_rng(0)
    p = np.tanh(rng.standard_normal((3, 2, 16, 16, 3))).astype(np.float32)
    t = np.tanh(rng.standard_normal((3, 2, 16, 16, 3))).astype(np.float32)
    want = jax_sample.eval_metrics(p, t)
    for preds in (p, torch.from_numpy(p)):
        got = sample.eval_metrics(preds, torch.from_numpy(t))
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-6, rtol=1e-6, err_msg=k)


def test_rollout_fn_matches_jax():
    """Fully autoregressive (every step after the first on the previous
    prediction), the same converted generator: within 1e-5."""
    jc = tiny_config(rollout_length=3)
    js = jax_init_state(jc, jax.random.PRNGKey(2))
    batch = make_batch(jc, seed=5)
    want = jax_sample.make_rollout_fn(jc)(js.g_params, batch, jax.random.PRNGKey(0))
    g_params = flax_to_state_dict(np_tree(js.g_params))
    got = sample.make_rollout_fn(port_config(jc), "cpu")(
        g_params, {k: torch.from_numpy(np.array(v)) for k, v in np_batch(batch).items()})
    assert tuple(got.shape) == want.shape == (2, 3, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_held_out_batches():
    cfg = loop_config("unused", batch_size=4)
    first = next(sample.held_out_batches(cfg, 2, 3, seed=7919, device="cpu"))
    assert tuple(first["frames"].shape) == (2, 4, 16, 16, 3)
    want = SyntheticClips(2, 4, 16, seed=7919, device="cpu").batch_at(0)
    assert torch.equal(first["frames"], want["frames"])
    # A file source reads its held-out clips lazily: the first batch asks
    # for the files (tests/test_torch_file_train.py reads them).
    tf = cfg.replace(data=dataclasses.replace(cfg.data, source="tfrecord_native"))
    with pytest.raises(ValueError, match="data_dir"):
        next(sample.held_out_batches(tf, 2, 3, seed=1, device="cpu"))


# -- the loop ------------------------------------------------------------------------


def test_sigterm_checkpoints_and_resumes(tmp_path, monkeypatch):
    cfg = loop_config(tmp_path)
    sigterm_after_first_tick(monkeypatch)
    state = train(cfg, max_steps=10_000, device="cpu")
    assert 0 < state.step < 10_000, "SIGTERM should stop training early"
    assert steps_on_disk(tmp_path) == [state.step]
    monkeypatch.undo()
    resumed = train(cfg, max_steps=state.step + 2, device="cpu")
    assert resumed.step == state.step + 2
    assert steps_on_disk(tmp_path) == [state.step, state.step + 2]


def test_sigterm_on_a_checkpoint_boundary_saves_once(tmp_path, monkeypatch):
    """The loop saves step 2 on its checkpoint_every boundary, then SIGTERM's
    save of the same step returns False: no error, one save on disk (the
    JAX package's orbax manager raises here)."""
    cfg = loop_config(tmp_path, steps_per_call=2, checkpoint_every=2)
    results, orig_save = [], CheckpointManager.save

    def save(self, step, state, force=False):
        results.append((step, orig_save(self, step, state, force=force)))
        return results[-1][1]

    monkeypatch.setattr(CheckpointManager, "save", save)
    sigterm_after_first_tick(monkeypatch)
    state = train(cfg, max_steps=10, device="cpu")
    assert state.step == 2
    assert results == [(2, True), (2, False)]
    assert steps_on_disk(tmp_path) == [2]


def test_sigkill_resumes_from_the_latest_checkpoint(tmp_path):
    """A worker killed with SIGKILL after its first checkpoint: the steps on
    disk restore, and the next run resumes from the latest of them."""
    cfg = json.dumps(dataclasses.asdict(loop_config(tmp_path, checkpoint_every=3, log_every=3)))
    code = f"""
import json, sys
sys.path.insert(0, {REPO!r})
sys.modules["torch.utils.tensorboard"] = None  # no TensorBoard: its import takes seconds
import torch
torch.set_num_threads(1)
from action_conditioned_gans_tpu_torch.config import config_from_dict
from action_conditioned_gans_tpu_torch.train.loop import train
train(config_from_dict(json.loads({cfg!r})), max_steps=10_000, device="cpu")
"""
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS",)}
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    ckpt_dir = tmp_path / "checkpoints"
    deadline, seen = time.time() + 240, False
    try:
        while time.time() < deadline and proc.poll() is None:
            if ckpt_dir.is_dir() and any(n.isdigit() for n in os.listdir(ckpt_dir)):
                seen = True
                break
            time.sleep(0.1)
        assert seen, f"no checkpoint before the worker stopped: {proc.poll()}"
        time.sleep(0.3)
    finally:
        proc.send_signal(signal.SIGKILL)
        proc.wait(timeout=60)
    assert proc.returncode == -signal.SIGKILL
    latest = CheckpointManager(str(ckpt_dir)).latest_step()
    assert latest is not None and latest % 3 == 0 and latest > 0
    state = train(loop_config(tmp_path, checkpoint_every=3), max_steps=latest + 2, device="cpu")
    assert state.step == latest + 2


def test_resume_is_exact(tmp_path):
    """8 uninterrupted steps (k=2) against 4, then a resumed run to 8: the
    parameters, the moments and the Adam counts bit-identical."""
    kw = dict(steps_per_call=2, checkpoint_every=4, adam_moment_dtype="bfloat16")
    whole = train(loop_config(tmp_path / "whole", **kw), max_steps=8, device="cpu")
    cfg = loop_config(tmp_path / "split", **kw)
    assert train(cfg, max_steps=4, device="cpu").step == 4
    resumed = train(cfg, max_steps=8, device="cpu")
    assert whole.step == resumed.step == 8
    assert_states_equal(resumed, whole)
    assert resumed.g_opt.count == resumed.d_opt.count == 8


def config4_like(workdir, **train_kw):
    """config4's knobs at the tiny size: state and action conditioning, a
    3-step rollout with scheduled sampling, D augmentation and EMA."""
    kw = dict(rollout_length=3, scheduled_sampling=True, ss_start_prob=0.5, ss_decay_steps=8,
              d_augment="color,translation,cutout", ema_decay=0.9, steps_per_call=2,
              checkpoint_every=4)
    cfg = loop_config(workdir, **{**kw, **train_kw})
    return cfg.replace(model=dataclasses.replace(cfg.model, state_dim=3))


def test_config4_like_resume_is_exact(tmp_path, capsys):
    """8 uninterrupted steps against 4 and a resumed run to 8: parameters,
    moments, counts and g_ema bit-identical (the step's draws are a function
    of the seed and the step); each metric line's ss_prob is the schedule's
    at the line's last step."""
    whole = train(config4_like(tmp_path / "whole", log_every=2), max_steps=8, device="cpu")
    lines = [r for r in metric_lines(capsys.readouterr().out) if "ss_prob" in r]
    assert [r["step"] for r in lines] == [2, 4, 6, 8]
    cfg = config4_like(tmp_path / "split")
    for r in lines:
        assert r["ss_prob"] == float(np.float32(scheduled_sampling_prob(r["step"] - 1, cfg.train)))
    assert train(cfg, max_steps=4, device="cpu").step == 4
    resumed = train(cfg, max_steps=8, device="cpu")
    assert resumed.g_ema is not None and whole.step == resumed.step == 8
    assert_states_equal(resumed, whole)


def test_ema_eval_lines_match_the_jax_loop(tmp_path, capsys):
    """With EMA on, both loops write the held-out metrics of the EMA weights
    (``*_ema``) beside the raw ones, at the same steps."""
    kw = dict(steps_per_call=2, log_every=4, checkpoint_every=4, sample_every=4, ema_decay=0.9)
    jax_loop.train(jax_loop_config(tmp_path / "jax", **kw), max_steps=4)
    theirs = metric_lines(capsys.readouterr().out)
    train(loop_config(tmp_path / "port", **kw), max_steps=4, device="cpu")
    mine = metric_lines(capsys.readouterr().out)
    shape = lambda lines: [(r["step"], sorted(r)) for r in lines]  # noqa: E731
    assert shape(mine) == shape(theirs)
    evals = [r for r in mine if "eval_l2" in r]
    assert len(evals) == 1 and {"eval_l2_ema", "eval_psnr_ema"} <= set(evals[0])


def test_resume_asks_for_the_next_batch(tmp_path, monkeypatch):
    """k=2: a run to 4 takes batches 0 and 1; the resumed run to 8 asks for
    batch 4 // 2 = 2 first."""
    asked, orig = [], SyntheticClips.batch_at

    def batch_at(self, index):
        if self.seed == 0:  # the training stream (held-out clips use seed + 7919)
            asked.append(index)
        return orig(self, index)

    monkeypatch.setattr(SyntheticClips, "batch_at", batch_at)
    cfg = loop_config(tmp_path, steps_per_call=2, checkpoint_every=4)
    train(cfg, max_steps=4, device="cpu")
    assert asked == [0, 1]
    asked.clear()
    train(cfg, max_steps=8, device="cpu")
    assert asked == [2, 3]


def test_cadence_matches_the_jax_loop(tmp_path, capsys):
    """One config through the JAX loop and the port's: metric lines (train
    and eval) at the same steps with the same keys, the same checkpoint
    steps on disk. k=2 to 7 steps overshoots to 8 in both."""
    kw = dict(steps_per_call=2, log_every=3, checkpoint_every=4, sample_every=4,
              checkpoint_keep=2)
    jax_loop.train(jax_loop_config(tmp_path / "jax", **kw), max_steps=7)
    theirs = metric_lines(capsys.readouterr().out)
    train(loop_config(tmp_path / "port", **kw), max_steps=7, device="cpu")
    mine = metric_lines(capsys.readouterr().out)
    shape = lambda lines: [(r["step"], sorted(r)) for r in lines]  # noqa: E731
    assert shape(mine) == shape(theirs)
    assert [r["step"] for r in mine] == [2, 4, 4, 6, 8]
    assert steps_on_disk(tmp_path / "port") == steps_on_disk(tmp_path / "jax") == [4, 8]
    assert all(np.isfinite(v) for r in mine for v in r.values())


def test_unported_sources_and_meshes_are_refused(tmp_path):
    """A file source without files is refused before a step; so is a mesh
    whose data x model axes the process group does not fill (a model axis
    of 2 on one process, a data axis of 2: data and channel parallelism run
    one process per device, tests/test_torch_multihost.py and
    tests/test_torch_tp.py). data=-1 and data=1 run on the one device."""
    cfg = loop_config(tmp_path)
    # The file sources train (tests/test_torch_file_train.py).
    tf = cfg.replace(data=dataclasses.replace(cfg.data, source="tfrecord_native"))
    with pytest.raises(ValueError, match="data_dir"):
        train(tf, max_steps=1, device="cpu")
    with pytest.raises(ValueError, match="mesh data=1 x model=2 needs a process group of 2"):
        train(cfg.replace(mesh=dataclasses.replace(cfg.mesh, data=1, model=2)), max_steps=1,
              device="cpu")
    with pytest.raises(ValueError, match="mesh data=2 needs a process group of 2 ranks"):
        train(cfg.replace(mesh=dataclasses.replace(cfg.mesh, data=2)), max_steps=1, device="cpu")
    for data in (-1, 1):
        one_card = cfg.replace(mesh=dataclasses.replace(cfg.mesh, data=data))
        assert train(one_card, max_steps=1, device="cpu",
                     workdir=str(tmp_path / f"one{data}")).step == 1


def test_train_needs_a_device_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(loop_config(tmp_path), max_steps=1)
    assert not os.path.exists(tmp_path / "checkpoints")


def test_debug_nans_raises_at_the_first_non_finite_log(tmp_path):
    cfg = loop_config(tmp_path, g_lr=float("nan"), log_every=1, debug_nans=True)
    with pytest.raises(FloatingPointError, match="step 2"):
        train(cfg, max_steps=4, device="cpu")


def test_profile_steps_write_a_trace(tmp_path, capsys):
    """A run too short for the three-call warm-up clamps it and still
    traces, flushing the window at the loop's end."""
    train(loop_config(tmp_path), max_steps=2, profile_steps=1, device="cpu")
    out = capsys.readouterr().out
    assert "profile warmup clamped to 1 step(s)" in out and "flushed at loop exit" in out
    traces = os.listdir(tmp_path / "profile")
    assert len(traces) == 1 and traces[0].endswith(".json")
    with open(tmp_path / "profile" / traces[0]) as f:
        assert json.load(f)["traceEvents"]


# -- the CLI ---------------------------------------------------------------------------

TINY = ["--set", "model.image_size=16", "--set", "model.g_levels=2",
        "--set", "model.g_base_channels=8", "--set", "model.d_levels=2",
        "--set", "model.d_base_channels=8", "--set", "model.group_norm_groups=4",
        "--set", "model.compute_dtype=float32", "--set", "train.batch_size=2",
        "--set", "train.steps_per_call=1", "--set", "train.log_every=1",
        "--set", "train.checkpoint_every=2", "--set", "train.sample_every=0"]


def test_parser_takes_train_and_bench():
    p = cli.build_parser()
    args = p.parse_args(["train", "--workdir", "w", "--steps", "5", "--no-resume",
                         "--profile-steps", "2", "--device", "cpu", "--set", "train.seed=3"])
    assert (args.command, args.workdir, args.steps, args.no_resume, args.profile_steps,
            args.device, args.overrides) == ("train", "w", 5, True, 2, "cpu", ["train.seed=3"])
    assert p.parse_args(["bench"]).command == "bench"


def test_cli_train_writes_metrics_and_checkpoints_and_resumes(tmp_path, capsys):
    argv = ["train", "--device", "cpu", "--preset", "config1", "--workdir", str(tmp_path), *TINY]
    assert cli.main([*argv, "--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert [r["step"] for r in metric_lines(out)] == [1, 2]
    assert steps_on_disk(tmp_path) == [2]
    assert cli.main([*argv, "--steps", "3"]) == 0
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 2" in out
    assert [r["step"] for r in metric_lines(out)] == [3]
    assert steps_on_disk(tmp_path) == [2, 3]
    assert cli.main([*argv, "--steps", "1", "--no-resume"]) == 0
    assert "resumed" not in capsys.readouterr().out
