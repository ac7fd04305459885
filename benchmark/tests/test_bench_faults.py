"""A run of each cell at a tiny size on the CPU, past the harness's look for
a card, with the timed path broken underneath: ``correct`` has to come out
false for each fault the cell can have. Training: a step that returns its
state unchanged; half of each batch left out, the mean taken over the rest.
Serving: one candidate's frame altered where it is produced; a rollout that
feeds ``frame0`` to every step (its state left unchanged). One chip, so no
exchange between chips to leave out. The sound tiny run in float32 comes
out correct."""

import copy
import dataclasses
import time

import pytest
import torch

from benchmark import harness

from conftest import tiny

torch.set_num_threads(2)


def run(name, seed=4, dtype="bfloat16"):
    found = tiny(harness.find_cell(name))
    cfg = found["config"]["config"]
    cfg["model"]["compute_dtype"] = dtype
    return harness.run_cell(name, seed, 0.3, False, time.perf_counter(), device="cpu",
                            config=cfg)


def state_unchanged(orig):
    def make(cfg, mesh, *a, **kw):
        real = orig(cfg, mesh, *a, **kw)

        def step(state, batch, *rest):
            _, metrics = real(copy.deepcopy(state), batch, *rest)
            return state, metrics

        return step

    return make


def halved(batch, axis):
    """The first half of each batch's rows."""
    return {k: v.narrow(axis, 0, v.shape[axis] // 2) for k, v in batch.items()}


def half_batch(orig):
    def make(cfg, mesh, *a, **kw):
        half = cfg.replace(train=dataclasses.replace(cfg.train,
                                                     batch_size=cfg.train.batch_size // 2))
        real = orig(half, mesh, *a, **kw)
        axis = int(cfg.train.steps_per_call > 1)

        def step(state, batch, *rest):
            return real(state, halved(batch, axis), *rest)

        return step

    return make


@pytest.mark.parametrize("name", ["config5.train"])
@pytest.mark.parametrize("fault", [state_unchanged, half_batch])
def test_training_faults_are_not_correct(monkeypatch, name, fault):
    from action_conditioned_gans_tpu_torch.parallel import dp

    monkeypatch.setattr(dp, "make_dp_train_step", fault(dp.make_dp_train_step))
    line = run(name)
    assert line["correct"] is False, line["check"]


def altered_frame(monkeypatch):
    from action_conditioned_gans_tpu_torch.infer import Predictor

    orig = Predictor.rollout

    def rollout(self, frame0, actions, states=None):
        out = orig(self, frame0, actions, states).clone()
        out[0, out.shape[1] // 2] += 0.25
        return out

    monkeypatch.setattr(Predictor, "rollout", rollout)


def frame0_every_step(monkeypatch):
    from action_conditioned_gans_tpu_torch import infer

    def rollout_scan(apply_fn, frame0, actions, states=None):
        return torch.stack([apply_fn(frame0, actions[:, t], None)
                            for t in range(actions.shape[1])], dim=1)

    monkeypatch.setattr(infer, "rollout_scan", rollout_scan)


@pytest.mark.parametrize("name", ["config5.serve", "config1.serve"])
@pytest.mark.parametrize("fault", [altered_frame, frame0_every_step])
def test_serving_faults_are_not_correct(monkeypatch, name, fault):
    fault(monkeypatch)
    line = run(name)
    assert line["correct"] is False, line["check"]


@pytest.mark.parametrize("name", ["config5.train", "config5.serve", "config1.serve"])
def test_the_sound_tiny_run_is_correct(name):
    """In float32 the program and the reference compute the same numbers;
    the limits are the cells' own, set at their sizes in bf16."""
    line = run(name, dtype="float32")
    assert line["correct"] is True, line["check"]
    assert max(c["value"] for c in line["check"].values()) < 1e-5
    assert line["failed"] == 0
