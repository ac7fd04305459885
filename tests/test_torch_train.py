"""The port's training slice against the JAX package's, on the CPU.

Losses, Adam (float32 and bfloat16 moments, clipping, schedules) against
optax, the learning-rate schedules, one fused step's metrics, parameters and
moments against ``jit_train_step`` (also with each of the six knobs of the
rollout and the step: scheduled sampling, time chunks, remat, D
microbatching, EMA and D augmentation, the JAX-drawn randoms fed to the
port), and the four-step golden trajectory of
tests/test_golden.py reproduced from converted ``init_state`` parameters and
the JAX ``make_batch`` batches. Also the committed training fixture
``tests/fixtures/torch_port_tiny_train.npz`` (replayed on the GPU by
chip_smoke.py, where there is no JAX): regenerated here with JAX, and
replayed by the port.

Weights cross with ``convert.py``; batches cross as numpy arrays.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from action_conditioned_gans_tpu.config import TrainConfig as JaxTrainConfig
from action_conditioned_gans_tpu.train import augment as JA
from action_conditioned_gans_tpu.train import init_state as jax_init_state
from action_conditioned_gans_tpu.train import losses as JL
from action_conditioned_gans_tpu.train import state as JS
from action_conditioned_gans_tpu.train.rollout import scheduled_sampling_prob as jax_ss_prob
from action_conditioned_gans_tpu.train.step import jit_train_step
from action_conditioned_gans_tpu_torch import config as tcfg
from action_conditioned_gans_tpu_torch.convert import flatten_flax, flax_to_state_dict
from action_conditioned_gans_tpu_torch.models import Generator
from action_conditioned_gans_tpu_torch.train import TrainState, init_state, losses, make_train_step
from action_conditioned_gans_tpu_torch.data.synthetic import batch_seed
from action_conditioned_gans_tpu_torch.train import state as S
from action_conditioned_gans_tpu_torch.train.step import StepRandoms, disc_chunks, draw_step_randoms
from action_conditioned_gans_tpu_torch.train.rollout import (
    rollout_teacher_forced,
    scheduled_sampling_prob,
)
from tests.test_train_step import make_batch, tiny_config

torch.set_num_threads(1)
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_port_tiny_train.npz")
# tests/test_golden.py::test_train_step_loss_trajectory_golden: (d_loss,
# g_loss, g_recon) per step, and its tolerances.
GOLDEN = [
    (1.403255, 1.531947, 0.075054),
    (1.400398, 1.732495, 0.102866),
    (1.400784, 1.614021, 0.087148),
    (1.372578, 1.408354, 0.064585),
]
GOLDEN_TOL = [dict(atol=2e-4, rtol=1e-3), dict(atol=2e-3, rtol=1e-3), dict(atol=2e-4, rtol=1e-3)]


def port_config(jax_cfg):
    return tcfg.config_from_dict(dataclasses.asdict(jax_cfg))


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def state_dicts(jax_state):
    """A JAX TrainState's g_params and d_params as the port's state_dicts."""
    return flax_to_state_dict(np_tree(jax_state.g_params)), flax_to_state_dict(np_tree(jax_state.d_params))


def port_state(jax_cfg, jax_state):
    g_sd, d_sd = state_dicts(jax_state)
    return S.state_from_params(port_config(jax_cfg), g_sd, d_sd, device="cpu")


def np_batch(batch):
    return {k: np.asarray(v) for k, v in batch.items()}


def adam_states(opt_state):
    return [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]


# -- losses ----------------------------------------------------------------------


def logits(seed, n=32):
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32) * 4
    x[:2] = [30.0, -30.0]  # beyond torch softplus's default threshold
    return x


@pytest.mark.parametrize("smooth", [0.0, 0.1])
def test_discriminator_losses_match_jax(smooth):
    r, f = logits(0), logits(1)
    got = losses.discriminator_loss(torch.from_numpy(r), torch.from_numpy(f), smooth)
    np.testing.assert_allclose(float(got), float(JL.discriminator_loss(r, f, smooth)), rtol=1e-6)
    got = losses.discriminator_hinge_loss(torch.from_numpy(r), torch.from_numpy(f))
    np.testing.assert_allclose(float(got), float(JL.discriminator_hinge_loss(r, f)), rtol=1e-6)
    acc = losses.discriminator_accuracy(torch.from_numpy(r), torch.from_numpy(f))
    np.testing.assert_array_equal([float(a) for a in acc],
                                  [float(a) for a in JL.discriminator_accuracy(r, f)])


@pytest.mark.parametrize("kind", ["l2", "l1"])
def test_generator_losses_match_jax(kind):
    f = logits(2)
    np.testing.assert_allclose(float(losses.generator_adv_loss(torch.from_numpy(f))),
                               float(JL.generator_adv_loss(f)), rtol=1e-6)
    np.testing.assert_allclose(float(losses.generator_hinge_adv_loss(torch.from_numpy(f))),
                               float(JL.generator_hinge_adv_loss(f)), rtol=1e-6)
    p = np.random.default_rng(3).standard_normal((2, 4, 4, 3)).astype(np.float32)
    q = np.random.default_rng(4).standard_normal((2, 4, 4, 3)).astype(np.float32)
    got = losses.reconstruction_loss(torch.from_numpy(p).to(torch.bfloat16), torch.from_numpy(q), kind)
    want = JL.reconstruction_loss(jnp.asarray(p).astype(jnp.bfloat16), q, kind)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    with pytest.raises(ValueError):
        losses.reconstruction_loss(torch.zeros(1), torch.zeros(1), "l3")


# -- schedules and Adam ------------------------------------------------------------

SCHEDULES = [
    dict(),
    dict(lr_schedule="linear", warmup_steps=3, total_steps=20, lr_end_factor=0.1),
    dict(lr_schedule="cosine", warmup_steps=0, lr_decay_steps=7, lr_end_factor=0.2),
    dict(lr_schedule="constant", warmup_steps=4),
]


@pytest.mark.parametrize("kw", SCHEDULES)
def test_lr_schedules_match_jax(kw):
    t = tcfg.TrainConfig(**kw)
    jt = JaxTrainConfig(**kw)
    for k in (1, 3):
        mine, theirs = S.make_lr_schedule(t, 2e-4, k), JS.make_lr_schedule(jt, 2e-4, k)
        for count in range(0, 70, 3):
            a = mine(count) if callable(mine) else mine
            b = float(theirs(count)) if callable(theirs) else theirs
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-12)
    for count in range(0, 25):
        assert S.lr_value(t, 2e-4, count) == JS.lr_value(jt, 2e-4, count)


ADAM_CASES = [
    dict(adam_moment_dtype="float32"),
    dict(adam_moment_dtype="bfloat16"),
    dict(adam_moment_dtype="float32", grad_clip_norm=0.5, lr_schedule="cosine", warmup_steps=2,
         total_steps=10),
    dict(adam_moment_dtype="bfloat16", grad_clip_norm=0.5, lr_schedule="linear", warmup_steps=1,
         total_steps=10),
]


@pytest.mark.parametrize("kw", ADAM_CASES)
def test_adam_matches_optax(kw):
    """Four updates of G's optimizer; the second gradient is large, so the
    clipping case clips it and leaves the others alone."""
    jc = tiny_config(**kw)
    g_tx, _ = JS.make_optimizers(jc)
    tx, _ = S.make_optimizers(port_config(jc))
    rng = np.random.default_rng(0)
    params = {"a": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(5).astype(np.float32)}
    jp, jstate = dict(params), g_tx.init(params)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tstate = tx.init(tp)
    for i in range(4):
        grads = {k: (rng.standard_normal(v.shape) * (3.0 if i == 1 else 0.05)).astype(np.float32)
                 for k, v in params.items()}
        upd, jstate = g_tx.update(grads, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tx.update_(tp, [torch.from_numpy(grads[k]) for k in tp], tstate)
    (adam,) = adam_states(jstate)
    assert tstate.count == int(adam.count) == 4
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), atol=1e-6, rtol=1e-5)
        assert tstate.mu[k].dtype == getattr(torch, kw["adam_moment_dtype"])
        for mine, theirs in ((tstate.mu[k], adam.mu[k]), (tstate.nu[k], adam.nu[k])):
            np.testing.assert_allclose(mine.float().numpy(),
                                       np.asarray(jnp.asarray(theirs).astype(jnp.float32)),
                                       atol=1e-7, rtol=1e-5)


# -- the step ------------------------------------------------------------------------


STEP_CASES = {  # name: (train knobs, model knobs)
    "bf16_moments_clip_schedule_smooth": (dict(
        adam_moment_dtype="bfloat16", grad_clip_norm=0.5, lr_schedule="cosine", warmup_steps=1,
        total_steps=10, d_label_smooth=0.1, log_grad_norms=True), {}),
    "hinge_l1_two_disc_steps": (dict(gan_loss="hinge", recon_type="l1", disc_steps=2,
                                     rollout_length=2, log_grad_norms=True), {}),
    "state_skips_extra_d_layer": (dict(rollout_length=2),
                                  dict(state_dim=3, skip_connections=True, d_extra_layers=1)),
}


@pytest.mark.parametrize("name", sorted(STEP_CASES))
def test_steps_match_jit_train_step(name):
    """Two steps: every metric, then the updated parameters and Adam moments."""
    train_kw, model_kw = STEP_CASES[name]
    jc = tiny_config(**train_kw)
    jc = dataclasses.replace(jc, model=dataclasses.replace(jc.model, **model_kw))
    js = jax_init_state(jc, jax.random.PRNGKey(3))
    ts = port_state(jc, js)
    jstep, tstep = jit_train_step(jc), make_train_step(port_config(jc), device="cpu")
    for i in range(2):
        batch = make_batch(jc, seed=10 + i)
        js, jm = jstep(js, batch, jax.random.PRNGKey(0))
        ts, tm = tstep(ts, np_batch(batch))
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=1e-4, err_msg=k)
    assert ts.step == int(js.step) == 2
    g_sd, d_sd = state_dicts(js)
    # lr is 2e-4: a wrong sign or a missing update moves a parameter by >= 2e-4.
    for mine, theirs in ((ts.g_params, g_sd), (ts.d_params, d_sd)):
        assert mine.keys() == theirs.keys()
        for k in mine:
            np.testing.assert_allclose(mine[k].numpy(), theirs[k].numpy(), atol=2e-5, err_msg=k)
    for opt, jopt in ((ts.g_opt, js.g_opt), (ts.d_opt, js.d_opt)):
        (adam,) = adam_states(jopt)
        mu = flatten_flax(np_tree(jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), adam.mu)))
        assert opt.count == int(adam.count)
        for k, v in mu.items():
            # mu is (1 - b1) g, up to 1e-2 here: gradients agree to 1e-3 of that.
            np.testing.assert_allclose(opt.mu[k.replace("/", ".")].float().numpy(), v,
                                       atol=1e-5, rtol=1e-2, err_msg=k)


@pytest.fixture(scope="module")
def jax_trajectory():
    return make_train_fixture()


TRAJECTORY = ("d_loss", "g_loss", "g_recon")


def make_train_fixture(cfg=None, keys=TRAJECTORY) -> dict:
    """The JAX package's tiny training run of tests/test_golden.py (or of
    ``cfg``): the config as JSON, the converted init params ("g/..." and
    "d/..." Flax keys), the four batches and the trajectory of ``keys``
    ((d_loss, g_loss, g_recon)) of ``jit_train_step``."""
    cfg = tiny_config(rollout_length=2) if cfg is None else cfg
    state = jax_init_state(cfg, jax.random.PRNGKey(0))
    arrays = {"__config__": np.asarray(json.dumps(dataclasses.asdict(cfg)))}
    for prefix, params in (("g", state.g_params), ("d", state.d_params)):
        for k, v in flatten_flax(np_tree(params)).items():
            arrays[f"{prefix}/{k}"] = v
    step, traj = jit_train_step(cfg), []
    for i in range(4):
        batch = make_batch(cfg, seed=i)
        arrays[f"batch{i}/frames"] = np.asarray(batch["frames"])
        arrays[f"batch{i}/actions"] = np.asarray(batch["actions"])
        state, m = step(state, batch, jax.random.PRNGKey(100))
        traj.append([float(m[k]) for k in keys])
    arrays["trajectory"] = np.asarray(traj, np.float32)
    return arrays


def replay(arrays, keys=TRAJECTORY):
    """The port's trajectory of ``keys`` over a fixture's params and
    batches, on the CPU."""
    cfg = tcfg.config_from_dict(json.loads(str(arrays["__config__"])))
    sds = [{k[2:].replace("/", "."): torch.from_numpy(np.array(v)) for k, v in arrays.items()
            if k.startswith(p)} for p in ("g/", "d/")]
    state, step, traj = S.state_from_params(cfg, *sds, device="cpu"), make_train_step(cfg, "cpu"), []
    for i in range(4):
        batch = {k: arrays[f"batch{i}/{k}"] for k in ("frames", "actions")}
        state, m = step(state, batch)
        traj.append([float(m[k]) for k in keys])
    return traj


def test_port_reproduces_the_golden_trajectory(jax_trajectory):
    """Converted init_state params and the JAX make_batch batches: the
    port's four steps hold test_golden.py's trajectory within its
    tolerances."""
    traj = replay(jax_trajectory)
    for got, want in zip(traj, GOLDEN):
        for a, b, tol in zip(got, want, GOLDEN_TOL):
            np.testing.assert_allclose(a, b, **tol)
    np.testing.assert_allclose(traj, jax_trajectory["trajectory"], atol=1e-5, rtol=1e-5)


def test_committed_train_fixture_matches_jax_regeneration(jax_trajectory):
    with np.load(FIXTURE) as z:
        committed = {k: z[k] for k in z.files}
    assert sorted(committed) == sorted(jax_trajectory)
    for k, v in jax_trajectory.items():
        if k == "trajectory":
            np.testing.assert_allclose(committed[k], v, atol=1e-6, rtol=1e-6)
        else:
            np.testing.assert_array_equal(committed[k], v, err_msg=k)


def test_port_reproduces_the_committed_train_fixture():
    with np.load(FIXTURE) as z:
        arrays = {k: z[k] for k in z.files}
    traj = replay(arrays)
    for got, want in zip(traj, arrays["trajectory"]):
        for a, b, tol in zip(got, want, GOLDEN_TOL):
            np.testing.assert_allclose(a, b, **tol)


# -- knobs, state, rollout -------------------------------------------------------


def test_unknown_augment_op_raises_at_step_build():
    """As the JAX package's step does: a typo'd op fails at build."""
    with pytest.raises(ValueError, match="unknown d_augment op 'flip'"):
        make_train_step(port_config(tiny_config(d_augment="color,flip")), device="cpu")


# -- the six knobs of the rollout and the step, against JAX ---------------------------


def jax_randoms(jc, rng, step, b, horizon, rank=None):
    """The draws JAX's step makes from ``rng`` at ``step`` (its key folded
    with the step, and under ``make_dp_train_step`` with the ``rank``'s
    ``axis_index``, then split: the rollout key, then the augment key into
    real / fake / G head), as the port's StepRandoms; ``b`` is the rank's
    batch."""
    t = jc.train
    key = jax.random.fold_in(rng, step)
    if rank is not None:
        key = jax.random.fold_in(key, rank)
    key, gkey = jax.random.split(key)
    out = StepRandoms()
    if t.scheduled_sampling:
        p = jax_ss_prob(jnp.asarray(step), t)
        keys = jax.random.split(gkey, horizon)
        out.use_pred = torch.from_numpy(np.stack(
            [np.asarray(jax.random.bernoulli(k, p, (b,))) for k in keys], axis=1))
    ops = JA.parse_policy(t.d_augment)
    if ops:
        _, akey = jax.random.split(key)
        out.u_real, out.u_fake, out.u_g = (
            torch.from_numpy(np.array(JA.draw_params(k, ops, b * horizon)))
            for k in jax.random.split(akey, 3))
    return out


KNOB_CASES = {  # name: (train knobs, model knobs)
    "scheduled_sampling": (dict(scheduled_sampling=True, ss_start_prob=0.5, rollout_length=3),
                           dict(state_dim=3)),
    "time_chunk_remat": (dict(rollout_length=4, rollout_time_chunk=2, remat_rollout=True), {}),
    "ss_remat": (dict(scheduled_sampling=True, ss_start_prob=0.5, rollout_length=3,
                      remat_rollout=True), {}),
    "disc_microbatch": (dict(rollout_length=4, disc_microbatch=3, log_grad_norms=True),
                        dict(state_dim=3)),
    "ema": (dict(ema_decay=0.9, rollout_length=2), {}),
    "d_augment": (dict(d_augment="color,translation,cutout", rollout_length=2), {}),
    "all_six": (dict(scheduled_sampling=True, ss_start_prob=0.5, rollout_length=4,
                     remat_rollout=True, rollout_time_chunk=2, disc_microbatch=4, ema_decay=0.99,
                     d_augment="color,translation,cutout"), dict(state_dim=3)),
}


@pytest.mark.parametrize("name", sorted(KNOB_CASES))
def test_knob_steps_match_jit_train_step(name):
    """Two steps with the randoms JAX draws fed to the port: every metric
    (1e-5 abs / 1e-4 rel), the updated parameters (2e-5) and g_ema (2e-5),
    inside tests/test_golden.py's tolerances."""
    train_kw, model_kw = KNOB_CASES[name]
    jc = tiny_config(**train_kw)
    jc = dataclasses.replace(jc, model=dataclasses.replace(jc.model, **model_kw))
    js = jax_init_state(jc, jax.random.PRNGKey(3))
    ts = port_state(jc, js)
    assert (ts.g_ema is not None) == (jc.train.ema_decay > 0)
    jstep, tstep = jit_train_step(jc), make_train_step(port_config(jc), device="cpu")
    rng = jax.random.PRNGKey(5)
    for i in range(2):
        batch = make_batch(jc, seed=20 + i)
        b, horizon = batch["actions"].shape[:2]
        randoms = jax_randoms(jc, rng, i, b, horizon)
        js, jm = jstep(js, batch, rng)
        ts, tm = tstep(ts, np_batch(batch), randoms)
        assert sorted(tm) == sorted(jm)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), atol=1e-5, rtol=1e-4, err_msg=k)
    if jc.train.scheduled_sampling:
        assert 0 < float(randoms.use_pred[:, 1:].float().mean()) < 1  # a real mix
    assert ts.step == int(js.step) == 2
    g_sd, d_sd = state_dicts(js)
    pairs = [(ts.g_params, g_sd), (ts.d_params, d_sd)]
    if jc.train.ema_decay > 0:
        pairs.append((ts.g_ema, flax_to_state_dict(np_tree(js.g_ema))))
        # After two updates the EMA sits between the init and the parameters.
        assert any(not torch.equal(ts.g_ema[k], ts.g_params[k]) for k in ts.g_ema)
    for mine, theirs in pairs:
        assert mine.keys() == theirs.keys()
        for k in mine:
            np.testing.assert_allclose(mine[k].numpy(), theirs[k].numpy(), atol=2e-5, err_msg=k)


def test_disc_microbatch_equals_the_full_batch():
    """tests/test_train_step.py::test_disc_microbatch_equivalence on the
    port: disc_microbatch=2 against 0, losses within rtol 1e-5 / atol 1e-6,
    the updated parameters within atol 5e-6 / rtol 1e-4."""
    def run(mb):
        jc = tiny_config(rollout_length=4, batch_size=2, disc_microbatch=mb)
        jc = dataclasses.replace(jc, model=dataclasses.replace(jc.model, state_dim=3))
        ts = port_state(jc, jax_init_state(jc, jax.random.PRNGKey(0)))
        return make_train_step(port_config(jc), device="cpu")(ts, np_batch(make_batch(jc)))

    (full, m_full), (chunked, m_chunk) = run(0), run(2)
    for k in ("d_loss", "g_loss", "g_adv", "g_recon"):
        np.testing.assert_allclose(float(m_chunk[k]), float(m_full[k]), rtol=1e-5, atol=1e-6)
    for name in ("g_params", "d_params"):
        for k, v in getattr(full, name).items():
            np.testing.assert_allclose(getattr(chunked, name)[k].numpy(), v.numpy(), atol=5e-6,
                                       rtol=1e-4, err_msg=k)


def test_disc_chunks_round_down_to_a_divisor():
    for n, mb, want in ((8, 2, 4), (6, 4, 2), (960, 240, 4), (8, 0, 1), (8, 8, 1), (8, 9, 1),
                        (7, 3, 7)):
        assert disc_chunks(n, mb) == want, (n, mb)


def test_step_randoms_are_a_function_of_seed_and_step():
    """One generator seeded from SeedSequence([seed, step]): the mask first,
    then u_real, u_fake, u_g; the same (seed, step) draws the same values,
    another step other values."""
    cfg = port_config(tiny_config(scheduled_sampling=True, ss_start_prob=0.5,
                                  d_augment="color,cutout"))
    r = draw_step_randoms(cfg, 7, 3, 4, 5, "cpu")
    gen = torch.Generator().manual_seed(batch_seed(7, 3))
    p = scheduled_sampling_prob(3, cfg.train)
    assert torch.equal(r.use_pred, torch.rand((4, 5), generator=gen) < p)
    for u in (r.u_real, r.u_fake, r.u_g):
        assert torch.equal(u, torch.rand((20, 5), generator=gen))
    again, other = draw_step_randoms(cfg, 7, 3, 4, 5, "cpu"), draw_step_randoms(cfg, 7, 4, 4, 5, "cpu")
    assert torch.equal(again.u_g, r.u_g) and not torch.equal(other.u_g, r.u_g)
    assert draw_step_randoms(port_config(tiny_config()), 7, 3, 4, 5, "cpu") == StepRandoms()


def test_the_step_draws_from_seed_plus_one(monkeypatch):
    """Without ``seed`` the step draws from train.seed + 1, the key the JAX
    loop passes; the loop passes it too."""
    jc = tiny_config(seed=4, d_augment="color")
    cfg = port_config(jc)
    batch = np_batch(make_batch(jc))
    fresh = lambda: port_state(jc, jax_init_state(jc, jax.random.PRNGKey(0)))  # noqa: E731
    _, m_default = make_train_step(cfg, device="cpu")(fresh(), batch)
    _, m_five = make_train_step(cfg, device="cpu", seed=5)(fresh(), batch)
    _, m_six = make_train_step(cfg, device="cpu", seed=6)(fresh(), batch)
    assert float(m_default["d_loss"]) == float(m_five["d_loss"]) != float(m_six["d_loss"])


def test_ema_needs_its_tree():
    cfg = port_config(tiny_config(ema_decay=0.5))
    state = init_state(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert all(torch.equal(state.g_ema[k], v) for k, v in state.g_params.items())
    assert all(state.g_ema[k].data_ptr() != v.data_ptr() for k, v in state.g_params.items())
    state.g_ema = None
    with pytest.raises(ValueError, match="no g_ema"):
        make_train_step(cfg, device="cpu")(state, np_batch(make_batch(tiny_config())))


@pytest.mark.parametrize("engine", ["ad", "fused", "pallas"])
def test_gn_backward_engines_all_run_the_ported_backward(engine):
    """The three JAX gradient engines compute one gradient; the port runs
    one path for all of them, so one step gives identical metrics."""
    jc = tiny_config()
    base = port_config(jc)
    cfg = base.replace(model=dataclasses.replace(base.model, gn_backward=engine))
    js = jax_init_state(jc, jax.random.PRNGKey(0))
    batch = np_batch(make_batch(jc, seed=0))
    _, m = make_train_step(cfg, device="cpu")(port_state(jc, js), batch)
    _, ref = make_train_step(base, device="cpu")(port_state(jc, js), batch)
    assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in ref.items()}


def test_init_state_matches_the_jax_tree_and_counts():
    jc = tiny_config()
    js = jax_init_state(jc, jax.random.PRNGKey(0))
    ts = init_state(port_config(jc), torch.Generator().manual_seed(0), device="cpu")
    assert isinstance(ts, TrainState) and ts.step == 0 and ts.g_opt.count == 0
    g_sd, d_sd = state_dicts(js)
    for mine, theirs in ((ts.g_params, g_sd), (ts.d_params, d_sd)):
        assert {k: tuple(v.shape) for k, v in mine.items()} == {k: tuple(v.shape) for k, v in theirs.items()}
        assert all(v.dtype == torch.float32 and v.device.type == "cpu" for v in mine.values())
    assert all(float(v.abs().max()) == 0 for v in ts.d_opt.nu.values())
    assert S.param_count(ts) == JS.param_count(js)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            init_state(port_config(jc))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_train_step(port_config(jc))


def test_scheduled_sampling_prob_matches_jax():
    for kw in (dict(), dict(scheduled_sampling=True, ss_start_prob=0.1, ss_end_prob=0.9,
                            ss_decay_steps=50)):
        t, jt = tcfg.TrainConfig(**kw), tiny_config(**kw).train
        for step in (0, 10, 49, 50, 500):
            np.testing.assert_allclose(scheduled_sampling_prob(step, t),
                                       float(jax_ss_prob(jnp.asarray(step), jt)), rtol=1e-6)


def test_teacher_forced_fold_equals_the_step_by_step_rollout():
    m = port_config(tiny_config()).model
    gen = Generator(m, generator=torch.Generator().manual_seed(1))
    rng = np.random.default_rng(0)
    frames = torch.from_numpy(np.tanh(rng.standard_normal((2, 4, 16, 16, 3))).astype(np.float32))
    actions = torch.from_numpy(rng.standard_normal((2, 3, 4)).astype(np.float32))
    with torch.no_grad():
        folded = rollout_teacher_forced(lambda p, f, a, s: gen(f, a, s), None, frames, actions, None)
        steps = torch.stack([gen(frames[:, i].contiguous(), actions[:, i]) for i in range(3)], 1)
    assert folded.shape == (2, 3, 16, 16, 3)
    np.testing.assert_allclose(folded.numpy(), steps.numpy(), atol=1e-6)
