"""``Predictor.from_checkpoint`` and the npz export against the JAX package,
on the CPU.

A JAX ``TrainState`` of a tiny config is carried into a port TrainState by
``convert.train_state_from_jax`` and saved with the port's
``CheckpointManager``, as ``train`` saves it; ``from_checkpoint`` then
predicts and rolls out what the JAX ``Predictor`` does on the same params,
within 1e-3 in float32. The EMA rules are the JAX package's
(tests/test_infer.py): a plain checkpoint under an EMA config, an EMA
checkpoint under a plain one, ``use_ema`` without EMA weights, and the real
restore error surfacing.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from action_conditioned_gans_tpu import config as jcfg
from action_conditioned_gans_tpu.infer import Predictor as JaxPredictor
from action_conditioned_gans_tpu.train import init_state as jax_init_state
from action_conditioned_gans_tpu_torch import config as tcfg
from action_conditioned_gans_tpu_torch.convert import train_state_from_jax
from action_conditioned_gans_tpu_torch.infer import Predictor, export_generator
from action_conditioned_gans_tpu_torch.train.state import state_to_host
from action_conditioned_gans_tpu_torch.utils.checkpoint import CheckpointManager

torch.set_num_threads(1)
TOL = dict(atol=1e-3, rtol=1e-3)
TINY = dict(image_size=16, g_levels=2, g_base_channels=8, d_levels=2, d_base_channels=8,
            group_norm_groups=4, compute_dtype="float32")


def configs(workdir, ema_decay=0.0, **model):
    """(JAX Config, port Config) of one tiny configuration."""
    j = jcfg.Config(name="tiny-infer", model=jcfg.ModelConfig(**{**TINY, **model}),
                    data=jcfg.DataConfig(seq_len=2),
                    train=jcfg.TrainConfig(batch_size=2, ema_decay=ema_decay),
                    workdir=str(workdir))
    return j, tcfg.config_from_dict(dataclasses.asdict(j))


def save_jax_state(workdir, ema_decay=0.0, step=5, shift_ema=0.01, **model):
    """A JAX TrainState carried into the port and saved at ``step`` under
    ``workdir``; with EMA, g_ema is the parameters plus ``shift_ema``.
    Returns (the JAX state with numpy leaves, JAX Config, port Config)."""
    jc, tc = configs(workdir, ema_decay, **model)
    state = jax_init_state(jc, jax.random.PRNGKey(0))
    if ema_decay > 0:
        state = state.replace(g_ema=jax.tree_util.tree_map(lambda x: x + shift_ema, state.g_params))
    state = jax.tree_util.tree_map(np.asarray, jax.device_get(state))
    port = train_state_from_jax(tc, state, device="cpu")
    CheckpointManager(f"{workdir}/checkpoints").save(step, state_to_host(port, tc))
    return state, jc, tc


def inputs(seed, state_dim, batch=2, horizon=3):
    rng = np.random.default_rng(seed)
    frame = np.tanh(rng.standard_normal((batch, 16, 16, 3))).astype(np.float32)
    action = rng.standard_normal((batch, 4)).astype(np.float32)
    actions = rng.standard_normal((batch, horizon, 4)).astype(np.float32)
    state = states = None
    if state_dim:
        state = rng.standard_normal((batch, state_dim)).astype(np.float32)
        states = rng.standard_normal((batch, horizon, state_dim)).astype(np.float32)
    return (frame, action, state), (frame, actions, states)


def assert_like_jax(port, jax_cfg, params, state_dim=0, seed=1):
    jp = JaxPredictor(jax_cfg, params)
    p_args, r_args = inputs(seed, state_dim)
    np.testing.assert_allclose(port.predict(*p_args).numpy(), np.asarray(jp.predict(*p_args)),
                               **TOL)
    np.testing.assert_allclose(port.rollout(*r_args).numpy(), np.asarray(jp.rollout(*r_args)),
                               **TOL)


@pytest.mark.parametrize("state_dim", [0, 3])
def test_from_checkpoint_matches_jax_predictor(tmp_path, state_dim):
    state, jc, tc = save_jax_state(tmp_path, state_dim=state_dim)
    port = Predictor.from_checkpoint(tc, device="cpu")
    assert port.device.type == "cpu"
    assert_like_jax(port, jc, state.g_params, state_dim)


def test_from_checkpoint_takes_a_step_and_a_workdir(tmp_path):
    state, jc, tc = save_jax_state(tmp_path / "w", step=5)
    other = dataclasses.replace(tc, workdir=str(tmp_path / "elsewhere"))
    port = Predictor.from_checkpoint(other, workdir=str(tmp_path / "w"), step=5, device="cpu")
    assert_like_jax(port, jc, state.g_params)
    with pytest.raises(FileNotFoundError):
        Predictor.from_checkpoint(tc, step=6, device="cpu")


def test_from_checkpoint_use_ema(tmp_path):
    """use_ema=True serves g_ema (as the JAX Predictor on g_ema); a
    checkpoint without EMA weights raises."""
    state, jc, tc = save_jax_state(tmp_path, ema_decay=0.5)
    raw = Predictor.from_checkpoint(tc, device="cpu")
    ema = Predictor.from_checkpoint(tc, use_ema=True, device="cpu")
    assert_like_jax(ema, jc, state.g_ema)
    assert_like_jax(raw, jc, state.g_params)
    args = inputs(2, 0)[0]
    assert float((raw.predict(*args) - ema.predict(*args)).abs().max()) > 0

    _, _, tc_off = save_jax_state(tmp_path / "off")
    with pytest.raises(ValueError, match="no EMA weights"):
        Predictor.from_checkpoint(tc_off, use_ema=True, device="cpu")


def test_from_checkpoint_use_ema_without_decay_in_config(tmp_path):
    state, jc, tc = save_jax_state(tmp_path, ema_decay=0.9)
    plain = dataclasses.replace(tc, train=dataclasses.replace(tc.train, ema_decay=0.0))
    ema = Predictor.from_checkpoint(plain, use_ema=True, device="cpu")
    raw = Predictor.from_checkpoint(plain, device="cpu")
    assert_like_jax(ema, jc, state.g_ema)
    args = inputs(3, 0)[0]
    assert float((raw.predict(*args) - ema.predict(*args)).abs().max()) > 0


def test_plain_checkpoint_under_an_ema_config(tmp_path):
    """use_ema=False under an EMA config loads a checkpoint trained without
    EMA; use_ema=True there raises instead of serving the raw weights as
    EMA (the EMA tree is read from disk, never seeded from the parameters)."""
    state, jc, tc = save_jax_state(tmp_path)
    ema_cfg = dataclasses.replace(tc, train=dataclasses.replace(tc.train, ema_decay=0.999))
    assert_like_jax(Predictor.from_checkpoint(ema_cfg, device="cpu"), jc, state.g_params)
    with pytest.raises(ValueError, match="no EMA weights"):
        Predictor.from_checkpoint(ema_cfg, use_ema=True, device="cpu")


def test_use_ema_surfaces_the_real_restore_error(tmp_path):
    """A checkpoint of another geometry: the first attempt's own error, not
    "no EMA weights" (with use_ema, the first template holds g_ema, which
    this plain checkpoint lacks; without, the first error is a shape)."""
    save_jax_state(tmp_path, g_base_channels=16)
    _, tc = configs(tmp_path)
    with pytest.raises(ValueError, match="key g_ema is missing") as e:
        Predictor.from_checkpoint(tc, use_ema=True, device="cpu")
    assert "no EMA weights" not in str(e.value)
    with pytest.raises(ValueError, match="has shape"):
        Predictor.from_checkpoint(tc, device="cpu")


def test_from_checkpoint_needs_a_device_without_cuda(tmp_path):
    _, _, tc = save_jax_state(tmp_path)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Predictor.from_checkpoint(tc)


def test_export_then_from_npz_round_trips_bit_for_bit(tmp_path):
    """The port's export of a checkpoint's g_params, read back by the port's
    from_npz (equal bits) and by the JAX package's (within 1e-3)."""
    state, jc, tc = save_jax_state(tmp_path, state_dim=3)
    restored = Predictor.from_checkpoint(tc, device="cpu")
    path = str(tmp_path / "g.npz")
    export_generator(tc, restored.generator.state_dict(), path)
    back = Predictor.from_npz(path, device="cpu")
    p_args, r_args = inputs(4, 3)
    assert torch.equal(back.predict(*p_args), restored.predict(*p_args))
    assert torch.equal(back.rollout(*r_args), restored.rollout(*r_args))
    jax_back = JaxPredictor.from_npz(path)
    np.testing.assert_allclose(restored.predict(*p_args).numpy(),
                               np.asarray(jax_back.predict(*p_args)), **TOL)
    assert_like_jax(back, jc, state.g_params, state_dim=3)
