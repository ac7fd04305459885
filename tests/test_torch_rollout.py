"""The port's training rollouts (``train/rollout.py``) against the JAX
package's on the CPU, float32, at tiny widths: the teacher-forced fold in
time chunks with and without rematerialisation, the scheduled-sampling
rollout on the masks JAX draws, and the mask's statistics. Predictions
within 1e-5, parameter gradients (through ``jax.vjp`` with the same
cotangent) within 1e-4. Weights cross with ``convert.py``; inputs are numpy
arrays from seeds."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.func import functional_call

from action_conditioned_gans_tpu.config import ModelConfig as JaxModelConfig
from action_conditioned_gans_tpu.models import Generator as JaxGenerator
from action_conditioned_gans_tpu.train import rollout as jroll
from action_conditioned_gans_tpu_torch import config as tcfg
from action_conditioned_gans_tpu_torch.convert import flatten_flax, flax_to_state_dict
from action_conditioned_gans_tpu_torch.models import Generator
from action_conditioned_gans_tpu_torch.train import rollout
from tests.test_torch_generator import jax_params

torch.set_num_threads(1)
MODEL = JaxModelConfig(image_size=16, g_levels=2, g_base_channels=8, group_norm_groups=4,
                       compute_dtype="float32", state_dim=3)
B, T = 3, 4


@pytest.fixture(scope="module")
def setup():
    params = jax_params(MODEL, seed=2)
    rng = np.random.default_rng(5)
    data = dict(frames=np.tanh(rng.standard_normal((B, T + 1, 16, 16, 3))).astype(np.float32),
                actions=rng.standard_normal((B, T, 4)).astype(np.float32),
                states=rng.standard_normal((B, T, 3)).astype(np.float32),
                ct=rng.standard_normal((B, T, 16, 16, 3)).astype(np.float32))
    return params, data


def jax_apply(p, frame, action, state):
    return JaxGenerator(MODEL).apply({"params": p}, frame, action, state)


def port_apply():
    gen = Generator(tcfg.ModelConfig(**dataclasses.asdict(MODEL)))
    return lambda p, frame, action, state: functional_call(gen, p, (frame, action, state))


def compare(jax_fn, port_fn, params, data):
    """jax_fn(params) and port_fn(leaves) -> preds: the predictions and the
    parameter gradients for the data's cotangent."""
    want, vjp = jax.vjp(jax_fn, jax.tree_util.tree_map(jnp.asarray, params))
    (want_grads,) = vjp(jnp.asarray(data["ct"]))
    want_grads = {k.replace("/", "."): v for k, v in flatten_flax(
        jax.tree_util.tree_map(np.asarray, want_grads)).items()}
    leaves = {k: v.requires_grad_() for k, v in flax_to_state_dict(params).items()}
    got = port_fn(leaves)
    grads = torch.autograd.grad(got, list(leaves.values()), torch.from_numpy(data["ct"]))
    assert got.shape == (B, T, 16, 16, 3)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    assert want_grads.keys() == leaves.keys()
    for k, g in zip(leaves, grads):
        np.testing.assert_allclose(g.numpy(), want_grads[k], atol=1e-4, rtol=1e-4, err_msg=k)
    return got


def tensors(data):
    return [torch.from_numpy(data[k]) for k in ("frames", "actions", "states")]


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("time_chunk", [0, 1, 2, 3])  # 3 is no divisor of T=4: chunks of 2
def test_teacher_forced_matches_jax(setup, time_chunk, remat):
    params, data = setup
    jf = lambda p: jroll.rollout_teacher_forced(  # noqa: E731
        jax_apply, p, data["frames"], data["actions"], data["states"], time_chunk, remat)
    apply = port_apply()
    pf = lambda p: rollout.rollout_teacher_forced(  # noqa: E731
        apply, p, *tensors(data), time_chunk=time_chunk, remat=remat)
    compare(jf, pf, params, data)


def jax_masks(key, ss_prob):
    """The (B, T) mask JAX's rollout_generator draws from ``key``: one
    Bernoulli(ss_prob) key per step."""
    keys = jax.random.split(key, T)
    return np.stack([np.asarray(jax.random.bernoulli(k, ss_prob, (B,))) for k in keys], axis=1)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("ss_prob", [0.0, 0.5, 1.0])
def test_scheduled_sampling_rollout_matches_jax(setup, ss_prob, remat):
    params, data = setup
    key = jax.random.PRNGKey(11)
    mask = jax_masks(key, jnp.float32(ss_prob))
    assert mask.all() if ss_prob == 1 else (not mask.any() if ss_prob == 0 else
                                            0 < mask[:, 1:].mean() < 1)
    jf = lambda p: jroll.rollout_generator(  # noqa: E731
        jax_apply, p, data["frames"], data["actions"], data["states"], key,
        jnp.float32(ss_prob), remat)
    apply = port_apply()
    pf = lambda p: rollout.rollout_generator(  # noqa: E731
        apply, p, *tensors(data), torch.from_numpy(mask), remat=remat)
    compare(jf, pf, params, data)


def test_all_false_mask_is_the_teacher_forced_fold_and_all_true_the_rollout(setup):
    params, data = setup
    apply, sd = port_apply(), flax_to_state_dict(params)
    frames, actions, states = tensors(data)
    with torch.no_grad():
        never = rollout.rollout_generator(apply, sd, frames, actions, states,
                                          torch.zeros(B, T, dtype=torch.bool))
        folded = rollout.rollout_teacher_forced(apply, sd, frames, actions, states)
        always = rollout.rollout_generator(apply, sd, frames, actions, states,
                                           torch.ones(B, T, dtype=torch.bool))
        prev, steps = frames[:, 0], []
        for i in range(T):
            steps.append(apply(sd, prev, actions[:, i], states[:, i]))
            prev = steps[-1]
    np.testing.assert_allclose(never.numpy(), folded.numpy(), atol=1e-6)
    np.testing.assert_array_equal(always.numpy(), torch.stack(steps, 1).numpy())


def test_gradient_flows_through_the_carry(setup):
    """With the mask on, step 1's input is step 0's prediction: the loss on
    step 1 reaches the parameters through step 0 too (BPTT), so its
    gradient differs from the one with the carry detached."""
    params, data = setup
    apply = port_apply()
    frames, actions, states = tensors(data)
    mask = torch.ones(B, 2, dtype=torch.bool)

    def grads(detach):
        leaves = {k: v.requires_grad_() for k, v in flax_to_state_dict(params).items()}

        def step(p, f, a, s):
            return apply(p, f.detach() if detach else f, a, s)

        preds = rollout.rollout_generator(step, leaves, frames[:, :3], actions[:, :2],
                                          states[:, :2], mask)
        return torch.autograd.grad(preds[:, 1].square().sum(), list(leaves.values()))

    through, cut = grads(False), grads(True)
    assert max(float((a - b).abs().max()) for a, b in zip(through, cut)) > 1e-4


@pytest.mark.parametrize("remat", [False, True])
def test_remat_runs_each_forward_again_in_the_backward(setup, remat):
    params, data = setup
    apply, calls = port_apply(), []

    def counted(*args):
        calls.append(1)
        return apply(*args)

    leaves = {k: v.requires_grad_() for k, v in flax_to_state_dict(params).items()}
    preds = rollout.rollout_teacher_forced(counted, leaves, *tensors(data), time_chunk=2,
                                           remat=remat)
    assert len(calls) == 2
    torch.autograd.grad(preds.sum(), list(leaves.values()))
    assert len(calls) == (4 if remat else 2)


def test_time_chunk_size_is_the_largest_divisor():
    for t, chunk, want in ((30, 2, 2), (4, 3, 2), (5, 3, 1), (7, 0, 7), (4, 4, 4), (4, 9, 4),
                           (10, 4, 2), (30, 7, 6)):
        assert rollout.time_chunk_size(t, chunk) == want, (t, chunk)


@pytest.mark.parametrize("p", [0.0, 0.3, 0.5, 1.0])
def test_draw_use_pred_mean(p):
    """The mask's mean within 4 standard errors of ss_prob; exactly all
    False at 0 and all True at 1."""
    mask = rollout.draw_use_pred(torch.Generator().manual_seed(0), 200, 50, p)
    assert mask.shape == (200, 50) and mask.dtype == torch.bool
    se = (p * (1 - p) / mask.numel()) ** 0.5
    assert abs(float(mask.float().mean()) - p) <= 4 * se
    again = rollout.draw_use_pred(torch.Generator().manual_seed(0), 200, 50, p)
    assert torch.equal(mask, again)
