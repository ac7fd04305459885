"""The port's D-input augmentation (``train/augment.py``) against the JAX
package's ``train/augment.py`` on the CPU: each op, and the whole policy,
applied with the parameters JAX draws, within 1e-6, and its gradient (the
DiffAugment contract: D's gradient reaches the generator through the
transform) within 1e-5 of ``jax.vjp``. Inputs are numpy arrays from seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from action_conditioned_gans_tpu.train import augment as jaug
from action_conditioned_gans_tpu_torch.train import augment

torch.set_num_threads(1)
POLICIES = ["color", "translation", "cutout", "color,translation,cutout", "cutout,color"]


def inputs(seed, shape=(5, 12, 9, 3)):
    rng = np.random.default_rng(seed)
    x = np.tanh(rng.standard_normal(shape)).astype(np.float32)
    pair = np.tanh(rng.standard_normal(shape)).astype(np.float32)
    ct = rng.standard_normal(shape).astype(np.float32)
    return x, pair, ct


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_matches_jax_on_jax_draws(policy):
    ops = augment.parse_policy(policy)
    assert ops == jaug.parse_policy(policy)
    assert augment.n_params(ops) == jaug.n_params(ops)
    x, pair, ct = inputs(0)
    u = np.array(jaug.draw_params(jax.random.PRNGKey(7), ops, x.shape[0]))
    want_x, want_p = jaug.apply(ops, jnp.asarray(u), jnp.asarray(x), jnp.asarray(pair))
    got_x, got_p = augment.apply(ops, torch.from_numpy(u), torch.from_numpy(x), torch.from_numpy(pair))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-6, rtol=0)
    # Without a pair, the images get the same transform.
    alone, none = augment.apply(ops, torch.from_numpy(u), torch.from_numpy(x))
    assert none is None and torch.equal(alone, got_x)


@pytest.mark.parametrize("policy", POLICIES)
def test_gradient_matches_jax_vjp(policy):
    ops = augment.parse_policy(policy)
    x, pair, ct = inputs(1)
    u = np.array(jaug.draw_params(jax.random.PRNGKey(3), ops, x.shape[0]))
    _, vjp = jax.vjp(lambda a, b: jaug.apply(ops, jnp.asarray(u), a, b), jnp.asarray(x),
                     jnp.asarray(pair))
    want_dx, want_dp = vjp((jnp.asarray(ct), jnp.asarray(2 * ct)))
    tx = torch.from_numpy(x).requires_grad_()
    tp = torch.from_numpy(pair).requires_grad_()
    ox, op = augment.apply(ops, torch.from_numpy(u), tx, tp)
    dx, dp = torch.autograd.grad([ox, op], [tx, tp], [torch.from_numpy(ct), torch.from_numpy(2 * ct)])
    np.testing.assert_allclose(dx.numpy(), np.asarray(want_dx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(dp.numpy(), np.asarray(want_dp), atol=1e-5, rtol=0)


def test_bf16_images_round_trip_in_float32():
    """bfloat16 predictions (G's output) are augmented in float32 and cast
    back, as JAX does."""
    ops = augment.parse_policy("color,translation,cutout")
    x, pair, _ = inputs(2, (3, 16, 16, 3))
    u = np.array(jaug.draw_params(jax.random.PRNGKey(1), ops, 3))
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want, _ = jaug.apply(ops, jnp.asarray(u), xb, jnp.asarray(pair))
    got, gp = augment.apply(ops, torch.from_numpy(u), torch.from_numpy(x).to(torch.bfloat16),
                            torch.from_numpy(pair))
    assert got.dtype == torch.bfloat16 and gp.dtype == torch.float32
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_translation_and_cutout_cover_their_ranges():
    """u at the ends of [0, 1): shifts of -s and +s (zero fill on the side it
    came from), cutout boxes at both corners."""
    x = torch.arange(1, 2 * 16 * 16 + 1, dtype=torch.float32).reshape(2, 16, 16, 1)
    u = torch.tensor([[0.0, 0.0], [0.9999, 0.9999]])
    got = augment._translation(x, u)
    s = 2  # ceil(16 / 8)
    assert torch.equal(got[0, s:, s:], x[0, :-s, :-s]) and float(got[0, :s].abs().max()) == 0
    assert torch.equal(got[1, :-s, :-s], x[1, s:, s:]) and float(got[1, -s:].abs().max()) == 0
    cut = augment._cutout(x, u)
    assert float(cut[0, :8, :8].abs().max()) == 0 and torch.equal(cut[0, 8:], x[0, 8:])
    assert float(cut[1, 8:, 8:].abs().max()) == 0 and torch.equal(cut[1, :8], x[1, :8])


def test_draws_and_the_empty_policy():
    ops = augment.parse_policy(" color , cutout ")
    assert ops == ("color", "cutout") and augment.n_params(ops) == 5
    u = augment.draw_params(torch.Generator().manual_seed(0), ops, 1000)
    assert u.shape == (1000, 5) and u.dtype == torch.float32
    assert float(u.min()) >= 0 and float(u.max()) < 1 and abs(float(u.mean()) - 0.5) < 0.02
    again = augment.draw_params(torch.Generator().manual_seed(0), ops, 1000)
    assert torch.equal(u, again)
    assert augment.parse_policy("") == () and augment.draw_params(None, (), 4) is None
    x = torch.zeros(2, 4, 4, 3)
    assert augment.apply((), None, x, None) == (x, None)


def test_an_unknown_op_raises():
    with pytest.raises(ValueError, match="unknown d_augment op 'flip'"):
        augment.parse_policy("color,flip")
