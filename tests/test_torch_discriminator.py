"""The port's Discriminator, spectral normalization and converter against the
JAX package's, on the CPU.

Weights are JAX ``init`` params carried across by ``convert.py``; inputs are
numpy arrays from seeds fed to both. float32, tolerance 1e-3 (the bar of
tests/test_pallas.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from action_conditioned_gans_tpu import config as jcfg
from action_conditioned_gans_tpu.models import Discriminator as JaxDiscriminator
from action_conditioned_gans_tpu.models.common import spectral_normalize as jax_spectral_normalize
from action_conditioned_gans_tpu_torch import config as tcfg
from action_conditioned_gans_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from action_conditioned_gans_tpu_torch.models import Discriminator
from action_conditioned_gans_tpu_torch.models.common import spectral_normalize

torch.set_num_threads(1)
TOL = dict(atol=1e-3, rtol=1e-3)
TINY = dict(image_size=16, d_levels=2, d_base_channels=8, group_norm_groups=4,
            compute_dtype="float32")


def rand(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def inputs(m, b, seed=0):
    s = m.image_size
    nxt, frame = np.tanh(rand(seed, b, s, s, 3)), np.tanh(rand(seed + 1, b, s, s, 3))
    action = rand(seed + 2, b, m.action_dim)
    state = rand(seed + 3, b, m.state_dim) if m.state_dim else None
    return nxt, frame, action, state


def jax_params(m, seed=0):
    nxt, frame, action, state = inputs(m, 1)
    params = JaxDiscriminator(m).init(jax.random.PRNGKey(seed), nxt, frame, action, state)["params"]
    return jax.tree_util.tree_map(np.asarray, jax.device_get(params))


def port_discriminator(m, params):
    d = Discriminator(tcfg.ModelConfig(**dataclasses.asdict(m)))
    d.load_state_dict(flax_to_state_dict(params))
    return d


def run_both(m, params, b=2, seed=5):
    nxt, frame, action, state = inputs(m, b, seed)
    want = np.asarray(JaxDiscriminator(m).apply({"params": params}, nxt, frame, action, state))
    args = [None if a is None else torch.from_numpy(a) for a in (nxt, frame, action, state)]
    with torch.no_grad():
        got = port_discriminator(m, params)(*args)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b,)
    return got.numpy(), want


@pytest.mark.parametrize(
    "extra",
    [dict(), dict(d_extra_layers=1), dict(state_dim=3), dict(d_condition_frame=False),
     dict(d_condition_action=False), dict(d_spectral_norm=True, sn_iters=3)],
    ids=["plain", "extra_layers", "state", "no_frame", "no_action", "spectral_norm"],
)
def test_discriminator_matches_jax_pallas_path_tiny(extra):
    m = jcfg.ModelConfig(backend="pallas", **TINY, **extra)
    got, want = run_both(m, jax_params(m))
    np.testing.assert_allclose(got, want, **TOL)


def test_discriminator_matches_jax_xla_path_config1_full_width():
    m = dataclasses.replace(jcfg.get_preset("config1").model, compute_dtype="float32")
    params = jax_params(m, seed=1)
    assert params["logit_kernel"].shape == (4 * 4 * 512, 1)
    got, want = run_both(m, params)
    np.testing.assert_allclose(got, want, **TOL)


def test_discriminator_gradients_match_jax_tiny():
    """d(sum of logits) w.r.t. the next frame and every parameter, through
    the conv blocks' autograd Functions, against jax.grad."""
    m = jcfg.ModelConfig(**TINY, d_extra_layers=1)
    params = jax_params(m, seed=2)
    nxt, frame, action, _ = inputs(m, 2, seed=7)

    def jloss(p, x):
        return JaxDiscriminator(m).apply({"params": p}, x, frame, action).sum()

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(params, nxt)
    d = port_discriminator(m, params)
    x = torch.from_numpy(nxt).requires_grad_()
    d(x, torch.from_numpy(frame), torch.from_numpy(action)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgx), **TOL)
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jgp))
    for name, p in d.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), **TOL, err_msg=name)


def test_discriminator_param_shapes_and_init_follow_flax():
    m = jcfg.ModelConfig(**TINY, d_extra_layers=1)
    want = flax_to_state_dict(jax_params(m))
    d = Discriminator(tcfg.ModelConfig(**dataclasses.asdict(m)), generator=torch.Generator().manual_seed(0))
    sd = d.state_dict()
    assert {k: tuple(v.shape) for k, v in sd.items()} == {k: tuple(v.shape) for k, v in want.items()}
    assert torch.equal(sd["conv_1.scale"], torch.ones(16)) and "conv_0.scale" not in sd
    assert torch.equal(sd["logit_bias"], torch.zeros(1))
    assert float(sd["logit_kernel"].abs().max()) <= 0.04


@pytest.mark.parametrize("shape,iters", [((48, 32), 9), ((4, 4, 6, 8), 3), ((256, 1), 9)])
def test_spectral_normalize_matches_jax(shape, iters):
    w = rand(10, *shape)
    got = spectral_normalize(torch.from_numpy(w), iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_spectral_normalize(jnp.asarray(w), iters)),
                               atol=1e-5, rtol=1e-5)


def test_spectral_normalize_gradient_matches_jax():
    """u and v are held fixed: the gradient is the u v^T form, as in JAX."""
    w, ct = rand(11, 4, 4, 3, 5), rand(12, 4, 4, 3, 5)
    jg = jax.grad(lambda a: jnp.sum(jax_spectral_normalize(a, 5) * ct))(jnp.asarray(w))
    tw = torch.from_numpy(w).requires_grad_()
    (spectral_normalize(tw, 5) * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(jg), atol=1e-5, rtol=1e-4)


def test_converter_round_trip_carries_the_discriminator_and_train_params():
    m = jcfg.ModelConfig(**TINY, d_extra_layers=1)
    d_params = jax_params(m)
    g_params = {"enc_0": {"kernel": rand(13, 4, 4, 3, 8), "bias": rand(14, 8)}}
    g_sd, d_sd = flax_to_state_dict(g_params), flax_to_state_dict(d_params)
    assert "logit_kernel" in d_sd and "conv_0_extra_0.scale" in d_sd and "enc_0.kernel" in g_sd
    g_back, d_back = state_dict_to_flax(g_sd), state_dict_to_flax(d_sd)
    assert d_back.keys() == d_params.keys()
    for tree, back in ((g_params, g_back), (d_params, d_back)):
        flat = jax.tree_util.tree_leaves_with_path(tree)
        assert len(flat) == len(jax.tree_util.tree_leaves(back))
        for path, leaf in flat:
            node = back
            for p in path:
                node = node[p.key]
            assert node.dtype == np.float32
            np.testing.assert_array_equal(node, leaf)
