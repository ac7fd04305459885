"""ROADMAP Queue 3 fault 1: a GroupNorm off kernel 3's envelope takes the
plain composite on every device (``ops/api.py``, counted in
``ROUTES["group_plain"]``), as the JAX package's ``norm_act`` takes its XLA
composite there.

Pinned on meta tensors: the 512x512 config5 model with g_levels=6 and
d_levels=7 (chip_smoke.py's FAULT1_OVERRIDES) sends exactly six GroupNorms
to that route over G and D at B=2, (2, 128, 128, 128) x4 and
(2, 256, 256, 64) x2; its generator call and its training step take the
counts chip_smoke.FAULT1_GROUP_PLAIN holds the card to; no preset takes the
route. On the CPU the route's values are the JAX package's composite's.

Also on meta tensors: a split layer's conv runs kernel 1 or 2 bare
(``ROUTES["bare"]``) exactly where the JAX package's Pallas ``conv2d``
would, which with GroupNorm is never and with batch norm wherever the
conv fits.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_envelope import jax_route, preset_layers
from test_torch_train_paths import step_calls

import chip_smoke
from action_conditioned_gans_tpu.ops import api as japi
from action_conditioned_gans_tpu.ops import pallas as P
from action_conditioned_gans_tpu_torch import config as tcfg
from action_conditioned_gans_tpu_torch.cli import apply_overrides
from action_conditioned_gans_tpu_torch.models import Discriminator, Generator
from action_conditioned_gans_tpu_torch.ops import api, envelope, reference
from action_conditioned_gans_tpu_torch.ops.kernels import norm_act

torch.set_num_threads(1)
META = torch.device("meta")


def fault1_config(dtype):
    return apply_overrides(tcfg.get_preset("config5"),
                           chip_smoke.FAULT1_OVERRIDES + [f"model.compute_dtype={dtype}"])


class _Recording:
    """``ops/reference.py`` as ``ops/api.py`` sees it, with the GroupNorms
    that reach the plain composite from ``api.norm_act`` recorded."""

    def __init__(self):
        self.plain, self.kernel3 = collections.Counter(), collections.Counter()

    def __getattr__(self, name):
        return getattr(reference, name)

    def norm_act(self, x, *args, **kw):
        if kw.get("kind", "group") == "group":
            self.plain[tuple(x.shape)] += 1
        return reference.norm_act(x, *args, **kw)


def recorded(run):
    """(ROUTES after ``run()``, GroupNorm shapes on the plain route, shapes
    on kernel 3)."""
    rec, real_k3 = _Recording(), norm_act.group_norm_act

    def k3(x, *args, **kw):
        rec.kernel3[tuple(x.shape)] += 1
        return real_k3(x, *args, **kw)

    api.reference, norm_act.group_norm_act = rec, k3
    api.reset_routes()
    try:
        run()
    finally:
        api.reference, norm_act.group_norm_act = reference, real_k3
    return dict(api.ROUTES), rec.plain, rec.kernel3


def models_run(model_cfg, batch, which="GD"):
    with META:
        gen, disc = Generator(model_cfg), Discriminator(model_cfg)
    s = model_cfg.image_size
    frame = torch.empty(batch, s, s, model_cfg.image_channels, device=META)
    action = torch.empty(batch, model_cfg.action_dim, device=META)
    state = torch.empty(batch, model_cfg.state_dim, device=META) if model_cfg.state_dim else None

    def run():
        with torch.no_grad():
            if "G" in which:
                gen(frame, action, state)
            if "D" in which:
                disc(frame, frame, action, state)
    return run


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_the_512_model_sends_six_groupnorms_to_the_plain_route(dtype):
    routes, plain, kernel3 = recorded(models_run(fault1_config(dtype).model, 2))
    assert routes["group_plain"] == 6
    assert plain == {(2, 128, 128, 128): 4, (2, 256, 256, 64): 2}
    assert not any(envelope.group_norm_act_supported(s) for s in plain)
    assert kernel3 and all(envelope.group_norm_act_supported(s) for s in kernel3)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_fault1_counts_of_chip_smoke(dtype):
    """FAULT1_GROUP_PLAIN: a generator call, and a training step (T=2, B=2,
    remat: G's forward runs again in the backward; D at 8 in its update and
    4 in the G head)."""
    cfg = fault1_config(dtype)
    routes, _, _ = recorded(models_run(cfg.model, 2, which="G"))
    _, step_routes = step_calls(cfg)
    assert (routes["group_plain"], step_routes["group_plain"]) == chip_smoke.FAULT1_GROUP_PLAIN


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("preset", sorted(tcfg.PRESETS))
def test_no_preset_takes_the_plain_group_route(preset, dtype):
    m = dataclasses.replace(tcfg.get_preset(preset).model, compute_dtype=dtype)
    routes, plain, _ = recorded(models_run(m, 2))
    assert routes["group_plain"] == 0 and not plain


@pytest.mark.parametrize("norm", ["group", "batch"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("preset", sorted(tcfg.PRESETS))
def test_bare_convs_follow_the_reference_pallas_conv(preset, dtype, norm):
    """A split layer's conv runs kernel 1 or 2 bare exactly where the JAX
    package's Pallas ``conv2d`` / ``conv2d_transpose`` would
    (``conv_*_supported(x, w, stride, "none", 1)``), counted in
    ROUTES["bare"] on meta tensors at B=2: a batch-norm layer's conv where
    it fits, never a GroupNorm preset's (its split layers do not fit)."""
    api.reset_routes()
    layers = preset_layers(preset, dtype, 2, norm=norm)
    want = 0
    for _, block, x_shape, out_shape in layers:
        route, _ = jax_route(block, x_shape, out_shape, dtype)
        x = jax.ShapeDtypeStruct(x_shape, jnp.dtype(dtype))
        w = jax.ShapeDtypeStruct(tuple(block.kernel.shape), jnp.float32)
        fits = (P.conv_transpose_norm_act_supported if block.transpose
                else P.conv_norm_act_supported)
        want += route == "split" and fits(x, w, block.stride, "none", 1)
    assert api.ROUTES["bare"] == want
    assert api.ROUTES["fused"] + api.ROUTES["split"] == len(layers)
    if norm == "group":
        assert want == 0
    elif (preset, dtype) != ("config5", "float32"):
        assert want > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,groups", [((2, 5, 6, 16), 4), ((1, 4, 4, 24), 32)])
def test_plain_group_route_matches_jax_norm_act(shape, groups, dtype):
    """Fewer than 32 channels: off the envelope in both packages; the port's
    route against the JAX package's XLA composite (float32 statistics, the
    affine, the cast, then the activation), float32 within 1e-5, bfloat16
    within one bfloat16 step."""
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    scale = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    bias = (0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    assert not envelope.group_norm_act_supported(shape)
    for act in ("lrelu", "relu", "tanh", "none"):
        kw = dict(kind="group", groups=groups, act=act)
        api.reset_routes()
        got = api.norm_act(torch.from_numpy(x).to(tdt), torch.from_numpy(scale),
                           torch.from_numpy(bias), **kw)
        assert api.ROUTES == {**dict.fromkeys(api.ROUTES, 0), "group_plain": 1}
        want = japi.norm_act(jnp.asarray(x).astype(jdt), jnp.asarray(scale), jnp.asarray(bias),
                             backend="pallas", **kw)
        assert got.dtype == tdt
        tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=2 ** -7, rtol=2 ** -7)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                                   err_msg=act, **tol)
