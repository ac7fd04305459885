"""The standalone GroupNorm+activation kernel's module (``ops/kernels/norm_act.py``)
and the split route of ``ops/api.py`` against the JAX package, on the CPU.

* the plain version against the JAX Pallas ``group_norm_act`` in interpret
  mode, as tests/test_pallas.py runs it: float32 within 1e-4; bfloat16
  within 1e-2 abs + 1e-2 rel (one bfloat16 step of |out| <= 2, and the
  kernel activates before its cast where the plain version casts first);
* ``csrc/group_norm_act.cu``'s pass decomposition, emulated in torch (the
  CUDA kernel cannot run here), against the plain version, and its (mean,
  rstd) against float64 statistics;
* :class:`GroupNormActFn` against ``jax.vjp`` of the Pallas op: 1e-3;
* the backward's CPU path with a bfloat16 ``y`` against ``ops/gn.py``'s
  ``gn_act_grads`` on the same bfloat16 input;
* a split layer end to end (config1 float32 D ``conv_3``) against the JAX
  ``ops.api.conv_norm_act(backend="pallas")``, forward and gradients;
* the generator and discriminator at the config5 and config3 geometries at
  narrow widths against the JAX models on their XLA path, float32, 1e-3.

Inputs are numpy arrays from seeds fed to both packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from action_conditioned_gans_tpu import config as jcfg
from action_conditioned_gans_tpu.models import Discriminator as JaxDiscriminator
from action_conditioned_gans_tpu.models import Generator as JaxGenerator
from action_conditioned_gans_tpu.ops import api as japi
from action_conditioned_gans_tpu.ops import gn as JG
from action_conditioned_gans_tpu.ops import pallas as P
from action_conditioned_gans_tpu_torch import config as tcfg
from action_conditioned_gans_tpu_torch.convert import flax_to_state_dict
from action_conditioned_gans_tpu_torch.models import Discriminator, Generator
from action_conditioned_gans_tpu_torch.ops import api, common
from action_conditioned_gans_tpu_torch.ops.kernels import gn_bwd
from action_conditioned_gans_tpu_torch.ops.kernels import norm_act as NA

torch.set_num_threads(1)
TOL = dict(atol=1e-3, rtol=1e-3)
F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=1e-2, rtol=1e-2)
ACTS = ["lrelu", "relu", "tanh", "none"]


def rand(seed, *shape, scale=1.0, offset=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + offset).astype(np.float32)


def t(a):
    return None if a is None else torch.from_numpy(np.array(a, np.float32))


def bf16(a):
    """``a`` rounded to bfloat16, as float32 numpy."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def gn_operands(seed, shape):
    c = shape[-1]
    return (rand(seed, *shape, scale=1.5, offset=0.3), rand(seed + 1, c, scale=0.2, offset=1.0),
            rand(seed + 2, c, scale=0.1))


# -- forward ---------------------------------------------------------------------


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("c,groups", [(32, 8), (64, 32), (96, 20)])  # 96/20 -> 16 groups of 6
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax_pallas_kernel(act, c, groups, dtype):
    x, scale, bias = gn_operands(0, (2, 6, 5, c))
    if dtype == "bfloat16":
        x = bf16(x)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    got = NA.group_norm_act(t(x).to(tdt), t(scale), t(bias), groups=groups, act=act)
    assert got.dtype == tdt and NA.LAUNCHES == {"group_norm_act": 0}
    want = P.group_norm_act(jnp.asarray(x).astype(jdt), jnp.asarray(scale), jnp.asarray(bias),
                            groups=groups, act=act)
    want = np.asarray(want.astype(jnp.float32))
    np.testing.assert_allclose(got.float().numpy(), want,
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


TILE_ROWS = 256  # csrc/group_norm_act.cu


def emulate_group_norm_act_kernel(x, scale, bias, groups, eps, act, leak):
    """csrc/group_norm_act.cu pass by pass, in torch: per-tile channel sums
    S1 = sum x and S2 = sum x^2 (float32), the tiles reduced in order, the
    group statistics E[x^2] - mean^2 clamped at 0, then normalise, affine
    and activation in float32 and a cast. Returns (out, stats (2, B, G))."""
    b, h, w, c = x.shape
    hw, cg = h * w, c // groups
    x3 = x.reshape(b, hw, c).float()
    tiles = -(-hw // TILE_ROWS)
    s1 = torch.stack([x3[:, i * TILE_ROWS:(i + 1) * TILE_ROWS].sum(1) for i in range(tiles)], 1)
    s2 = torch.stack([(x3 * x3)[:, i * TILE_ROWS:(i + 1) * TILE_ROWS].sum(1)
                      for i in range(tiles)], 1)
    ch_s, ch_q = s1.sum(1), s2.sum(1)  # (B, C)
    count = hw * cg
    mean = ch_s.reshape(b, groups, cg).sum(2) / count
    var = torch.clamp_min(ch_q.reshape(b, groups, cg).sum(2) / count - mean * mean, 0.0)
    rstd = torch.rsqrt(var + eps)
    v = ((x3 - mean.repeat_interleave(cg, 1)[:, None]) * rstd.repeat_interleave(cg, 1)[:, None]
         * scale + bias)
    out = common.apply_act(v, act, leak).to(x.dtype).reshape(x.shape)
    return out, torch.stack([mean, rstd])


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape,groups", [((2, 20, 17, 40), 32),  # two row tiles, 40/32 -> 20
                                          ((3, 7, 5, 96), 32), ((2, 4, 4, 520), 32),
                                          ((1, 32, 24, 64), 32)])  # three row tiles
def test_kernel_pass_decomposition_matches_plain(act, shape, groups):
    x, scale, bias = gn_operands(10, shape)
    gr = common.resolve_groups(shape[-1], groups)
    got, stats = emulate_group_norm_act_kernel(t(x), t(scale), t(bias), gr, 1e-5, act, 0.2)
    want = NA.group_norm_act_plain(t(x), t(scale), t(bias), groups=groups, act=act)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F32_TOL)
    xg = x.astype(np.float64).reshape(shape[0], -1, gr, shape[-1] // gr)
    np.testing.assert_allclose(stats[0].numpy(), xg.mean(axis=(1, 3)), **F32_TOL)
    np.testing.assert_allclose(stats[1].numpy(), 1 / np.sqrt(xg.var(axis=(1, 3)) + 1e-5),
                               **F32_TOL)


# -- backward --------------------------------------------------------------------


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("c,groups", [(32, 8), (96, 20)])
def test_autograd_function_matches_jax_pallas_vjp(act, c, groups):
    x, scale, bias = gn_operands(20, (2, 6, 5, c))
    ct = rand(23, 2, 6, 5, c)
    tx, ts, tb = (t(a).requires_grad_() for a in (x, scale, bias))
    out = NA.group_norm_act(tx, ts, tb, groups=groups, act=act)
    assert out.grad_fn.name() == "GroupNormActFnBackward"
    got = torch.autograd.grad(out, (tx, ts, tb), t(ct))
    jout, vjp = jax.vjp(lambda a, s, b: P.group_norm_act(a, s, b, groups=groups, act=act),
                        *map(jnp.asarray, (x, scale, bias)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    for a, b, name in zip(got, vjp(jnp.asarray(ct)), ("dx", "dscale", "dbias")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL, err_msg=name)


def test_no_grad_path_keeps_no_residuals():
    x, scale, bias = (t(a) for a in gn_operands(30, (2, 4, 4, 32)))
    with torch.no_grad():
        out = NA.group_norm_act(x, scale.requires_grad_(), bias, groups=8)
    assert out.grad_fn is None
    np.testing.assert_array_equal(out.numpy(), NA.group_norm_act_plain(x, scale, bias, groups=8)
                                  .detach().numpy())


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("saved_stats", [True, False])
def test_gn_act_bwd_with_bf16_y_matches_jax(act, saved_stats):
    """The backward behind the standalone kernel reads y in the compute
    dtype: the CPU path with a bfloat16 y against gn_act_grads on the same
    bfloat16 input, as the JAX VJP calls it."""
    shape, groups = (2, 5, 6, 64), 32
    y, scale, bias = gn_operands(40, shape)
    y = bf16(y)
    out = bf16(NA.group_norm_act_plain(t(y), t(scale), t(bias), groups=groups, act=act).numpy())
    g = bf16(rand(43, *shape))
    yg = y.astype(np.float64).reshape(2, -1, groups, 2)
    mean = yg.mean(axis=(1, 3)).astype(np.float32)
    rstd = (1 / np.sqrt(yg.var(axis=(1, 3)) + 1e-5)).astype(np.float32)
    stats = (mean, rstd) if saved_stats else (None, None)
    to = lambda a: t(a).to(torch.bfloat16)  # noqa: E731
    dx, dscale, dbias = gn_bwd.gn_act_bwd(to(y), t(scale), to(out), to(g), t(stats[0]),
                                          t(stats[1]), groups=groups, act=act)
    assert dx.dtype == torch.bfloat16 and dscale.dtype == torch.float32
    jb = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    want = JG.gn_act_grads(jb(y), jnp.asarray(scale), jb(out), jb(g), groups=groups, eps=1e-5,
                           act=act, leak=0.2,
                           mean=None if stats[0] is None else jnp.asarray(mean),
                           rstd=None if stats[1] is None else jnp.asarray(rstd))
    assert want[0].dtype == jnp.bfloat16
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(want[0].astype(jnp.float32)),
                               **BF16_TOL)
    np.testing.assert_allclose(dscale.numpy(), np.asarray(want[1]), **F32_TOL)
    np.testing.assert_allclose(dbias.numpy(), np.asarray(want[2]), **F32_TOL)


# -- the split route ------------------------------------------------------------------


def test_split_layer_matches_jax_pallas_api():
    """config1's float32 D conv_3, (2, 8, 8, 256) -> (2, 4, 4, 512): off the
    fused envelope in both packages, so the plain conv then the GroupNorm
    kernel's op. Forward and dx, dw, dscale, dbias within 1e-3."""
    x = rand(50, 2, 8, 8, 256)
    w = rand(51, 4, 4, 256, 512, scale=1 / 64)
    scale, bias = rand(52, 512, scale=0.1, offset=1.0), rand(53, 512, scale=0.1)
    ct = rand(54, 2, 4, 4, 512)
    kw = dict(stride=2, kind="group", groups=32, act="lrelu")
    ins = [t(a).requires_grad_() for a in (x, w, scale, bias)]
    api.reset_routes()
    out = api.conv_norm_act(*ins, **kw)
    assert api.ROUTES == {"fused": 0, "split": 1}
    assert out.grad_fn.name() == "GroupNormActFnBackward"
    got = torch.autograd.grad(out, ins, t(ct))
    jout, vjp = jax.vjp(lambda *a: japi.conv_norm_act(*a, backend="pallas", **kw),
                        *map(jnp.asarray, (x, w, scale, bias)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    for a, b, name in zip(got, vjp(jnp.asarray(ct)), ("dx", "dw", "dscale", "dbias")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL, err_msg=name)


def test_split_layer_bf16_matches_jax_pallas_api():
    """config3's bfloat16 D conv_4: the conv output is rounded to bfloat16
    before the norm in both packages."""
    x = bf16(rand(60, 2, 8, 8, 512))
    w = rand(61, 4, 4, 512, 512, scale=1 / 90)
    scale, bias = rand(62, 512, scale=0.1, offset=1.0), rand(63, 512, scale=0.1)
    kw = dict(stride=2, kind="group", groups=32, act="lrelu")
    api.reset_routes()
    with torch.no_grad():
        got = api.conv_norm_act(t(x).to(torch.bfloat16), t(w), t(scale), t(bias), **kw)
    assert api.ROUTES == {"fused": 0, "split": 1} and got.dtype == torch.bfloat16
    want = japi.conv_norm_act(jnp.asarray(x).astype(jnp.bfloat16), *map(jnp.asarray, (w, scale, bias)),
                              backend="pallas", **kw)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               atol=3e-2, rtol=1e-2)


def test_norm_act_off_the_kernel_envelope_takes_the_plain_composite():
    x, scale, bias = (t(a) for a in gn_operands(70, (2, 4, 4, 16)))  # C < 32
    got = api.norm_act(x, scale, bias, groups=4)
    want = japi.norm_act(*map(jnp.asarray, (x.numpy(), scale.numpy(), bias.numpy())), groups=4,
                         backend="pallas")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


# -- model level: the config5 and config3 geometries at narrow widths --------------------

NARROW = {
    # 256x256 frames, 5 G levels, 6 D levels with one extra layer each; at
    # these widths 4 G layers and 3 D layers are off the fused envelope.
    "config5": dict(g_base_channels=32, g_max_channels=64, d_base_channels=32,
                    d_max_channels=64, group_norm_groups=4, compute_dtype="float32"),
    # 128x128 frames, 4 G levels, 5 D levels with one extra layer each.
    "config3": dict(g_base_channels=8, g_max_channels=32, d_base_channels=8, d_max_channels=32,
                    group_norm_groups=4, compute_dtype="float32"),
}
SPLIT_COUNTS = {("config5", "G"): 4, ("config5", "D"): 3, ("config3", "G"): 0, ("config3", "D"): 0}


def narrow_model(preset):
    return dataclasses.replace(jcfg.get_preset(preset).model, **NARROW[preset])


@pytest.mark.parametrize("preset", sorted(NARROW))
def test_generator_at_preset_geometry_matches_jax(preset):
    m = narrow_model(preset)
    s = m.image_size
    frame, action = np.tanh(rand(80, 1, s, s, 3)), rand(81, 1, 4)
    params = jax.jit(JaxGenerator(m).init)(jax.random.PRNGKey(0), frame, action)["params"]
    want = np.asarray(jax.jit(JaxGenerator(m).apply)({"params": params}, frame, action))
    gen = Generator(tcfg.ModelConfig(**dataclasses.asdict(m)))
    gen.load_state_dict(flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params)))
    api.reset_routes()
    with torch.no_grad():
        got = gen(torch.from_numpy(frame), torch.from_numpy(action))
    assert api.ROUTES["split"] == SPLIT_COUNTS[(preset, "G")]
    assert got.shape == (1, s, s, 3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("preset", sorted(NARROW))
def test_discriminator_at_preset_geometry_matches_jax(preset):
    """Logits, and the gradient of their sum with respect to the next frame
    and every parameter (the split layers through GroupNormActFn)."""
    m = narrow_model(preset)
    assert m.d_extra_layers == 1
    s = m.image_size
    nxt, frame = np.tanh(rand(90, 1, s, s, 3)), np.tanh(rand(91, 1, s, s, 3))
    action = rand(92, 1, 4)
    params = jax.tree_util.tree_map(np.asarray, jax.jit(JaxDiscriminator(m).init)(
        jax.random.PRNGKey(1), nxt, frame, action)["params"])

    def jloss(p, x):
        return JaxDiscriminator(m).apply({"params": p}, x, frame, action).sum()

    want, (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(params, nxt)
    d = Discriminator(tcfg.ModelConfig(**dataclasses.asdict(m)))
    d.load_state_dict(flax_to_state_dict(params))
    x = torch.from_numpy(nxt).requires_grad_()
    api.reset_routes()
    logit = d(x, torch.from_numpy(frame), torch.from_numpy(action)).sum()
    assert api.ROUTES["split"] == SPLIT_COUNTS[(preset, "D")]
    logit.backward()
    np.testing.assert_allclose(float(logit.detach()), float(want), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jgx), **TOL)
    gp = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, jgp))
    for name, p in d.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), gp[name].numpy(), **TOL, err_msg=name)
