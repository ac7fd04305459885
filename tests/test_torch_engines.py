"""The engine knobs (``wgrad="patches"``, ``deconv="subpixel"``,
``conv0="s2d"``) of the port against the JAX package's, on the CPU.

* The two rewrites (``reference.conv2d_transpose_subpixel``,
  ``reference.conv2d_s2d``) and the patches weight gradient
  (``ops/wgrad.py``) against ``ops/xla.py`` / ``ops/wgrad.py`` of the JAX
  package: forward and gradients at the tolerances of tests/test_deconv.py,
  tests/test_conv0.py and tests/test_wgrad.py; the fallback off the
  envelope; a second backward through the patches Function (gradgradcheck).
* The fused blocks' autograd Function with ``wgrad="patches"`` against
  ``jax.vjp`` of the JAX package's Pallas op (interpret mode).
* ``ops/api.py``: each engine runs where the reference's XLA backend runs it
  (the split route's plain conv), counted in ``ROUTES``.
* ``bench``: the analytic count is the same under every engine, and the
  ``bench`` subcommand runs with each knob.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_grad import CONV_GRAD_CASES, jax_block, rand, t

from action_conditioned_gans_tpu.ops import xla as X
from action_conditioned_gans_tpu.ops.wgrad import (
    conv2d_patches_wgrad as jax_patches,
    conv2d_transpose_patches_wgrad as jax_transpose_patches,
)
from action_conditioned_gans_tpu_torch import cli
from action_conditioned_gans_tpu_torch.bench import counted_step_flops, step_flop_counts
from action_conditioned_gans_tpu_torch.ops import api, envelope, reference, wgrad
from action_conditioned_gans_tpu_torch.ops.kernels import conv as K
from tests.test_torch_train import port_config
from tests.test_train_step import tiny_config

torch.set_num_threads(1)


def inputs(dtype, b, h, w, cin, cout, k=4, seed=0):
    """x (B, H, W, Cin) in ``dtype`` and w (k, k, Cin, Cout) float32 * 0.1,
    numpy and torch, as the reference's tests draw them."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, h, w, cin).astype(np.float32)
    wk = (rng.randn(k, k, cin, cout) * 0.1).astype(np.float32)
    if dtype == "bfloat16":
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    return x, wk


def value_and_grads(fn, x, wk, dtype, loss=np.sin):
    """(y, dx, dw) in float32 of torch ``fn`` under sum(loss(y))."""
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_()
    tw = torch.from_numpy(wk).requires_grad_()
    y = fn(tx, tw)
    f = torch.sin if loss is np.sin else torch.square
    dx, dw = torch.autograd.grad(f(y.float()).sum(), (tx, tw))
    assert dx.dtype == tx.dtype and dw.dtype == torch.float32
    return y.detach().float().numpy(), dx.float().numpy(), dw.numpy()


def jax_value_and_grads(fn, x, wk, dtype, loss=jnp.sin):
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    y = fn(jx, jnp.asarray(wk))
    dx, dw = jax.grad(lambda a, b: jnp.sum(loss(fn(a, b).astype(jnp.float32))), argnums=(0, 1))(
        jx, jnp.asarray(wk))
    return [np.asarray(jnp.asarray(a).astype(jnp.float32)) for a in (y, dx, dw)]


def assert_close(got, want, dtype):
    """The reference's bars: float32 2e-5 (dw's atol scaled to its largest
    magnitude); bfloat16 2% of each quantity's largest magnitude."""
    for name, a, b in zip(("y", "dx", "dw"), got, want):
        if dtype == "float32":
            atol = 2e-5 * max(float(np.abs(b).max()), 1.0) if name == "dw" else 2e-5
            np.testing.assert_allclose(a, b, rtol=2e-5, atol=atol, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, atol=0.02 * float(np.abs(b).max()), rtol=0.02,
                                       err_msg=name)


# -- the rewrites ----------------------------------------------------------------

SUBPIXEL_SHAPES = [(2, 8, 8, 7, 3), (1, 4, 6, 64, 3), (2, 5, 9, 10, 12), (3, 16, 16, 32, 64)]
S2D_SHAPES = [(2, 8, 8, 3, 16), (1, 4, 6, 10, 32), (2, 16, 16, 7, 64), (3, 8, 8, 32, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,cin,cout", SUBPIXEL_SHAPES)
def test_subpixel_matches_jax_rewrite_and_plain_conv_transpose(b, h, w, cin, cout, dtype):
    """tests/test_deconv.py's shapes and bars: the port's rewrite against the
    JAX package's, and against the plain conv-transpose it rewrites."""
    x, wk = inputs(dtype, b, h, w, cin, cout)
    got = value_and_grads(lambda a, k: reference.conv2d_transpose_subpixel(a, k), x, wk, dtype)
    assert got[0].shape == (b, 2 * h, 2 * w, cout)
    assert_close(got, jax_value_and_grads(
        lambda a, k: X.conv2d_transpose_subpixel(a, k, stride=2), x, wk, dtype), dtype)
    assert_close(got, value_and_grads(lambda a, k: reference.conv2d_transpose(a, k), x, wk,
                                      dtype), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,w,cin,cout", S2D_SHAPES)
def test_s2d_matches_jax_rewrite_and_plain_conv(b, h, w, cin, cout, dtype):
    """tests/test_conv0.py's shapes and bars."""
    x, wk = inputs(dtype, b, h, w, cin, cout)
    got = value_and_grads(lambda a, k: reference.conv2d_s2d(a, k, stride=2), x, wk, dtype)
    assert got[0].shape == (b, h // 2, w // 2, cout)
    assert_close(got, jax_value_and_grads(lambda a, k: X.conv2d_s2d(a, k, stride=2), x, wk, dtype),
                 dtype)
    assert_close(got, value_and_grads(lambda a, k: reference.conv2d(a, k, stride=2), x, wk,
                                      dtype), dtype)


@pytest.mark.parametrize("stride,k,h", [(2, 3, 8), (1, 4, 8), (2, 4, 7)])
def test_s2d_off_envelope_is_the_plain_conv(stride, k, h):
    """Off k=4 / stride 2 / even sizes the rewrite is the plain conv, bit for
    bit (the reference's fallback)."""
    x, wk = inputs("float32", 2, h, h, 3, 5, k=k)
    tx, tw = torch.from_numpy(x), torch.from_numpy(wk)
    assert torch.equal(reference.conv2d_s2d(tx, tw, stride=stride),
                       reference.conv2d(tx, tw, stride=stride))


def test_the_rewrites_refuse_nothing_the_models_use():
    assert reference.subpixel_deconv_supported((4, 4, 8, 3), 2)
    assert not reference.subpixel_deconv_supported((3, 3, 8, 3), 2)
    assert reference.s2d_conv_supported((4, 4, 3, 8), 2)
    assert not reference.s2d_conv_supported((3, 3, 8, 8), 1)


# -- the patches weight gradient --------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stride,k,hw", [(2, 4, 8), (1, 3, 8), (2, 4, 7)])
def test_patches_wgrad_matches_jax(stride, k, hw, dtype):
    """tests/test_wgrad.py::test_grads_match_ad on the port: the forward is
    the plain conv bit for bit, dx equals autograd of the plain conv, dw the
    JAX package's patches product (float32 2e-5; bfloat16 2% of the
    largest magnitude); an odd plane pads (1, 2)."""
    x, wk = inputs(dtype, 2, hw, hw, 3, 5, k=k)
    got = value_and_grads(lambda a, w: wgrad.conv2d_patches_wgrad(a, w, stride), x, wk, dtype,
                          loss=np.square)
    plain = value_and_grads(lambda a, w: reference.conv2d(a, w, stride=stride), x, wk, dtype,
                            loss=np.square)
    np.testing.assert_array_equal(got[0], plain[0])
    np.testing.assert_allclose(got[1], plain[1], rtol=2e-5, atol=2e-5 * max(
        float(np.abs(plain[1]).max()), 1.0))
    want = jax_value_and_grads(lambda a, w: jax_patches(a, w, stride), x, wk, dtype,
                               loss=jnp.square)
    assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw,cin,cout", [(8, 3, 5), (5, 16, 3)])
def test_transpose_patches_wgrad_matches_jax(hw, cin, cout, dtype):
    """tests/test_wgrad.py::test_transpose_grads_match_ad (k=4, stride 2,
    SAME: the models' geometry) on the port."""
    x, wk = inputs(dtype, 2, hw, hw, cin, cout)
    got = value_and_grads(lambda a, w: wgrad.conv2d_transpose_patches_wgrad(a, w), x, wk, dtype,
                          loss=np.square)
    want = jax_value_and_grads(lambda a, w: jax_transpose_patches(a, w, 2, "SAME"), x, wk, dtype,
                               loss=jnp.square)
    assert_close(got, want, dtype)
    plain = value_and_grads(lambda a, w: reference.conv2d_transpose(a, w), x, wk, dtype,
                            loss=np.square)
    np.testing.assert_array_equal(got[0], plain[0])


@pytest.mark.parametrize("transpose,stride,k,hw", [(False, 2, 4, 6), (False, 1, 3, 5),
                                                   (False, 2, 4, 5), (True, 2, 4, 3)])
def test_patches_function_is_twice_differentiable(transpose, stride, k, hw):
    """R1 differentiates the patches backward again: gradcheck and
    gradgradcheck in float64, and the im2col products counted."""
    g = torch.Generator().manual_seed(hw)
    x = torch.randn((1, hw, hw, 2), generator=g, dtype=torch.float64, requires_grad=True)
    w = torch.randn((k, k, 2, 3), generator=g, dtype=torch.float64, requires_grad=True)
    fn = (wgrad.conv2d_transpose_patches_wgrad if transpose
          else lambda a, b: wgrad.conv2d_patches_wgrad(a, b, stride))
    api.reset_routes()
    assert torch.autograd.gradcheck(fn, (x, w))
    assert torch.autograd.gradgradcheck(fn, (x, w))
    assert api.ROUTES["patches"] > 0


@pytest.mark.parametrize("transpose,stride,k,hw,cin,cout,kind,act", CONV_GRAD_CASES)
def test_fused_function_with_patches_matches_jax_pallas_vjp(transpose, stride, k, hw, cin, cout,
                                                            kind, act):
    """The fused blocks' autograd Function with wgrad="patches": dw is the
    im2col product, dx and the rest unchanged; against jax.vjp of the JAX
    package's Pallas op within 1e-3, and dw against the default engine's
    within 2e-5."""
    x = rand(50, 2, hw, hw, cin)
    w = rand(51, k, k, cin, cout, scale=0.2)
    scale = rand(52, cout, scale=0.1, offset=1.0) if kind == "group" else None
    bias, ct = rand(53, cout, scale=0.1), None
    fn = K.conv_transpose_norm_act if transpose else K.conv_norm_act
    grads = {}
    for engine in ("patches", "xla"):
        ins = [None if a is None else t(a).requires_grad_() for a in (x, w, scale, bias)]
        api.reset_routes()
        out = fn(*ins, stride=stride, kind=kind, groups=4, act=act, wgrad=engine)
        ct = rand(54, *out.shape) if ct is None else ct
        grads[engine] = torch.autograd.grad(out, [a for a in ins if a is not None], t(ct))
        assert api.ROUTES["patches"] == (engine == "patches")
    jx = [jnp.asarray(a) for a in (x, w, scale if scale is not None else np.ones(cout, np.float32),
                                   bias)]
    _, vjp = jax.vjp(jax_block(transpose, stride, kind, 4, act), *jx)
    want = vjp(jnp.asarray(ct))
    if scale is None:
        want = (want[0], want[1], want[3])
    for a, b in zip(grads["patches"], want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3, rtol=1e-3)
    np.testing.assert_array_equal(grads["patches"][0].numpy(), grads["xla"][0].numpy())
    np.testing.assert_allclose(grads["patches"][1].numpy(), grads["xla"][1].numpy(), rtol=2e-5,
                               atol=2e-5)


# -- routing ---------------------------------------------------------------------


@pytest.mark.parametrize("knob,route", [(dict(conv="s2d"), "s2d"),
                                        (dict(deconv="subpixel"), "subpixel"),
                                        (dict(wgrad="patches"), "patches")])
def test_split_layers_take_their_engine(knob, route, monkeypatch):
    """A split layer's plain conv takes the layer's engine (the budget set
    to 0 splits every layer, and no conv fits as a bare kernel call); a
    fused layer is the kernel, which already embodies s2d and subpixel."""
    transpose = "deconv" in knob
    x = t(rand(1, 2, 8, 8, 6)).requires_grad_()
    w = t(rand(2, 4, 4, 6, 8, scale=0.2)).requires_grad_()
    s, b = t(rand(3, 8, offset=1.0)), t(rand(4, 8, scale=0.1))
    kw = dict(stride=2, transpose=transpose, kind="group", groups=4,
              act="relu" if transpose else "lrelu")
    default = api.conv_norm_act(x, w, s, b, **kw)
    api.reset_routes()
    fused = api.conv_norm_act(x, w, s, b, **kw, **knob)
    assert api.ROUTES["fused"] == 1 and api.ROUTES[route] == 0
    monkeypatch.setattr(envelope, "VMEM_BUDGET", 0)
    split = api.conv_norm_act(x, w, s, b, **kw, **knob)
    torch.autograd.grad(split.sum(), (x, w))
    assert api.ROUTES["split"] == 1 and api.ROUTES["bare"] == 0 and api.ROUTES[route] == 1
    for out in (fused, split):
        np.testing.assert_allclose(out.detach().numpy(), default.detach().numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_engines_follow_the_layers_as_the_reference_sets_them(monkeypatch):
    """conv0 on the level-0 convs (G enc_0, D conv_0) only, deconv on G's
    conv-transposes, wgrad on every block: counted over one G and one D call
    with every layer split."""
    from action_conditioned_gans_tpu_torch.models import Discriminator, Generator

    m = port_config(tiny_config()).model
    monkeypatch.setattr(envelope, "VMEM_BUDGET", 0)
    counts = {}
    for knob in (dict(conv0="s2d"), dict(deconv="subpixel"), dict(wgrad="patches")):
        cfg = m.__class__(**{**m.__dict__, **knob})
        gen, disc = Generator(cfg), Discriminator(cfg)
        frame, action = torch.zeros(2, 16, 16, 3), torch.zeros(2, 4)
        api.reset_routes()
        out = disc(gen(frame, action), frame, action)
        out.sum().backward()
        counts[next(iter(knob))] = (api.ROUTES["s2d"], api.ROUTES["subpixel"],
                                    api.ROUTES["patches"])
    # G: 2 enc, bottleneck, 2 dec; D: 2 levels.
    assert counts == {"conv0": (2, 0, 0), "deconv": (0, 2, 0), "wgrad": (0, 0, 7)}


# -- bench -------------------------------------------------------------------------


@pytest.mark.parametrize("knob", [dict(wgrad="patches"), dict(deconv="subpixel"),
                                  dict(conv0="s2d"), dict(deconv="subpixel", conv0="s2d")])
def test_step_flops_are_the_same_under_every_engine(knob, monkeypatch):
    """The port's counterpart of tests/test_wgrad.py's invariance tests: the
    analytic count of a step (every layer split, so the engines run) is
    the default engines' number; with wgrad="patches" the step's own
    operators also total it (the im2col product has the wgrad conv's
    arithmetic)."""
    import dataclasses

    monkeypatch.setattr(envelope, "VMEM_BUDGET", 0)
    cfg = port_config(tiny_config(rollout_length=2))
    engined = cfg.replace(model=dataclasses.replace(cfg.model, **knob))
    assert step_flop_counts(engined) == step_flop_counts(cfg)
    if "wgrad" in knob:
        as_run = counted_step_flops(engined)
        assert as_run.get("aten.mm", 0) > step_flop_counts(cfg).get("aten.mm", 0)
        assert sum(as_run.values()) == sum(step_flop_counts(cfg).values())


@pytest.mark.parametrize("knob", ["model.wgrad=patches", "model.deconv=subpixel",
                                  "model.conv0=s2d"])
def test_bench_subcommand_runs_each_engine(knob, capsys):
    argv = ["bench", "--device", "cpu", "--steps", "2", "--set", "model.image_size=16",
            "--set", "model.g_levels=2", "--set", "model.g_base_channels=8",
            "--set", "model.d_levels=2", "--set", "model.d_base_channels=8",
            "--set", "model.group_norm_groups=4", "--set", "train.batch_size=2",
            "--set", "train.steps_per_call=1", "--set", knob]
    assert cli.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["p50_step_latency_ms"] > 0 and out["step_tflops_analytic"] > 0
