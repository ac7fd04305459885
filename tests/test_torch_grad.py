"""Gradients of the port's layer ops against the JAX package's, on the CPU.

* ``act_bwd`` and ``reference.gn_act_grads`` (the plain version of the
  GroupNorm+activation backward kernel) against ``ops/gn.py``, and the
  kernel wrapper's CPU path against ``gn_act_bwd_pallas`` run in interpret
  mode, as tests/test_gn_backward.py runs it;
* the kernel's cluster decomposition (per-block channel sums S1, S2, the
  scale-weighted group sums reduced in rank order, the per-sample partials
  and the batch sum), emulated in torch from ``csrc/gn_act_bwd.cu``
  (tests/test_torch_gn_bwd_cluster.py), since the CUDA kernel cannot run
  here;
* the autograd Functions of the fused conv blocks against ``jax.vjp`` of the
  JAX package's Pallas ``conv_norm_act`` / ``conv_transpose_norm_act``
  (interpret mode): dx, dw, dscale, dbias in float32 within 1e-3.

Inputs are numpy arrays from seeds fed to both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from action_conditioned_gans_tpu.ops import gn as JG
from action_conditioned_gans_tpu.ops.pallas import conv as PConv
from action_conditioned_gans_tpu.ops.pallas.gn_bwd import gn_act_bwd_pallas
from action_conditioned_gans_tpu_torch.ops import api, common, reference
from action_conditioned_gans_tpu_torch.ops.kernels import conv as K
from action_conditioned_gans_tpu_torch.ops.kernels import gn_bwd
from tests.test_torch_gn_bwd_cluster import emulate_gn_act_bwd_kernel

torch.set_num_threads(1)
TOL = dict(atol=1e-3, rtol=1e-3)
GN_TOL = dict(atol=2e-5, rtol=2e-5)  # float32, same formula, other summation order
ACTS = ["lrelu", "relu", "tanh", "none"]


def rand(seed, *shape, scale=1.0, offset=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + offset).astype(np.float32)


def t(a):
    return None if a is None else torch.from_numpy(np.array(a, np.float32))


def gn_inputs(seed, b=2, h=5, w=6, c=16, groups=4, act="lrelu", dtype=np.float32):
    """Pre-norm y, its forward output through GroupNorm + affine + act, a
    cotangent, and the forward's (mean, rstd), all from one seed."""
    y = rand(seed, b, h, w, c, scale=1.5, offset=0.3)
    scale = rand(seed + 1, c, scale=0.2, offset=1.0)
    bias = rand(seed + 2, c, scale=0.1)
    g = rand(seed + 3, b, h, w, c)
    out = reference.norm_act(t(y), t(scale), t(bias), groups=groups, act=act).numpy()
    gr = common.resolve_groups(c, groups)
    yg = y.astype(np.float64).reshape(b, h, w, gr, c // gr)
    mean = yg.mean(axis=(1, 2, 4))
    rstd = 1.0 / np.sqrt(yg.var(axis=(1, 2, 4)) + 1e-5)
    if dtype != np.float32:
        out = np.asarray(jnp.asarray(out).astype(dtype).astype(jnp.float32))
        g = np.asarray(jnp.asarray(g).astype(dtype).astype(jnp.float32))
    return y, scale, out, g, mean.astype(np.float32), rstd.astype(np.float32)


# -- act_bwd -------------------------------------------------------------------


@pytest.mark.parametrize("act,leak", [("lrelu", 0.2), ("lrelu", 0.0), ("relu", 0.2),
                                      ("tanh", 0.2), ("none", 0.2)])
def test_act_bwd_matches_jax(act, leak):
    g, out = rand(0, 64), rand(1, 64)
    out[:4] = 0.0  # the mask's edge: strict at leak 0 and for relu
    got = common.act_bwd(t(g), t(out), act, leak).numpy()
    want = np.asarray(JG.act_bwd(jnp.asarray(g), jnp.asarray(out), act, leak))
    np.testing.assert_array_equal(got, want)


def test_act_bwd_refuses_negative_leak():
    with pytest.raises(ValueError, match="leak >= 0"):
        common.act_bwd(torch.ones(2), torch.ones(2), "lrelu", -0.1)


# -- GroupNorm + activation backward -------------------------------------------


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("c,groups", [(16, 4), (12, 8), (40, 32)])  # 12/8 -> 6, 40/32 -> 20
@pytest.mark.parametrize("saved_stats", [True, False])
def test_gn_act_grads_matches_jax(act, c, groups, saved_stats):
    y, scale, out, g, mean, rstd = gn_inputs(10, c=c, groups=groups, act=act)
    stats = (mean, rstd) if saved_stats else (None, None)
    got = reference.gn_act_grads(t(y), t(scale), t(out), t(g), t(stats[0]), t(stats[1]),
                                 groups=groups, act=act)
    want = JG.gn_act_grads(jnp.asarray(y), jnp.asarray(scale), jnp.asarray(out), jnp.asarray(g),
                           groups=groups, eps=1e-5, act=act, leak=0.2,
                           mean=None if stats[0] is None else jnp.asarray(mean),
                           rstd=None if stats[1] is None else jnp.asarray(rstd))
    for a, b, name in zip(got, want, ("dy", "dscale", "dbias")):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GN_TOL, err_msg=name)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("c,groups", [(16, 4), (24, 32)])  # 24/32 -> 24 groups of 1
def test_gn_act_bwd_cpu_path_matches_jax_pallas_kernel(act, dtype, c, groups):
    """The wrapper's CPU path (the kernel's plain version) against the JAX
    package's Pallas kernel in interpret mode, on the same inputs: y float32
    (the port's forward scratch), out and g in the compute dtype."""
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    y, scale, out, g, mean, rstd = gn_inputs(20, c=c, groups=groups, act=act, dtype=jdt)
    gr = common.resolve_groups(c, groups)
    dx, dscale, dbias = gn_bwd.gn_act_bwd(
        t(y), t(scale), t(out).to(tdt), t(g).to(tdt), t(mean), t(rstd), groups=groups, act=act)
    assert dx.dtype == tdt and dscale.dtype == dbias.dtype == torch.float32
    want = gn_act_bwd_pallas(
        jnp.asarray(y), jnp.asarray(scale), jnp.asarray(out).astype(jdt), jnp.asarray(g).astype(jdt),
        jnp.asarray(mean), jnp.asarray(rstd), groups=gr, act=act, leak=0.2)
    # The JAX kernel writes dx in y's dtype (float32 here); the port in the
    # compute dtype, so bfloat16 holds within one bfloat16 step of |dx|.
    dx_tol = GN_TOL if dtype == "float32" else dict(atol=1e-2, rtol=8e-3)
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(want[0]), **dx_tol)
    np.testing.assert_allclose(dscale.numpy(), np.asarray(want[1]), **GN_TOL)
    np.testing.assert_allclose(dbias.numpy(), np.asarray(want[2]), **GN_TOL)


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("shape,groups", [((2, 5, 6, 16), 4), ((2, 9, 15, 80), 32),
                                          ((3, 8, 8, 12), 8), ((2, 4, 4, 64), 32)])
def test_kernel_pass_decomposition_matches_plain(act, shape, groups):
    b, h, w, c = shape
    y, scale, out, g, mean, rstd = gn_inputs(30, b, h, w, c, groups=groups, act=act)
    gr = common.resolve_groups(c, groups)
    got = emulate_gn_act_bwd_kernel(t(y), t(out), t(g), t(scale), t(mean), t(rstd), gr, act, 0.2)
    want = gn_bwd.gn_act_bwd_plain(t(y), t(scale), t(out), t(g), t(mean), t(rstd),
                                   groups=groups, act=act)
    for a, b_, name in zip(got, want, ("dx", "dscale", "dbias")):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), **GN_TOL, err_msg=name)


def test_gn_act_bwd_cpu_path_recomputes_missing_stats():
    y, scale, out, g, mean, rstd = gn_inputs(40)
    a = gn_bwd.gn_act_bwd(t(y), t(scale), t(out), t(g), groups=4)
    b = gn_bwd.gn_act_bwd(t(y), t(scale), t(out), t(g), t(mean), t(rstd), groups=4)
    for x, z in zip(a, b):
        np.testing.assert_allclose(x.numpy(), z.numpy(), **GN_TOL)
    assert gn_bwd.LAUNCHES == {"gn_act_bwd": 0}


# -- autograd Functions of the fused conv blocks --------------------------------

CONV_GRAD_CASES = [
    # transpose, stride, k, hw, cin, cout, kind, act
    (False, 2, 4, 8, 6, 16, "group", "lrelu"),  # encoder / D stage
    (False, 2, 4, 9, 5, 12, "group", "lrelu"),  # odd plane: SAME pads (1, 2)
    (False, 1, 3, 6, 10, 16, "group", "relu"),  # bottleneck
    (False, 2, 4, 8, 10, 8, "none", "lrelu"),  # enc_0 / D conv_0
    (True, 2, 4, 4, 16, 8, "group", "relu"),  # decoder stage
    (True, 2, 4, 5, 8, 3, "none", "tanh"),  # output layer
]


def jax_block(transpose, stride, kind, groups, act):
    if transpose:
        return lambda x, w, s, b: PConv.conv_transpose_norm_act(
            x, w, s, b, stride=stride, kind=kind, groups=groups, act=act)
    return lambda x, w, s, b: PConv.conv_norm_act(
        x, w, s, b, stride=stride, kind=kind, groups=groups, act=act)


@pytest.mark.parametrize("transpose,stride,k,hw,cin,cout,kind,act", CONV_GRAD_CASES)
def test_autograd_function_matches_jax_pallas_vjp(transpose, stride, k, hw, cin, cout, kind, act):
    x = rand(50, 2, hw, hw, cin)
    w = rand(51, k, k, cin, cout, scale=0.2)
    scale = rand(52, cout, scale=0.1, offset=1.0) if kind == "group" else None
    bias = rand(53, cout, scale=0.1)
    fn = K.conv_transpose_norm_act if transpose else K.conv_norm_act
    tx, tw, tb = (t(a).requires_grad_() for a in (x, w, bias))
    ts = t(scale).requires_grad_() if scale is not None else None
    out = fn(tx, tw, ts, tb, stride=stride, kind=kind, groups=4, act=act)
    want_fn = K.ConvTransposeNormActFn if transpose else K.ConvNormActFn
    assert out.grad_fn.name() == want_fn.__name__ + "Backward"
    ct = rand(54, *out.shape)
    ins = [a for a in (tx, tw, ts, tb) if a is not None]
    got = torch.autograd.grad(out, ins, t(ct))

    jx = [jnp.asarray(a) for a in (x, w, scale if scale is not None else np.ones(cout, np.float32),
                                   bias)]
    jout, vjp = jax.vjp(jax_block(transpose, stride, kind, 4, act), *jx)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **TOL)
    want = vjp(jnp.asarray(ct))
    if scale is None:
        want = (want[0], want[1], want[3])
    for a, b, name in zip(got, want, ("dx", "dw", "dscale", "dbias") if scale is not None
                          else ("dx", "dw", "dbias")):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL, err_msg=name)


def test_autograd_function_bf16_matches_jax_pallas_vjp():
    """bfloat16 activations (float32 parameters): the gradients agree with
    the JAX VJP within bfloat16 resolution."""
    x, w = rand(60, 2, 8, 8, 8), rand(61, 4, 4, 8, 16, scale=0.2)
    scale, bias, ct = rand(62, 16, scale=0.1, offset=1.0), rand(63, 16, scale=0.1), rand(64, 2, 4, 4, 16)
    tx = t(x).to(torch.bfloat16).requires_grad_()
    tw, ts, tb = (t(a).requires_grad_() for a in (w, scale, bias))
    out = K.conv_norm_act(tx, tw, ts, tb, stride=2, groups=4)
    got = torch.autograd.grad(out, (tx, tw, ts, tb), t(ct).to(torch.bfloat16))
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == torch.float32
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    _, vjp = jax.vjp(jax_block(False, 2, "group", 4, "lrelu"), jx, *map(jnp.asarray, (w, scale, bias)))
    want = vjp(jnp.asarray(ct).astype(jnp.bfloat16))
    for a, b, name in zip(got, want, ("dx", "dw", "dscale", "dbias")):
        b = np.asarray(jnp.asarray(b).astype(jnp.float32))
        np.testing.assert_allclose(a.float().numpy(), b, atol=0.05 * float(np.abs(b).max()),
                                   err_msg=name)


def test_function_honours_needs_input_grad(monkeypatch):
    """No dx for a data input, no dw for frozen weights: convolution_backward
    is asked only for what is needed."""
    masks = []
    real = K._convolution_backward

    def spy(*args):
        masks.append(list(args[-1]))
        return real(*args)

    monkeypatch.setattr(K, "_convolution_backward", spy)
    x, w = t(rand(70, 2, 8, 8, 6)), t(rand(71, 4, 4, 6, 8, scale=0.2))
    scale, bias = t(rand(72, 8, offset=1.0)), t(rand(73, 8))
    out = K.conv_norm_act(x, w.requires_grad_(), scale, bias, stride=2, groups=4)
    out.sum().backward()
    assert masks[-1] == [False, True, False] and w.grad is not None
    xr = x.clone().requires_grad_()
    out = K.conv_transpose_norm_act(xr, w.detach(), scale.requires_grad_(), bias, groups=4)
    out.sum().backward()
    assert masks[-1] == [True, False, False] and xr.grad is not None and scale.grad is not None


def test_no_grad_path_keeps_no_residuals_and_equals_the_function_path(monkeypatch):
    x, w = t(rand(80, 2, 8, 8, 6)), t(rand(81, 4, 4, 6, 8, scale=0.2))
    scale, bias = t(rand(82, 8, offset=1.0)), t(rand(83, 8))
    residual_calls, forward = [], K._forward
    monkeypatch.setattr(K, "_forward", lambda *a: residual_calls.append(1) or forward(*a))
    with torch.no_grad():
        plain = api.conv_norm_act(x, w.requires_grad_(), scale, bias, stride=2, groups=4)
    assert plain.grad_fn is None and not residual_calls
    with_grad = api.conv_norm_act(x, w, scale, bias, stride=2, groups=4)
    assert residual_calls == [1]
    assert with_grad.grad_fn.name() == "ConvNormActFnBackward"
    np.testing.assert_array_equal(plain.numpy(), with_grad.detach().numpy())
    assert K.LAUNCHES == {"conv_norm_act": 0, "conv_transpose_norm_act": 0}
