"""The port's layer ops against the JAX package's, on the CPU.

The same numpy inputs go through the JAX function (the Pallas kernel in
interpret mode and the XLA oracle) and through the port's op, whose CPU path
is the plain PyTorch version; float32, tolerance 1e-3 as in
tests/test_pallas.py. The CUDA kernels cannot run here, so their index maps
and epilogue are pinned through a torch emulation written from the CUDA
source (csrc/conv_common.cuh).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils._python_dispatch import TorchDispatchMode

from action_conditioned_gans_tpu.ops import pallas as P
from action_conditioned_gans_tpu.ops import xla as X
from action_conditioned_gans_tpu.ops.pallas import common as PC
from action_conditioned_gans_tpu_torch.ops import api, common, reference
from action_conditioned_gans_tpu_torch.ops.kernels import conv as K

torch.set_num_threads(1)
TOL = dict(atol=1e-3, rtol=1e-3)


def rand(seed, *shape, scale=1.0, offset=0.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale + offset).astype(np.float32)


def t(a):
    return None if a is None else torch.from_numpy(a)


def j(a):
    return None if a is None else jnp.asarray(a)


CONV_CASES = [
    (2, 4, "group", "lrelu"),  # encoder / discriminator stage
    (1, 3, "group", "relu"),  # bottleneck stage
    (2, 4, "none", "lrelu"),  # norm-free first layer
    (1, 3, "none", "tanh"),
]
TRANSPOSE_CASES = [("group", "relu", 16), ("none", "tanh", 3), ("group", "lrelu", 32)]


def conv_inputs(k, kind, cin=16, cout=32, hw=16):
    x = rand(0, 2, hw, hw, cin)
    w = rand(1, k, k, cin, cout, scale=0.1)
    scale = rand(2, cout, scale=0.1, offset=1.0) if kind == "group" else None
    bias = rand(3, cout, scale=0.1)
    return x, w, scale, bias


@pytest.mark.parametrize("stride,k,kind,act", CONV_CASES)
def test_conv_norm_act_matches_jax(stride, k, kind, act):
    x, w, scale, bias = conv_inputs(k, kind)
    kw = dict(stride=stride, kind=kind, groups=8, act=act)
    got = K.conv_norm_act(t(x), t(w), t(scale), t(bias), **kw).numpy()
    pallas = np.asarray(P.conv_norm_act(j(x), j(w), j(scale), j(bias), **kw))
    oracle = np.asarray(
        X.norm_act(X.conv2d(j(x), j(w), stride=stride), j(scale), j(bias),
                   kind=kind, groups=8, act=act)
    )
    assert got.shape == pallas.shape == oracle.shape
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


@pytest.mark.parametrize("kind,act,cout", TRANSPOSE_CASES)
def test_conv_transpose_norm_act_matches_jax(kind, act, cout):
    x = rand(0, 2, 8, 8, 8)
    w = rand(1, 4, 4, 8, cout, scale=0.1)
    scale = rand(2, cout, scale=0.1, offset=1.0) if kind == "group" else None
    bias = rand(3, cout, scale=0.1)
    kw = dict(stride=2, kind=kind, groups=4, act=act)
    got = K.conv_transpose_norm_act(t(x), t(w), t(scale), t(bias), **kw).numpy()
    pallas = np.asarray(P.conv_transpose_norm_act(j(x), j(w), j(scale), j(bias), **kw))
    oracle = np.asarray(
        X.norm_act(X.conv2d_transpose(j(x), j(w), stride=2), j(scale), j(bias),
                   kind=kind, groups=4, act=act)
    )
    assert got.shape == pallas.shape == oracle.shape == (2, 16, 16, cout)
    np.testing.assert_allclose(got, pallas, **TOL)
    np.testing.assert_allclose(got, oracle, **TOL)


@pytest.mark.parametrize("hw,k,stride", [(15, 4, 2), (9, 3, 1), (16, 3, 2), (7, 4, 2)])
def test_reference_conv2d_same_padding_matches_xla(hw, k, stride):
    x, w = rand(4, 2, hw, hw, 5), rand(5, k, k, 5, 6, scale=0.2)
    got = reference.conv2d(t(x), t(w), stride=stride).numpy()
    want = np.asarray(X.conv2d(j(x), j(w), stride=stride))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


class _OpLog(TorchDispatchMode):
    """The aten ops run inside, by name."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def _conv2d_explicit_pad(x, w, stride):
    """SAME conv with the padded input written out first."""
    plo, phi, qlo, qhi = reference.same_pads(x.shape, w.shape, stride)
    xn = F.pad(x.permute(0, 3, 1, 2), (qlo, qhi, plo, phi))
    y = F.conv2d(xn, w.to(x.dtype).permute(3, 2, 0, 1), stride=stride)
    return y.permute(0, 2, 3, 1).contiguous()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw,k,stride,cin", [
    (16, 4, 2, 10), (16, 4, 2, 64),  # config5's strided convs (D conv_0 has 10 channels)
    (16, 3, 1, 10), (8, 3, 1, 64),  # its 3x3 extra layers
    (7, 4, 2, 10),  # an odd plane: SAME pads (1, 2), written out
])
def test_reference_conv2d_pads_inside_the_conv(hw, k, stride, cin, dtype):
    """A symmetric SAME pad is the convolution's own: neither the forward
    nor the backward runs ``constant_pad_nd``, and out, dx and dw are the
    explicit pad's, bit for bit (float32 dx within rounding: its backward
    sums the taps over the unpadded plane in another order). An odd plane
    still pads explicitly."""
    dt = getattr(torch, dtype)
    x = t(rand(70, 2, hw, hw, cin)).to(dt)
    w = t(rand(71, k, k, cin, 12, scale=0.2))
    ct = t(rand(72, 2, -(-hw // stride), -(-hw // stride), 12)).to(dt)
    runs = []
    for fn in (reference.conv2d, _conv2d_explicit_pad):
        xi, wi = x.clone().requires_grad_(), w.clone().requires_grad_()
        with _OpLog() as log:
            out = fn(xi, wi, stride=stride)
            dx, dw = torch.autograd.grad(out, (xi, wi), ct)
        runs.append(((out, dx, dw), log.ops))
    (got, ops), (want, _) = runs
    inside = reference.pads_inside(x.shape, w.shape, stride)
    assert inside == (hw % 2 == 0)
    assert ("constant_pad_nd" in ops) == (not inside), ops
    for a, b, name in zip(got, want, ("out", "dx", "dw")):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if name == "dx" and dt == torch.float32:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * b.abs().max().item())
        else:
            assert torch.equal(a, b), name


@pytest.mark.parametrize("hw", [8, 5])
def test_reference_conv2d_transpose_matches_lax(hw):
    x, w = rand(6, 2, hw, hw, 8), rand(7, 4, 4, 8, 5, scale=0.2)
    got = reference.conv2d_transpose(t(x), t(w)).numpy()
    want = np.asarray(X.conv2d_transpose(j(x), j(w), stride=2))
    assert got.shape == want.shape == (2, 2 * hw, 2 * hw, 5)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", ["group", "batch", "none"])
@pytest.mark.parametrize("act", ["lrelu", "relu", "tanh", "none"])
def test_norm_act_matches_xla(kind, act):
    x = rand(8, 2, 8, 8, 24, scale=2.0, offset=0.5)
    scale, bias = rand(9, 24, scale=0.1, offset=1.0), rand(10, 24, scale=0.1)
    kw = dict(kind=kind, groups=5, act=act)  # 5 -> 4 groups of 6 (resolve_groups)
    got = api.norm_act(t(x), t(scale), t(bias), **kw).numpy()
    want = np.asarray(X.norm_act(j(x), j(scale), j(bias), **kw))
    np.testing.assert_allclose(got, want, **TOL)


def test_dense_and_leaky_relu_match_xla():
    x, w, b = rand(11, 3, 7), rand(12, 7, 5), rand(13, 5)
    np.testing.assert_allclose(
        api.dense(t(x), t(w), t(b)).numpy(), np.asarray(X.dense(j(x), j(w), j(b))), **TOL
    )
    np.testing.assert_array_equal(
        api.leaky_relu(t(x), 0.2).numpy(), np.asarray(X.leaky_relu(j(x), 0.2))
    )


@pytest.mark.parametrize("channels,groups", [(64, 32), (3, 32), (260, 32), (24, 5), (7, 4)])
def test_resolve_groups_matches_jax(channels, groups):
    assert common.resolve_groups(channels, groups) == PC.resolve_groups(channels, groups)


@pytest.mark.parametrize("logical", [0, 8])
def test_group_norm_rows_matches_pallas_epilogue(logical):
    x = rand(14, 64, 32, scale=3.0, offset=1.0)
    scale, bias = rand(15, 32, scale=0.1, offset=1.0), rand(16, 32, scale=0.1)
    got = common.group_norm_rows(t(x), t(scale), t(bias), 4, 1e-5, logical_channels=logical)
    want = PC.group_norm_epilogue(j(x), j(scale)[None], j(bias)[None], 4, 1e-5,
                                  logical_channels=logical)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- the kernels' index maps and epilogue, emulated from csrc/conv_common.cuh --


def emulate_conv_gemm(x, w, stride):
    """row_at / tap_at / a_offset / w_row with TRANSPOSE=false: for output
    pixel (oy, ox) and depth k = (kh*KW + kw)*Cin + ci, A = x[oy*s - pad_h + kh,
    ox*s - pad_w + kw, ci] (0 outside), B = w flat [k, n]."""
    b, h, wd, cin = x.shape
    kh_, kw_, _, cout = w.shape
    oh, pad_h, _ = common.same_pad(h, kh_, stride)
    ow, pad_w, _ = common.same_pad(wd, kw_, stride)
    y = torch.zeros(b, oh, ow, cout)
    wflat = w.reshape(kh_ * kw_ * cin, cout)
    for oy in range(oh):
        for ox in range(ow):
            cols = []
            for kh in range(kh_):
                for kw in range(kw_):
                    ih, iw = oy * stride - pad_h + kh, ox * stride - pad_w + kw
                    inside = 0 <= ih < h and 0 <= iw < wd
                    cols.append(x[:, ih, iw, :] if inside else torch.zeros(b, cin))
            y[:, oy, ox] = torch.cat(cols, dim=1) @ wflat
    return y


def emulate_conv_transpose_gemm(x, w):
    """The same maps with TRANSPOSE=true: phase (r, c), pixel (a, bb), depth
    k = (dy*2 + dx)*Cin + ci; A = x[a+dy+r-1, bb+dx+c-1, ci], B row =
    ((2dy+r)*4 + 2dx+c)*Cin + ci of the HWIO weights; out_offset puts the
    result at (2a+r, 2bb+c)."""
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    wflat = w.reshape(16 * cin, cout)
    y = torch.zeros(b, 2 * h, 2 * wd, cout)
    for r in range(2):
        for c in range(2):
            rows = torch.cat(
                [wflat[((2 * dy + r) * 4 + 2 * dx + c) * cin:][:cin]
                 for dy in range(2) for dx in range(2)]
            )
            for a in range(h):
                for bb in range(wd):
                    cols = []
                    for dy in range(2):
                        for dx in range(2):
                            ih, iw = a + dy + r - 1, bb + dx + c - 1
                            inside = 0 <= ih < h and 0 <= iw < wd
                            cols.append(x[:, ih, iw, :] if inside else torch.zeros(b, cin))
                    y[:, 2 * a + r, 2 * bb + c] = torch.cat(cols, dim=1) @ rows
    return y


def emulate_epilogue(y, scale, bias, kind, groups, act, leak=0.2):
    """tile_epilogue + gn_stats_kernel + gn_apply_kernel (or the fused bias
    path): per-sample GroupNorm with E[x^2] - mean^2 statistics, affine,
    activation in float32."""
    if kind == "none":
        return common.apply_act(y + bias, act, leak)
    g = common.resolve_groups(y.shape[-1], groups)
    out = torch.stack(
        [common.group_norm_rows(s.reshape(-1, s.shape[-1]), scale, bias, g, 1e-5).reshape(s.shape)
         for s in y]
    )
    return common.apply_act(out, act, leak)


@pytest.mark.parametrize("stride,k,kind,act", CONV_CASES)
def test_kernel_conv_index_map_matches_plain(stride, k, kind, act):
    x, w, scale, bias = (t(a) for a in conv_inputs(k, kind, cin=5, cout=12, hw=9))
    y = emulate_conv_gemm(x, w, stride)
    got = emulate_epilogue(y, scale, bias, kind, 4, act)
    want = K.conv_norm_act_plain(x, w, scale, bias, stride=stride, kind=kind, groups=4, act=act)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("kind,act,cout", TRANSPOSE_CASES)
def test_kernel_conv_transpose_index_map_matches_plain(kind, act, cout):
    x = t(rand(17, 2, 5, 6, 6))
    w = t(rand(18, 4, 4, 6, cout, scale=0.1))
    scale = t(rand(19, cout, scale=0.1, offset=1.0)) if kind == "group" else None
    bias = t(rand(20, cout, scale=0.1))
    got = emulate_epilogue(emulate_conv_transpose_gemm(x, w), scale, bias, kind, 4, act)
    want = K.conv_transpose_norm_act_plain(x, w, scale, bias, kind=kind, groups=4, act=act)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_api_routes_cpu_tensors_to_plain_versions_without_launching():
    x, w, scale, bias = (t(a) for a in conv_inputs(4, "group", cin=8, cout=8, hw=8))
    before = dict(K.LAUNCHES)
    out = api.conv_norm_act(x, w, scale, bias, stride=2, transpose=True, groups=4, act="relu")
    want = K.conv_transpose_norm_act_plain(x, w, scale, bias, groups=4, act="relu")
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    out = api.conv_norm_act(x, w, scale, bias, stride=2, groups=4)
    want = K.conv_norm_act_plain(x, w, scale, bias, stride=2, groups=4)
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    assert K.LAUNCHES == before


def test_activation_table_matches_kernel_enum():
    # csrc/gn_common.cuh: ACT_NONE=0, ACT_LRELU=1, ACT_RELU=2, ACT_TANH=3.
    assert common.ACTIVATIONS == ("none", "lrelu", "relu", "tanh")
    y = t(rand(21, 50))
    for act in common.ACTIVATIONS:
        np.testing.assert_allclose(
            common.apply_act(y, act, 0.2).numpy(),
            np.asarray(PC.apply_act(j(y.numpy()), act, 0.2)),
            atol=1e-6,
        )
