"""Kernels 1-3's forwards as ``torch.library`` custom ops
(``ops/kernels/library.py``), on the CPU.

``torch.library.opcheck`` (schema, fake implementation, autograd
registration, AOT dispatch with dynamic shapes) at two shapes per op, with
and without the optional scale and bias; the op's CPU implementation gives
the plain version's bits; a generator traced by torch.export calls the ops
once a fused layer, and live it calls the same plain versions directly.
"""

import numpy as np
import pytest
import torch

from action_conditioned_gans_tpu_torch.config import Config, ModelConfig
from action_conditioned_gans_tpu_torch.infer import Predictor
from action_conditioned_gans_tpu_torch.models import Generator
from action_conditioned_gans_tpu_torch.ops.kernels import conv, library, norm_act

torch.set_num_threads(1)


def t(seed, *shape, scale=1.0, dtype=torch.float32):
    a = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(a).to(dtype)


CONV_CASES = [
    # x shape, w shape, stride, kind, act, dtype
    ((2, 8, 8, 16), (4, 4, 16, 32), 2, "group", "lrelu", torch.float32),
    ((3, 7, 5, 8), (3, 3, 8, 16), 1, "none", "tanh", torch.bfloat16),
]
TRANSPOSE_CASES = [
    ((2, 4, 4, 32), (4, 4, 32, 16), 2, "group", "relu", torch.float32),
    ((1, 3, 5, 8), (4, 4, 8, 3), 2, "none", "tanh", torch.bfloat16),
]
NORM_CASES = [((2, 5, 6, 32), 8, "lrelu", torch.float32), ((3, 4, 4, 64), 32, "none", torch.bfloat16)]


def conv_args(case, seed):
    x_shape, w_shape, stride, kind, act, dtype = case
    cout = w_shape[3]
    scale = t(seed + 2, cout, scale=0.1) + 1 if kind == "group" else None
    return (t(seed, *x_shape, dtype=dtype), t(seed + 1, *w_shape, scale=0.1), scale,
            t(seed + 3, cout, scale=0.1), stride, kind, 4, 1e-5, act, 0.2)


@pytest.mark.parametrize("case", CONV_CASES)
def test_conv_norm_act_op(case):
    args = conv_args(case, 10)
    torch.library.opcheck(library.conv_norm_act, args)
    x, w, s, b, stride, kind, groups, eps, act, leak = args
    want = conv.conv_norm_act_plain(x, w, s, b, stride=stride, kind=kind, groups=groups, eps=eps,
                                    act=act, leak=leak)
    assert torch.equal(torch.ops.acgan.conv_norm_act(*args), want)
    assert torch.equal(conv.conv_norm_act(x, w, s, b, stride=stride, kind=kind, groups=groups,
                                          eps=eps, act=act, leak=leak), want)


@pytest.mark.parametrize("case", TRANSPOSE_CASES)
def test_conv_transpose_norm_act_op(case):
    args = conv_args(case, 20)
    torch.library.opcheck(library.conv_transpose_norm_act, args)
    x, w, s, b, stride, kind, groups, eps, act, leak = args
    want = conv.conv_transpose_norm_act_plain(x, w, s, b, stride=stride, kind=kind, groups=groups,
                                              eps=eps, act=act, leak=leak)
    got = torch.ops.acgan.conv_transpose_norm_act(*args)
    assert got.shape == (x.shape[0], 2 * x.shape[1], 2 * x.shape[2], w.shape[3])
    assert torch.equal(got, want)


@pytest.mark.parametrize("shape,groups,act,dtype", NORM_CASES)
@pytest.mark.parametrize("affine", [True, False])
def test_group_norm_act_op(shape, groups, act, dtype, affine):
    c = shape[-1]
    x = t(30, *shape, dtype=dtype)
    s, b = (t(31, c, scale=0.1) + 1, t(32, c, scale=0.1)) if affine else (None, None)
    args = (x, s, b, groups, 1e-5, act, 0.2)
    torch.library.opcheck(library.group_norm_act, args)
    want = norm_act.group_norm_act_plain(x, s, b, groups=groups, act=act)
    assert torch.equal(torch.ops.acgan.group_norm_act(*args), want)
    assert torch.equal(norm_act.group_norm_act(x, s, b, groups=groups, act=act), want)


def test_fake_implementations_keep_a_symbolic_batch():
    """On meta tensors the ops give the kernels' output shapes: SAME with
    stride 1 or 2 (odd planes round up), x2 for the transpose."""
    m = torch.device("meta")
    x, w = torch.empty(5, 9, 7, 8, device=m), torch.empty(4, 4, 8, 16, device=m)
    out = torch.ops.acgan.conv_norm_act(x, w, None, None, 2, "none", 4, 1e-5, "none", 0.2)
    assert out.shape == (5, 5, 4, 16) and out.device == m
    out = torch.ops.acgan.conv_transpose_norm_act(x, w, None, None, 2, "none", 4, 1e-5, "relu",
                                                  0.2)
    assert out.shape == (5, 18, 14, 16)
    x = torch.empty(5, 9, 7, 32, dtype=torch.bfloat16, device=m)
    out = torch.ops.acgan.group_norm_act(x, None, None, 8, 1e-5, "lrelu", 0.2)
    assert out.shape == x.shape and out.dtype == torch.bfloat16


def test_the_live_predictor_and_its_export_run_the_same_code():
    """A tiny float32 generator, every layer fused. Live, its predict calls
    the plain versions directly (equal layer by layer), not the ops; traced
    by torch.export it calls conv_norm_act three times and
    conv_transpose_norm_act twice, and the program gives the live bits."""
    m = ModelConfig(image_size=16, g_levels=2, g_base_channels=8, group_norm_groups=4,
                    compute_dtype="float32")
    gen = Generator(m, generator=torch.Generator().manual_seed(0))
    live = Predictor(Config(model=m), gen.state_dict(), device="cpu")
    calls = []
    real = {name: getattr(library, name) for name in ("conv_norm_act", "conv_transpose_norm_act")}

    def recording(name):
        def op(*args):
            calls.append(name)
            return real[name](*args)
        return op

    frame, action = t(40, 2, 16, 16, 3).tanh(), t(41, 2, 4)
    for name in real:
        setattr(library, name, recording(name))
    try:
        got = live.predict(frame, action)
        assert calls == []
        with torch.no_grad():
            program = torch.export.export(live.generator, (frame, action), strict=False)
    finally:
        for name, op in real.items():
            setattr(library, name, op)
    assert sorted(calls) == ["conv_norm_act"] * 3 + ["conv_transpose_norm_act"] * 2
    with torch.no_grad():
        assert torch.equal(program.module()(frame, action), got)

    x = frame
    for name in ("enc_0", "enc_1", "bottleneck", "dec_1", "dec_0"):
        block = getattr(live.generator, name)
        if name == "bottleneck":
            x = torch.cat([x, action[:, None, None, :].expand(2, 4, 4, 4)], dim=-1)
        plain = conv.conv_transpose_norm_act_plain if block.transpose else conv.conv_norm_act_plain
        x = plain(x, block.kernel, block.scale, block.bias, stride=block.stride, kind=block.norm,
                  groups=block.groups, act=block.act, leak=block.leak)
    assert torch.equal(got, x)


@pytest.mark.parametrize("transpose", [False, True])
def test_flop_counter_counts_the_conv_ops_as_aten_convolution(transpose):
    """The serving path's FLOPs: the op's count is its plain version's."""
    from torch.utils.flop_counter import FlopCounterMode

    case = (TRANSPOSE_CASES if transpose else CONV_CASES)[0]
    args = conv_args(case, 50)
    x, w, s, b, stride, kind, groups, eps, act, leak = args
    op = library.conv_transpose_norm_act if transpose else library.conv_norm_act
    plain = conv.conv_transpose_norm_act_plain if transpose else conv.conv_norm_act_plain
    counts = []
    for fn in (lambda: op(*args), lambda: plain(x, w, s, b, stride=stride, kind=kind,
                                                groups=groups, eps=eps, act=act, leak=leak)):
        counter = FlopCounterMode(display=False)
        with counter:
            fn()
        counts.append(counter.get_total_flops())
    assert counts[0] == counts[1] > 0
