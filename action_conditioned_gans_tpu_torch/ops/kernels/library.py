"""Kernels 1-3's forwards as ``torch.library`` custom ops.

``torch.export`` traces through operators, not through a ctypes call, so the
serving path reaches the fused conv kernels and the standalone
GroupNorm+activation kernel through three ops of the ``acgan`` namespace:

* ``acgan::conv_norm_act``: SAME conv (stride 1 or 2) -> GroupNorm or bias ->
  affine -> activation (kernel 1, ``csrc/conv_norm_act.cu``);
* ``acgan::conv_transpose_norm_act``: k=4 / stride-2 conv-transpose -> the
  same epilogue (kernel 2, ``csrc/conv_transpose_norm_act.cu``);
* ``acgan::group_norm_act``: GroupNorm -> affine -> activation (kernel 3,
  ``csrc/group_norm_act.cu``).

The CUDA implementation of each launches its kernel through the wrapper's
launcher, which counts the launch (``conv.LAUNCHES``, ``norm_act.LAUNCHES``);
the CPU implementation is the wrapper's plain version; the fake
implementation gives the output's shape and dtype, with the batch left
symbolic. The no-grad forwards of ``conv.py`` and ``norm_act.py`` call these
ops while ``torch.export`` traces, and the same launchers and plain versions
directly when run live (the op's dispatch costs host time on a path the
host bounds), so the live ``Predictor`` and an exported program run the same
kernels and give the same bits; the autograd Functions and kernel 4 do not
use the ops. ``torch.utils.flop_counter``
counts the conv ops' arithmetic as it counts ``aten.convolution``.

Importing this module registers the ops and imports no model code: an
exported program (``aot.AotPredictor``) needs only this module to load.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.flop_counter import conv_flop_count, register_flop_formula

from action_conditioned_gans_tpu_torch.ops.common import same_pad


def _conv_opts(transpose, stride, kind, groups, eps, act, leak):
    from action_conditioned_gans_tpu_torch.ops.kernels import conv

    return conv, conv._Opts(transpose, stride, kind, groups, eps, act, leak)


@torch.library.custom_op("acgan::conv_norm_act", mutates_args=(), device_types="cpu")
def conv_norm_act(x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor],
                  bias: Optional[torch.Tensor], stride: int, kind: str, groups: int, eps: float,
                  act: str, leak: float) -> torch.Tensor:
    conv, o = _conv_opts(False, stride, kind, groups, eps, act, leak)
    return conv._plain(x, w, scale, bias, o)[0]


@conv_norm_act.register_kernel("cuda")
def _conv_norm_act_cuda(x, w, scale, bias, stride, kind, groups, eps, act, leak):
    conv, o = _conv_opts(False, stride, kind, groups, eps, act, leak)
    return conv._launch_conv(x, w, scale, bias, o)[0]


@conv_norm_act.register_fake
def _conv_norm_act_fake(x, w, scale, bias, stride, kind, groups, eps, act, leak):
    b, h, wd, _ = x.shape
    kh, kw, _, cout = w.shape
    return x.new_empty((b, same_pad(h, kh, stride)[0], same_pad(wd, kw, stride)[0], cout))


@torch.library.custom_op("acgan::conv_transpose_norm_act", mutates_args=(),
                         device_types="cpu")
def conv_transpose_norm_act(x: torch.Tensor, w: torch.Tensor, scale: Optional[torch.Tensor],
                            bias: Optional[torch.Tensor], stride: int, kind: str, groups: int,
                            eps: float, act: str, leak: float) -> torch.Tensor:
    conv, o = _conv_opts(True, stride, kind, groups, eps, act, leak)
    return conv._plain(x, w, scale, bias, o)[0]


@conv_transpose_norm_act.register_kernel("cuda")
def _conv_transpose_norm_act_cuda(x, w, scale, bias, stride, kind, groups, eps, act, leak):
    conv, o = _conv_opts(True, stride, kind, groups, eps, act, leak)
    return conv._launch_conv_transpose(x, w, scale, bias, o)[0]


@conv_transpose_norm_act.register_fake
def _conv_transpose_norm_act_fake(x, w, scale, bias, stride, kind, groups, eps, act, leak):
    b, h, wd, _ = x.shape
    return x.new_empty((b, 2 * h, 2 * wd, w.shape[3]))


def _conv_flops(transposed: bool):
    """The conv's FLOPs as the counter gives them for ``aten.convolution``
    (NCHW / OIHW there, NHWC / HWIO here)."""

    def formula(x_shape, w_shape, *args, out_shape=None, **kwargs):
        b, h, w, cin = x_shape
        kh, kw, _, cout = w_shape
        return conv_flop_count([b, cin, h, w], [cout, cin, kh, kw],
                               [b, cout, out_shape[1], out_shape[2]], transposed=transposed)

    return formula


register_flop_formula(torch.ops.acgan.conv_norm_act)(_conv_flops(False))
register_flop_formula(torch.ops.acgan.conv_transpose_norm_act)(_conv_flops(True))


@torch.library.custom_op("acgan::group_norm_act", mutates_args=(), device_types="cpu")
def group_norm_act(x: torch.Tensor, scale: Optional[torch.Tensor], bias: Optional[torch.Tensor],
                   groups: int, eps: float, act: str, leak: float) -> torch.Tensor:
    from action_conditioned_gans_tpu_torch.ops.kernels import norm_act

    return norm_act.group_norm_act_plain(x, scale, bias, groups=groups, eps=eps, act=act,
                                         leak=leak)


@group_norm_act.register_kernel("cuda")
def _group_norm_act_cuda(x, scale, bias, groups, eps, act, leak):
    from action_conditioned_gans_tpu_torch.ops.kernels import norm_act

    return norm_act._launch(x, scale, bias, norm_act._Opts(groups, eps, act, leak))[0]


@group_norm_act.register_fake
def _group_norm_act_fake(x, scale, bias, groups, eps, act, leak):
    return x.new_empty(x.shape)
