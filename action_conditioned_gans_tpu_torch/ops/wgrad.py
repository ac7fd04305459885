"""The patches (im2col) weight gradient, ``ModelConfig.wgrad="patches"``
(port of the JAX package's ``ops/wgrad.py``).

The forward is the plain conv. The backward computes dx by the transposed
conv, as autograd of the plain conv does, and dW as ONE matrix product over
explicitly extracted patches::

    dW[kh, kw, ci, co] = sum_{b,i,j} x_pad[b, s*i+kh, s*j+kw, ci] * dy[b, i, j, co]
                       = patches(x)^T @ dy, folded over (b, i, j)

For the conv-transpose the patches are taken of dy instead (stride-s
windows over the 1-padded dy, one per input position), with the kernel
axes reversed: ``lax.conv_transpose`` correlates the dilated input with the
kernel as given.

The product accumulates in float32 from operands in the compute dtype, as
the reference's ``preferred_element_type=float32`` dot does, and dW is
returned in the weight's dtype. The backward is built from differentiable
torch ops (pad, ``Tensor.unfold``, matmul, conv), so a second backward (the
R1 penalty's) differentiates through it, as JAX differentiates its
``custom_vjp``. Each product is counted in ``ROUTES["patches"]``. The fused
conv blocks' backward (``ops/kernels/conv.py``) takes :func:`patches_dw`
for their weight gradient under the same knob.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from action_conditioned_gans_tpu_torch.ops import reference
from action_conditioned_gans_tpu_torch.ops.common import ROUTES


def _windows(t: torch.Tensor, k: int, stride: int, pads: Sequence[int]) -> torch.Tensor:
    """(M, C*k*k) patches of NHWC ``t`` padded (top, bottom, left, right):
    one row per window, features (C, kh, kw) with the channel slowest (the
    order of ``lax.conv_general_dilated_patches``)."""
    top, bottom, left, right = pads
    tp = F.pad(t, (0, 0, left, right, top, bottom))
    win = tp.unfold(1, k, stride).unfold(2, k, stride)  # (B, Ho, Wo, C, kh, kw)
    return win.reshape(-1, t.shape[3] * k * k)


def patches_dw(x: torch.Tensor, dy: torch.Tensor, w_shape: Sequence[int], stride: int,
               transpose: bool) -> torch.Tensor:
    """dW (HWIO, float32 or wider) of the SAME conv (``transpose`` False) or the
    k=4 / stride-2 SAME conv-transpose of NHWC ``x`` whose output cotangent
    is ``dy``, as one float32 im2col product."""
    kh, kw, cin, cout = w_shape
    ROUTES["patches"] += 1
    acc = torch.promote_types(x.dtype, torch.float32)  # float64 stays float64
    x, dy = x.to(acc), dy.to(acc)
    if transpose:
        # Window u over the 1-padded dy covers dy[2u-1 .. 2u+2]; kernel
        # offset a meets window element 3 - a.
        p = _windows(dy, kh, stride, (1, 1, 1, 1))  # (B*H*W, Cout*16)
        dwt = p.T @ x.reshape(-1, cin)  # (Cout*16, Cin)
        return dwt.reshape(cout, kh, kw, cin).flip(1, 2).permute(1, 2, 3, 0)
    plo, phi, qlo, qhi = reference.same_pads(x.shape, w_shape, stride)
    p = _windows(x, kh, stride, (plo, phi, qlo, qhi))  # (B*Ho*Wo, Cin*kh*kw)
    dw = p.T @ dy.reshape(-1, cout)  # (Cin*kh*kw, Cout)
    return dw.reshape(cin, kh, kw, cout).permute(1, 2, 0, 3)


def _conv_dx(dy: torch.Tensor, w: torch.Tensor, x_shape, stride: int) -> torch.Tensor:
    """dx (NHWC) of the SAME conv: the transposed conv over the padded
    input's extent, cropped back."""
    kh, kw = w.shape[0], w.shape[1]
    h, wd = x_shape[1], x_shape[2]
    plo, phi, qlo, qhi = reference.same_pads(x_shape, w.shape, stride)
    ho, wo = dy.shape[1], dy.shape[2]
    extra = (h + plo + phi - ((ho - 1) * stride + kh), wd + qlo + qhi - ((wo - 1) * stride + kw))
    dxp = F.conv_transpose2d(dy.permute(0, 3, 1, 2), w.to(dy.dtype).permute(3, 2, 0, 1),
                             stride=stride, output_padding=extra)
    return dxp[:, :, plo:plo + h, qlo:qlo + wd].permute(0, 2, 3, 1).contiguous()


def _conv_transpose_dx(dy: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """dx (NHWC) of the k=4 / stride-2 SAME conv-transpose: the stride-2
    conv of dy with the same (flipped, (I, O, kh, kw)) kernel."""
    wt = w.to(dy.dtype).flip(0, 1).permute(2, 3, 0, 1)
    dx = F.conv2d(dy.permute(0, 3, 1, 2), wt, stride=2, padding=1)
    return dx.permute(0, 2, 3, 1).contiguous()


class _PatchesConvFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, stride: int, transpose: bool):
        ctx.stride, ctx.transpose = stride, transpose
        ctx.save_for_backward(x, w)
        if transpose:
            return reference.conv2d_transpose(x, w, stride=stride)
        return reference.conv2d(x, w, stride=stride)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if need_x:
            dx = (_conv_transpose_dx(dy, w) if ctx.transpose
                  else _conv_dx(dy, w, x.shape, ctx.stride))
        if need_w:
            dw = patches_dw(x, dy, w.shape, ctx.stride, ctx.transpose).to(w.dtype)
        return dx, dw, None, None


def conv2d_patches_wgrad(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """``reference.conv2d`` with the weight gradient as one im2col product."""
    return _PatchesConvFn.apply(x, w, stride, False)


def conv2d_transpose_patches_wgrad(x: torch.Tensor, w: torch.Tensor,
                                   stride: int = 2) -> torch.Tensor:
    """``reference.conv2d_transpose`` (k=4 / stride 2) with the weight
    gradient as one dy-side im2col product."""
    if not reference.subpixel_deconv_supported(w.shape, stride):
        raise ValueError(f"conv2d_transpose supports k=4, stride=2 only, got "
                         f"k={tuple(w.shape[:2])}, stride={stride}")
    return _PatchesConvFn.apply(x, w, stride, True)
