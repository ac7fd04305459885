"""Plain PyTorch layer ops: the port of the JAX package's ``ops/xla.py`` (with
its two exact rewrites, :func:`conv2d_transpose_subpixel` and
:func:`conv2d_s2d`), and of ``ops/gn.py``'s closed-form GroupNorm+activation
backward (:func:`gn_act_grads`).

These are what runs on the CPU and the oracle the Hopper kernels are held
to. The layout at every function is the JAX package's: NHWC activations and
HWIO conv kernels. PyTorch's own convolutions want NCHW/OIHW, so each conv
permutes on the way in and out.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from action_conditioned_gans_tpu_torch.ops.common import (
    act_bwd,
    apply_act,
    resolve_groups,
    same_pad,
)
from action_conditioned_gans_tpu_torch.parallel import comm


def same_pads(x_shape, w_shape, stride: int) -> tuple:
    """The SAME pads (top, bottom, left, right) of an NHWC x HWIO conv."""
    _, plo, phi = same_pad(x_shape[1], w_shape[0], stride)
    _, qlo, qhi = same_pad(x_shape[2], w_shape[1], stride)
    return plo, phi, qlo, qhi


def pads_inside(x_shape, w_shape, stride: int) -> bool:
    """Whether :func:`conv2d` hands its SAME pad to the convolution itself:
    equal pads before and after on both axes. Else it writes the padded
    input out first."""
    plo, phi, qlo, qhi = same_pads(x_shape, w_shape, stride)
    return plo == phi and qlo == qhi


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1) -> torch.Tensor:
    """SAME conv, NHWC x HWIO -> NHWC. A symmetric pad is the convolution's
    own ``padding``, over the channels-last view of ``x`` (no padded copy,
    forward or backward); odd sizes pad more after than before, as XLA does,
    hence an explicit pad there."""
    plo, phi, qlo, qhi = same_pads(x.shape, w.shape, stride)
    xn = x.permute(0, 3, 1, 2)
    if (plo, qlo) != (phi, qhi):
        xn, plo, qlo = F.pad(xn, (qlo, qhi, plo, phi)), 0, 0
    y = F.conv2d(xn, w.to(x.dtype).permute(3, 2, 0, 1), stride=stride, padding=(plo, qlo))
    return y.permute(0, 2, 3, 1).contiguous()


def conv2d_transpose(x: torch.Tensor, w: torch.Tensor, *, stride: int = 2) -> torch.Tensor:
    """SAME conv-transpose as ``lax.conv_transpose`` computes it (no kernel
    transposition), for the k=4 / stride-2 geometry the models use.

    ``lax.conv_transpose`` convolves the stride-dilated input with ``w`` as
    given; ``F.conv_transpose2d`` flips the kernel, so it gets the kernel
    flipped in both spatial axes and laid out (I, O, kh, kw).
    """
    if stride != 2 or w.shape[0] != 4 or w.shape[1] != 4:
        raise ValueError(
            f"conv2d_transpose supports k=4, stride=2 only, got k={tuple(w.shape[:2])}, "
            f"stride={stride}"
        )
    wt = w.to(x.dtype).flip(0, 1).permute(2, 3, 0, 1)
    y = F.conv_transpose2d(x.permute(0, 3, 1, 2), wt, stride=2, padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def _conv_valid(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Stride-1 VALID conv, NHWC x HWIO -> NHWC (``w`` already in x's dtype)."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1).contiguous()


def _phase_kernels(w: torch.Tensor, dim: int) -> torch.Tensor:
    """The four 2x2 phase kernels ``w[r::2, c::2]`` of a 4x4 kernel, phase
    p = 2r + c, stacked along ``dim``."""
    return torch.cat([w[r::2, c::2] for r in range(2) for c in range(2)], dim=dim)


def subpixel_deconv_supported(w_shape, stride: int) -> bool:
    """The envelope of the exact subpixel decomposition: k=4 / stride 2
    (SAME, the only padding the port runs), the models' one conv-transpose
    geometry."""
    return len(w_shape) == 4 and stride == 2 and w_shape[0] == 4 and w_shape[1] == 4


def conv2d_transpose_subpixel(x: torch.Tensor, w: torch.Tensor, *, stride: int = 2) -> torch.Tensor:
    """:func:`conv2d_transpose` by the subpixel-phase decomposition
    (``ModelConfig.deconv="subpixel"``; the JAX package's ``ops/xla.py``).

    With ``x`` padded by 1, ``y[2a+r, 2b+c] = sum_{dy,dx in {0,1}}
    x_pad[a+dy+r, b+dx+c] @ w[2dy+r, 2dx+c]``: each output phase (r, c) is a
    stride-1 2x2 conv with the phase kernel ``w[r::2, c::2]``. The four
    phase kernels stacked on the output channels make the op ONE VALID 2x2
    conv to 4*Cout channels, then phase slices and depth-to-space. Plain
    differentiable ops. Off the k=4 / stride-2 envelope it is
    :func:`conv2d_transpose`, as in the reference."""
    if not subpixel_deconv_supported(w.shape, stride):
        return conv2d_transpose(x, w, stride=stride)
    b, h, w_, _ = x.shape
    cout = w.shape[3]
    z = _conv_valid(F.pad(x, (0, 0, 1, 1, 1, 1)), _phase_kernels(w.to(x.dtype), -1))
    phases = [z[:, r:r + h, c:c + w_, (2 * r + c) * cout:(2 * r + c + 1) * cout]
              for r in range(2) for c in range(2)]
    y = torch.stack(phases, dim=3).reshape(b, h, w_, 2, 2, cout)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(b, 2 * h, 2 * w_, cout)


def s2d_conv_supported(w_shape, stride: int) -> bool:
    """The envelope of the exact space-to-depth rewrite: k=4 / stride 2
    (SAME), the models' strided geometry; even spatial sizes are checked
    where it is called."""
    return len(w_shape) == 4 and stride == 2 and w_shape[0] == 4 and w_shape[1] == 4


def conv2d_s2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 2) -> torch.Tensor:
    """:func:`conv2d` by space-to-depth (``ModelConfig.conv0="s2d"``; the
    JAX package's ``ops/xla.py``).

    With ``x`` padded by 1 (SAME for k=4 / stride 2 / even sizes),
    ``y[i, j] = sum_{p,q} x_pad[2i+p, 2j+q] @ w[p, q]``; p = 2dp + r reads
    phase (r, c) of the space-to-depth input at offset (dp, dq): ONE
    stride-1 VALID 2x2 conv over the (H/2+1, W/2+1, 4*Cin) phase tensor with
    the phase kernels stacked on the input channels. Plain differentiable
    ops. Off the envelope, or for an odd size (SAME pads (1, 2) there), it
    is :func:`conv2d`, as in the reference."""
    if not s2d_conv_supported(w.shape, stride) or x.shape[1] % 2 or x.shape[2] % 2:
        return conv2d(x, w, stride=stride)
    b, h, w_, cin = x.shape
    h2, w2 = (h + 2) // 2, (w_ + 2) // 2
    xs = F.pad(x, (0, 0, 1, 1, 1, 1)).reshape(b, h2, 2, w2, 2, cin)
    xs = xs.permute(0, 1, 3, 2, 4, 5).reshape(b, h2, w2, 4 * cin)
    return _conv_valid(xs, _phase_kernels(w.to(x.dtype), 2))


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = x @ w.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


def leaky_relu(x: torch.Tensor, leak: float = 0.2) -> torch.Tensor:
    return torch.where(x >= 0, x, x * leak)


def norm_act(
    x: torch.Tensor,
    scale: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    *,
    kind: str = "group",
    groups: int = 32,
    eps: float = 1e-5,
    act: str = "lrelu",
    leak: float = 0.2,
    group=None,
) -> torch.Tensor:
    """Normalization + affine + activation over NHWC ``x``.

    Statistics in float32 (two-pass variance for "group"), the affine in
    float32, a cast back to ``x.dtype``, and only then the activation, in
    the JAX composite's order. For "batch", ``group`` (a process group)
    averages the moments over its ranks, differentiably, as the JAX
    composite ``pmean``s them under an ``axis_name``.
    """
    dtype = x.dtype
    xf = x.float()
    if kind == "group":
        n, h, w_, c = xf.shape
        g = resolve_groups(c, groups)
        xg = xf.reshape(n, h, w_, g, c // g)
        mean = xg.mean(dim=(1, 2, 4), keepdim=True)
        var = (xg - mean).square().mean(dim=(1, 2, 4), keepdim=True)
        y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(n, h, w_, c)
    elif kind == "batch":
        mean = xf.mean(dim=(0, 1, 2))
        mean_sq = xf.square().mean(dim=(0, 1, 2))
        if group is not None:
            mean, mean_sq = comm.all_reduce_mean(torch.stack([mean, mean_sq]), group).unbind(0)
        var = torch.clamp_min(mean_sq - mean.square(), 0.0)
        y = (xf - mean) * torch.rsqrt(var + eps)
    elif kind == "none":
        y = xf
    else:
        raise ValueError(f"unknown norm kind {kind!r}")
    if scale is not None:
        y = y * scale.float()
    if bias is not None:
        y = y + bias.float()
    return apply_act(y.to(dtype), act, leak)


def _group_mean(t: torch.Tensor, groups: int) -> torch.Tensor:
    """Per-(sample, group) mean of (N, H, W, C), broadcast to (N, 1, 1, C)."""
    n, h, w_, c = t.shape
    m = t.reshape(n, h, w_, groups, c // groups).mean(dim=(1, 2, 4), keepdim=True)
    return m.expand(n, 1, 1, groups, c // groups).reshape(n, 1, 1, c)


def gn_act_grads(
    y: torch.Tensor,
    scale: torch.Tensor,
    out: torch.Tensor,
    g: torch.Tensor,
    mean: Optional[torch.Tensor] = None,
    rstd: Optional[torch.Tensor] = None,
    *,
    groups: int,
    eps: float = 1e-5,
    act: str = "lrelu",
    leak: float = 0.2,
) -> tuple:
    """Closed-form (dy, dscale, dbias) of GroupNorm -> affine -> activation.

    ``y`` is the pre-norm input (N, H, W, C), ``out`` the block's output and
    ``g`` its cotangent. ``mean``/``rstd`` (N, groups) are the forward's
    statistics; when absent they are recomputed from ``y`` with the two-pass
    variance. Math in float32; ``dy`` is cast to ``y``'s dtype, ``dscale`` and
    ``dbias`` stay float32.

        xhat = (y - mean) * rstd      dpre = act'(out) * g
        dbias = sum dpre              dscale = sum dpre * xhat
        h = dpre * scale              dy = rstd * (h - mean_G(h) - xhat * mean_G(h * xhat))
    """
    n, hh, ww, c = y.shape
    groups = resolve_groups(c, groups)
    cg = c // groups
    yf = y.float()
    if mean is None or rstd is None:
        yg = yf.reshape(n, hh, ww, groups, cg)
        mean = yg.mean(dim=(1, 2, 4))
        var = (yg - mean[:, None, None, :, None]).square().mean(dim=(1, 2, 4))
        rstd = torch.rsqrt(var + eps)
    mean_c = mean.float().repeat_interleave(cg, dim=1).reshape(n, 1, 1, c)
    rstd_c = rstd.float().repeat_interleave(cg, dim=1).reshape(n, 1, 1, c)
    xhat = (yf - mean_c) * rstd_c
    dpre = act_bwd(g.float(), out.float(), act, leak)
    dbias = dpre.sum(dim=(0, 1, 2))
    dscale = (dpre * xhat).sum(dim=(0, 1, 2))
    h = dpre * scale.float()
    dy = rstd_c * (h - _group_mean(h, groups) - xhat * _group_mean(h * xhat, groups))
    return dy.to(y.dtype), dscale, dbias
