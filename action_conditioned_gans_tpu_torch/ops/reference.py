"""Plain PyTorch layer ops: the port of the JAX package's ``ops/xla.py``, and
of ``ops/gn.py``'s closed-form GroupNorm+activation backward
(:func:`gn_act_grads`).

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


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1) -> torch.Tensor:
    """SAME conv, NHWC x HWIO -> NHWC. Odd sizes pad more after than before,
    as XLA does, hence the explicit pad."""
    kh, kw = w.shape[0], w.shape[1]
    _, plo, phi = same_pad(x.shape[1], kh, stride)
    _, qlo, qhi = same_pad(x.shape[2], kw, stride)
    xn = F.pad(x.permute(0, 3, 1, 2), (qlo, qhi, plo, phi))
    y = F.conv2d(xn, w.to(x.dtype).permute(3, 2, 0, 1), stride=stride)
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
) -> torch.Tensor:
    """Normalization + affine + activation over NHWC ``x``.

    Statistics in float32 (two-pass variance for "group"), the affine in
    float32, a cast back to ``x.dtype``, and only then the activation, in
    the JAX composite's order.
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
