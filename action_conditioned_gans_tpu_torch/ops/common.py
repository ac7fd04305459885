"""Helpers shared by the plain ops and the kernel wrappers.

Port of the JAX package's ``ops/pallas/common.py``: the activation table,
the GroupNorm group-count rule, and the per-(sample, group) GroupNorm that
the fused kernels compute in their epilogue; and of ``ops/gn.py``'s
``act_bwd``, the activation cotangent rebuilt from the saved output. Also
``ROUTES``, the route counts of ``ops/api.py`` (kept here so that
``ops/wgrad.py`` and the kernel wrappers count into it too), and
``conv_blocks``, the conv block calls they add up to.
"""

from __future__ import annotations

import torch

ACTIVATIONS = ("none", "lrelu", "relu", "tanh")

# The routes the layer ops took (``ops/api.py`` documents each key).
ROUTES = {"fused": 0, "split": 0, "group_plain": 0, "bare": 0, "plain": 0, "s2d": 0,
          "subpixel": 0, "patches": 0, "pad_copy": 0}


def conv_blocks() -> int:
    """The conv block calls so far: every one counts once in "fused",
    "split" or "plain"."""
    return ROUTES["fused"] + ROUTES["split"] + ROUTES["plain"]


def apply_act(y: torch.Tensor, act: str, leak: float) -> torch.Tensor:
    if act == "lrelu":
        return torch.where(y >= 0, y, y * leak)
    if act == "relu":
        return torch.clamp_min(y, 0.0)
    if act == "tanh":
        return torch.tanh(y)
    if act == "none":
        return y
    raise ValueError(f"unknown activation {act!r}")


def act_bwd(g: torch.Tensor, out: torch.Tensor, act: str, leak: float) -> torch.Tensor:
    """Cotangent through the activation, rebuilt from its OUTPUT.

    sign(out) == sign(pre) for lrelu with leak > 0; at leak 0 negatives
    collapse to out == 0, so the mask is strict, like relu's. tanh' is
    1 - out^2. A negative leak is not invertible from the output: refused.
    """
    if act == "lrelu":
        if leak < 0:
            raise ValueError(
                "the saved-output activation backward needs leak >= 0 (a negative-slope "
                "lrelu is not invertible from its output)"
            )
        if leak == 0:
            return torch.where(out > 0, g, torch.zeros_like(g))
        return torch.where(out >= 0, g, g * leak)
    if act == "relu":
        return torch.where(out > 0, g, torch.zeros_like(g))
    if act == "tanh":
        return g * (1.0 - out * out)
    if act == "none":
        return g
    raise ValueError(f"unknown activation {act!r}")


def resolve_groups(channels: int, groups: int) -> int:
    """The largest divisor of ``channels`` that is <= ``groups``."""
    g = min(groups, channels)
    while channels % g:
        g -= 1
    return g


def same_pad(size: int, k: int, stride: int) -> tuple:
    """SAME padding as XLA computes it: (output size, pad before, pad after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return out, total // 2, total - total // 2


def group_norm_rows(
    x2d: torch.Tensor,
    scale: torch.Tensor,
    bias: torch.Tensor,
    groups: int,
    eps: float,
    logical_channels: int = 0,
) -> torch.Tensor:
    """GroupNorm over one sample's (N, C) float32 block, then affine.

    The statistics are the kernels' own: ``E[x^2] - mean^2`` in float32,
    clamped at 0. ``logical_channels``: when C is a phase-tiled view of a
    smaller channel dim (four subpixel phases of a conv-transpose laid side
    by side), channels are grouped by ``ch % logical_channels``, so the
    statistics equal those of the depth-to-space result.
    """
    n, c = x2d.shape
    lc = logical_channels or c
    tile = c // lc
    cg = lc // groups
    x3 = x2d.float().reshape(n * tile, lc)
    s1 = x3.sum(0).reshape(groups, cg).sum(1)
    s2 = (x3 * x3).sum(0).reshape(groups, cg).sum(1)
    count = float(n * tile * cg)
    mean = s1 / count
    var = torch.clamp_min(s2 / count - mean * mean, 0.0)
    rstd = torch.rsqrt(var + eps)
    mean_c = mean.repeat_interleave(cg).repeat(tile)
    rstd_c = rstd.repeat_interleave(cg).repeat(tile)
    return (x2d.float() - mean_c) * rstd_c * scale.float() + bias.float()
