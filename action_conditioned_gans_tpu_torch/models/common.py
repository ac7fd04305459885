"""Shared model building blocks (port of the JAX package's ``models/common.py``)."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from action_conditioned_gans_tpu_torch import ops


def tile_condition(
    action: torch.Tensor,
    state: Optional[torch.Tensor],
    height: int,
    width: int,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Broadcast the action (and state) vector over an (B, H, W, A[+S]) map."""
    cond = action if state is None else torch.cat([action, state], dim=-1)
    cond = cond.to(dtype)
    b, a = cond.shape
    return cond[:, None, None, :].expand(b, height, width, a)


def channels_at(level: int, base: int, cap: int) -> int:
    return min(base * (2**level), cap)


class ConvBlock(nn.Module):
    """conv (or conv-transpose) -> norm -> activation.

    Parameters carry the Flax names: ``kernel`` (HWIO), ``scale`` (absent
    when ``norm="none"``) and ``bias``. Initialisation follows Flax:
    truncated normal (+-2 sigma) with sigma 0.02, unit scales, zero biases.
    """

    def __init__(
        self,
        in_features: int,
        features: int,
        *,
        kernel: int = 4,
        stride: int = 2,
        norm: str = "group",
        groups: int = 32,
        act: str = "lrelu",
        leak: float = 0.2,
        transpose: bool = False,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.stride, self.norm, self.groups = stride, norm, groups
        self.act, self.leak, self.transpose = act, leak, transpose
        w = torch.empty(kernel, kernel, in_features, features)
        nn.init.trunc_normal_(w, std=0.02, a=-0.04, b=0.04, generator=generator)
        self.kernel = nn.Parameter(w)
        self.scale = nn.Parameter(torch.ones(features)) if norm != "none" else None
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.conv_norm_act(
            x,
            self.kernel,
            self.scale,
            self.bias,
            stride=self.stride,
            transpose=self.transpose,
            kind=self.norm,
            groups=self.groups,
            act=self.act,
            leak=self.leak,
        )
