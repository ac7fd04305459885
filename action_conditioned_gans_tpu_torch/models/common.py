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


def flax_trunc_normal_(t: torch.Tensor, stddev: float, generator=None) -> torch.Tensor:
    """Fill ``t`` in place as Flax's ``truncated_normal(stddev)``: a unit
    normal cut at +-2, times ``stddev``."""
    return nn.init.trunc_normal_(t, std=stddev, a=-2 * stddev, b=2 * stddev, generator=generator)


def spectral_normalize(w: torch.Tensor, iters: int = 9) -> torch.Tensor:
    """``w`` divided by its largest singular value, estimated by ``iters``
    steps of power iteration (port of ``models/common.py``).

    Stateless: the iteration restarts every call from the same vector. A
    conv kernel (H, W, I, O) flattens to (H*W*I, O). u and v are detached,
    so the gradient takes the standard form d sigma / dW = u v^T.
    """
    shape = w.shape
    w2d = w.reshape(-1, shape[-1]).float()
    m = w2d.shape[0]
    eps = 1e-12
    with torch.no_grad():
        wd = w2d.detach()
        u = torch.full((m,), 1.0, device=w.device) / torch.sqrt(torch.tensor(float(m), device=w.device))
        for _ in range(iters):
            v = wd.T @ u
            v = v / (torch.linalg.vector_norm(v) + eps)
            u = wd @ v
            u = u / (torch.linalg.vector_norm(u) + eps)
    sigma = u @ (w2d @ v)
    return (w2d / (sigma + eps)).reshape(shape).to(w.dtype)


class ConvBlock(nn.Module):
    """conv (or conv-transpose) -> norm -> activation.

    Parameters carry the Flax names: ``kernel`` (HWIO), ``scale`` (absent
    when ``norm="none"``) and ``bias``. Initialisation follows Flax:
    ``truncated_normal(0.02)`` kernels, unit scales, zero biases. With
    ``spectral_norm`` the kernel is divided by its spectral norm at every
    call (:func:`spectral_normalize`). ``wgrad``, ``deconv`` and ``conv``
    are the layer's engines (``ops/api.py``), as the reference's
    ``ConvBlock`` carries them: the models set ``conv`` to
    ``ModelConfig.conv0`` on their level-0 convs only.
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
        spectral_norm: bool = False,
        sn_iters: int = 9,
        wgrad: str = "xla",
        deconv: str = "xla",
        conv: str = "xla",
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.stride, self.norm, self.groups = stride, norm, groups
        self.act, self.leak, self.transpose = act, leak, transpose
        self.spectral_norm, self.sn_iters = spectral_norm, sn_iters
        self.wgrad, self.deconv, self.conv = wgrad, deconv, conv
        w = torch.empty(kernel, kernel, in_features, features)
        self.kernel = nn.Parameter(flax_trunc_normal_(w, 0.02, generator))
        self.scale = nn.Parameter(torch.ones(features)) if norm != "none" else None
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = spectral_normalize(self.kernel, self.sn_iters) if self.spectral_norm else self.kernel
        return ops.conv_norm_act(
            x,
            w,
            self.scale,
            self.bias,
            stride=self.stride,
            transpose=self.transpose,
            kind=self.norm,
            groups=self.groups,
            act=self.act,
            leak=self.leak,
            wgrad=self.wgrad,
            deconv=self.deconv,
            conv=self.conv,
        )
