"""Conditional discriminator (port of the JAX ``Discriminator``).

The candidate next frame is concatenated channel-wise with the current frame
and the tiled action (and state), so D judges the transition. Then a stack of
k=4 / stride-2 conv blocks with leaky ReLU (``conv_0`` without norm, the rest
with the configured norm), ``d_extra_layers`` stride-1 blocks per scale, and a
flattened dense logit. ``conv_0`` takes ``ModelConfig.conv0``, every block
``wgrad``. Parameter names are the Flax ones: ``conv_{i}``,
``conv_{i}_extra_{j}``, ``logit_kernel`` (F, 1) and ``logit_bias`` (1,).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from action_conditioned_gans_tpu_torch import ops
from action_conditioned_gans_tpu_torch.config import ModelConfig
from action_conditioned_gans_tpu_torch.models.common import (
    ConvBlock,
    channels_at,
    flax_trunc_normal_,
    spectral_normalize,
    tile_condition,
)


class Discriminator(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        common = dict(groups=cfg.group_norm_groups, act="lrelu", leak=cfg.leak,
                      spectral_norm=cfg.d_spectral_norm, sn_iters=cfg.sn_iters,
                      wgrad=cfg.wgrad, generator=generator)
        ch = cfg.image_channels
        if cfg.d_condition_frame:
            ch += cfg.image_channels
        if cfg.d_condition_action:
            ch += cfg.cond_dim
        size = cfg.image_size
        for i in range(cfg.d_levels):
            out = channels_at(i, cfg.d_base_channels, cfg.d_max_channels)
            self.add_module(f"conv_{i}", ConvBlock(
                ch, out, kernel=4, stride=2, norm="none" if i == 0 else cfg.norm,
                conv=cfg.conv0 if i == 0 else "xla", **common))
            ch, size = out, -(-size // 2)
            for j in range(cfg.d_extra_layers):
                self.add_module(f"conv_{i}_extra_{j}", ConvBlock(
                    ch, ch, kernel=3, stride=1, norm=cfg.norm, **common))
        self.logit_kernel = nn.Parameter(
            flax_trunc_normal_(torch.empty(size * size * ch, 1), 0.02, generator)
        )
        self.logit_bias = nn.Parameter(torch.zeros(1))

    def forward(
        self,
        next_frame: torch.Tensor,
        frame: Optional[torch.Tensor] = None,
        action: Optional[torch.Tensor] = None,
        state: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """next_frame (B, H, W, C) candidate; frame, action, state the
        conditioning -> (B,) float32 logits."""
        cfg = self.cfg
        x = next_frame.to(cfg.dtype)
        parts = [x]
        if cfg.d_condition_frame:
            if frame is None:
                raise ValueError("d_condition_frame=True requires the current frame")
            parts.append(frame.to(cfg.dtype))
        if cfg.d_condition_action:
            if action is None:
                raise ValueError("d_condition_action=True requires the action")
            parts.append(tile_condition(action, state, x.shape[1], x.shape[2], dtype=cfg.dtype))
        x = torch.cat(parts, dim=-1) if len(parts) > 1 else x.contiguous()
        for block in self.children():
            x = block(x)
        w_out = self.logit_kernel
        if cfg.d_spectral_norm:
            w_out = spectral_normalize(w_out, cfg.sn_iters)
        logit = ops.dense(x.reshape(x.shape[0], -1), w_out, self.logit_bias)
        return logit[:, 0].float()
