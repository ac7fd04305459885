"""Action-conditioned next-frame generator (port of the JAX ``Generator``).

conv encoder (stride-2 stages) -> action (and state) tiled over the
bottleneck and concatenated -> 3x3 conv -> conv-transpose decoder -> tanh
frame in [-1, 1]. Every layer is one conv -> norm -> activation block; the
level-0 encoder conv takes ``ModelConfig.conv0``, every block ``wgrad`` and
``deconv`` (only the decoder's conv-transposes use the latter).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from action_conditioned_gans_tpu_torch.config import ModelConfig
from action_conditioned_gans_tpu_torch.models.common import ConvBlock, channels_at, tile_condition


class Generator(nn.Module):
    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg

        def block(name, in_ch, **kw):
            kw.setdefault("norm", cfg.norm)
            kw.setdefault("wgrad", cfg.wgrad)
            kw.setdefault("deconv", cfg.deconv)
            kw.setdefault("groups", cfg.group_norm_groups)
            kw.setdefault("leak", cfg.leak)
            self.add_module(name, ConvBlock(in_ch, generator=generator, **kw))

        ch = cfg.image_channels
        for i in range(cfg.g_levels):
            out = channels_at(i, cfg.g_base_channels, cfg.g_max_channels)
            block(f"enc_{i}", ch, features=out, kernel=4, stride=2,
                  norm="none" if i == 0 else cfg.norm, act="lrelu",
                  conv=cfg.conv0 if i == 0 else "xla")
            ch = out
        bott = channels_at(cfg.g_levels - 1, cfg.g_base_channels, cfg.g_max_channels)
        block("bottleneck", ch + cfg.cond_dim, features=bott, kernel=3, stride=1, act="relu")
        ch = bott
        for i in reversed(range(cfg.g_levels)):
            if cfg.skip_connections:
                ch += channels_at(i, cfg.g_base_channels, cfg.g_max_channels)
            last = i == 0
            out = (
                cfg.image_channels
                if last
                else channels_at(i - 1, cfg.g_base_channels, cfg.g_max_channels)
            )
            block(f"dec_{i}", ch, features=out, kernel=4, stride=2, transpose=True,
                  norm="none" if last else cfg.norm, act="tanh" if last else "relu")
            ch = out

    def forward(
        self,
        frame: torch.Tensor,
        action: torch.Tensor,
        state: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """frame (B, H, W, C) in [-1, 1], action (B, A), state (B, S) or None
        -> next frame (B, H, W, C) in the compute dtype."""
        cfg = self.cfg
        if cfg.state_dim and state is None:
            raise ValueError("model config has state_dim > 0 but no state was passed")
        x = frame.to(cfg.dtype).contiguous()  # a time-chunk view of the fold may not be
        skips = []
        for i in range(cfg.g_levels):
            x = getattr(self, f"enc_{i}")(x)
            skips.append(x)
        s = cfg.bottleneck_size
        cond = tile_condition(action, state, s, s, dtype=cfg.dtype)
        x = self.bottleneck(torch.cat([x, cond], dim=-1))
        for i in reversed(range(cfg.g_levels)):
            if cfg.skip_connections:
                x = torch.cat([x, skips[i]], dim=-1)
            x = getattr(self, f"dec_{i}")(x)
        return x
