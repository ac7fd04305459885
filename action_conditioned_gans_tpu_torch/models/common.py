"""Shared model building blocks (port of the JAX package's ``models/common.py``)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
from torch import nn

from action_conditioned_gans_tpu_torch import ops
from action_conditioned_gans_tpu_torch.ops import api
from action_conditioned_gans_tpu_torch.ops.common import resolve_groups
from action_conditioned_gans_tpu_torch.parallel import comm
from action_conditioned_gans_tpu_torch.parallel.tp import tp_param_spec


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


def spectral_normalize(w: torch.Tensor, iters: int = 9, group=None) -> torch.Tensor:
    """``w`` divided by its largest singular value, estimated by ``iters``
    steps of power iteration (port of ``models/common.py``).

    Stateless: the iteration restarts every call from the same vector. A
    conv kernel (H, W, I, O) flattens to (H*W*I, O). u and v are detached,
    so the gradient takes the standard form d sigma / dW = u v^T.

    With ``group`` (a model group), ``w`` is this rank's shard of the
    output channels and sigma is the whole kernel's: the iteration runs on
    the gathered kernel, and sigma = u W v sums the shards' parts over the
    group (``comm.all_reduce_sum``, whose backward sums each rank's use).
    """
    shape = w.shape
    w2d = w.reshape(-1, shape[-1]).float()
    m = w2d.shape[0]
    eps = 1e-12
    with torch.no_grad():
        wd = w2d.detach()
        if group is not None:
            wd = comm.gather_from_model(wd, group)
        u = torch.full((m,), 1.0, device=w.device) / torch.sqrt(torch.tensor(float(m), device=w.device))
        for _ in range(iters):
            v = wd.T @ u
            v = v / (torch.linalg.vector_norm(v) + eps)
            u = wd @ v
            u = u / (torch.linalg.vector_norm(u) + eps)
        if group is not None:
            v = v.chunk(dist.get_world_size(group))[dist.get_rank(group)]
    sigma = u @ (w2d @ v)
    if group is not None:
        sigma = comm.all_reduce_sum(sigma, group)
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

    Channel tensor parallelism: inside ``ops.api.model_group`` a block whose
    kernel the model axis shards (``parallel.tp.tp_param_spec`` of its full
    shape, ``kernel_shape``) holds its shard of the kernel, scale and bias
    (given through ``functional_call``), runs the conv, norm and activation
    on the full input and its output channels, with its whole GroupNorm
    groups (the layer's resolved groups over the axis), and gathers the
    channels (``parallel/comm.py``). Where the axis does not divide the
    layer's groups, a group spans shards: the block gathers its conv's
    output and normalises the whole layer instead (the same function). Batch
    norm's per-channel moments are the shard's own. A spectral norm takes
    the whole kernel's sigma. ``columns``, set by ``infer.Predictor`` on a
    (data, model) grid of devices, holds each model column's (device,
    kernel, scale, bias) shard: the block runs each on its device and
    concatenates them where its input lies. Blocks that the axis does not
    shard run whole.
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
        self.kernel_shape = (kernel, kernel, in_features, features)
        self.columns = None
        self.stride, self.norm, self.groups = stride, norm, groups
        self.act, self.leak, self.transpose = act, leak, transpose
        self.spectral_norm, self.sn_iters = spectral_norm, sn_iters
        self.wgrad, self.deconv, self.conv = wgrad, deconv, conv
        w = torch.empty(kernel, kernel, in_features, features)
        self.kernel = nn.Parameter(flax_trunc_normal_(w, 0.02, generator))
        self.scale = nn.Parameter(torch.ones(features)) if norm != "none" else None
        self.bias = nn.Parameter(torch.zeros(features))

    def _block(self, x, w, scale, bias, groups):
        """conv -> norm -> activation with the given weights and groups."""
        return ops.conv_norm_act(
            x, w, scale, bias, stride=self.stride, transpose=self.transpose, kind=self.norm,
            groups=groups, act=self.act, leak=self.leak, wgrad=self.wgrad,
            deconv=self.deconv, conv=self.conv)

    def _conv_alone(self, x, w):
        return api.conv_alone(x, w, stride=self.stride, transpose=self.transpose,
                              wgrad=self.wgrad, deconv=self.deconv, conv=self.conv)

    def _norm_whole(self, y, scale, bias):
        return ops.norm_act(y, scale, bias, kind=self.norm, groups=self.groups, act=self.act,
                            leak=self.leak)

    def _shard_groups(self, size: int) -> Optional[int]:
        """A shard's GroupNorm groups on a model axis of ``size``, or None
        where the layer's groups span shards."""
        if self.norm != "group":
            return self.groups
        g = resolve_groups(self.kernel_shape[-1], self.groups)
        return g // size if g % size == 0 else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = api.current_model_group()
        size = (len(self.columns) if self.columns is not None
                else dist.get_world_size(group) if group is not None else 1)
        if tp_param_spec(self.kernel_shape, size) is None:
            w = (spectral_normalize(self.kernel, self.sn_iters) if self.spectral_norm
                 else self.kernel)
            return self._block(x, w, self.scale, self.bias, self.groups)
        groups = self._shard_groups(size)
        if self.columns is not None:
            # One data row of a serving grid: each column's shard on its device.
            outs = [self._block(x.to(dev), w, s, b, groups) if groups is not None
                    else self._conv_alone(x.to(dev), w) for dev, w, s, b in self.columns]
            y = torch.cat([o.to(x.device) for o in outs], dim=-1)
            if groups is not None:
                return y
            whole = [torch.cat([c[i].to(x.device) for c in self.columns]) for i in (2, 3)]
            return self._norm_whole(y, *whole)
        x = comm.copy_to_model(x, group)
        w = (spectral_normalize(self.kernel, self.sn_iters, group) if self.spectral_norm
             else self.kernel)
        if groups is not None:
            return comm.gather_from_model(self._block(x, w, self.scale, self.bias, groups), group)
        y = comm.gather_from_model(self._conv_alone(x, w), group)
        return self._norm_whole(y, comm.gather_from_model(self.scale, group),
                                comm.gather_from_model(self.bias, group))
