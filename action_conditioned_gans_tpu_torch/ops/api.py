"""Layer ops the models call: the port of the JAX package's ``ops/api.py``.

The JAX package picks Pallas or XLA with a ``backend`` argument. Here the
tensor's device decides: a CUDA tensor goes to the Hopper kernel of the op
or the call raises; a CPU tensor takes the plain version. Nothing falls back
from a kernel to the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from action_conditioned_gans_tpu_torch.ops import reference
from action_conditioned_gans_tpu_torch.ops.kernels import conv as _conv


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A plain matrix product plus bias; the JAX package has no kernel for it."""
    return reference.dense(x, w, b)


def leaky_relu(x: torch.Tensor, leak: float = 0.2) -> torch.Tensor:
    return reference.leaky_relu(x, leak)


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
    if x.is_cuda and kind == "group":
        raise NotImplementedError(
            "standalone GroupNorm+activation on CUDA needs the port of the "
            "group_norm_act kernel (ops/pallas/norm_act.py), which is not ported yet"
        )
    return reference.norm_act(
        x, scale, bias, kind=kind, groups=groups, eps=eps, act=act, leak=leak
    )


def conv_norm_act(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    *,
    stride: int = 1,
    transpose: bool = False,
    kind: str = "group",
    groups: int = 32,
    eps: float = 1e-5,
    act: str = "lrelu",
    leak: float = 0.2,
) -> torch.Tensor:
    """The conv(-transpose) -> norm -> activation block of both models.

    When a gradient is needed the call goes through the autograd Functions
    of ``ops/kernels/conv.py`` (``ConvNormActFn``, ``ConvTransposeNormActFn``);
    otherwise straight to the kernel (CUDA) or the plain version (CPU)."""
    fn = _conv.conv_transpose_norm_act if transpose else _conv.conv_norm_act
    return fn(
        x, w, scale, bias, stride=stride, kind=kind, groups=groups, eps=eps, act=act, leak=leak
    )
