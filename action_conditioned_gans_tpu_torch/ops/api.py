"""Layer ops the models call: the port of the JAX package's ``ops/api.py`` as
it runs with ``backend="pallas"``.

Each conv block is routed as the reference routes it (``ops/envelope.py``):
"fused" layers run one fused conv kernel; "split" layers run the plain conv
(cuDNN on the card, XLA in the reference, outside any kernel of either) and
then :func:`norm_act`, whose GroupNorm goes to the standalone
GroupNorm+activation kernel. The route depends on shapes and dtype only, so
it is the same on the CPU and on the card. ``ROUTES`` counts the routes
taken: "fused" and "split" per conv block, and "group_plain" per GroupNorm
that :func:`norm_act` sends to the plain composite because it lies off the
standalone kernel's envelope.

The tensor's device decides the rest: a CUDA tensor goes to the Hopper
kernel of the op or the call raises; a CPU tensor takes the plain version.
Nothing falls back from a kernel to the plain version.
"""

from __future__ import annotations

from typing import Optional

import torch

from action_conditioned_gans_tpu_torch.ops import envelope, reference
from action_conditioned_gans_tpu_torch.ops.kernels import conv as _conv
from action_conditioned_gans_tpu_torch.ops.kernels import norm_act as _norm_act

ROUTES = {"fused": 0, "split": 0, "group_plain": 0}


def reset_routes() -> None:
    for name in ROUTES:
        ROUTES[name] = 0


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A plain matrix product plus bias; the JAX package has no kernel for it."""
    return reference.dense(x, w, b)


def leaky_relu(x: torch.Tensor, leak: float = 0.2) -> torch.Tensor:
    return reference.leaky_relu(x, leak)


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1) -> torch.Tensor:
    """The plain SAME conv (the reference's XLA conv off the fused envelope)."""
    return reference.conv2d(x, w, stride=stride)


def conv2d_transpose(x: torch.Tensor, w: torch.Tensor, *, stride: int = 2) -> torch.Tensor:
    """The plain SAME conv-transpose (k=4, stride 2)."""
    return reference.conv2d_transpose(x, w, stride=stride)


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
    """Normalization + affine + activation. GroupNorm inside the reference's
    kernel envelope goes to the GroupNorm+activation kernel; kinds "none"
    (bias, cast, activation) and "batch" are the plain composite, which no
    kernel computes in the reference either.

    A GroupNorm off that envelope (fewer than 32 channels, or one sample's
    float32 plane, twice, past 10 MiB) is ``reference.norm_act`` on every
    device, counted in ``ROUTES["group_plain"]``. That is the route the
    reference takes there (its XLA composite: float32 statistics, the affine,
    the cast to the compute dtype, then the activation). It is not a fallback
    from a kernel: the reference runs no kernel for these calls either."""
    if kind == "group":
        if envelope.group_norm_act_supported(x.shape):
            return _norm_act.group_norm_act(x, scale, bias, groups=groups, eps=eps, act=act,
                                            leak=leak)
        ROUTES["group_plain"] += 1
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

    On the fused route the call goes to ``ops/kernels/conv.py`` (through its
    autograd Functions when a gradient is needed); on the split route to
    :func:`conv2d` / :func:`conv2d_transpose` and then :func:`norm_act`."""
    route = envelope.route(x.shape, w.shape, stride, transpose, kind, groups, x.dtype)
    ROUTES[route] += 1
    if route == "fused":
        fn = _conv.conv_transpose_norm_act if transpose else _conv.conv_norm_act
        return fn(
            x, w, scale, bias, stride=stride, kind=kind, groups=groups, eps=eps, act=act, leak=leak
        )
    y = (conv2d_transpose if transpose else conv2d)(x, w, stride=stride)
    return norm_act(y, scale, bias, kind=kind, groups=groups, eps=eps, act=act, leak=leak)
