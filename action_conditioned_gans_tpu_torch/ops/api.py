"""Layer ops the models call: the port of the JAX package's ``ops/api.py`` as
it runs with ``backend="pallas"``, with its engine knobs.

Each conv block is routed as the reference routes it (``ops/envelope.py``):
"fused" layers run one fused conv kernel; "split" layers run the conv and
then :func:`norm_act`, whose GroupNorm goes to the standalone
GroupNorm+activation kernel. The split route's conv is the reference's
Pallas ``conv2d`` / ``conv2d_transpose``: where the bare conv fits the
kernel's envelope it runs kernel 1 or 2 with ``kind="none"``, ``act="none"``
and no bias ("bare"; only batch-norm layers reach it, since a GroupNorm or
norm-free layer whose conv fits is fused); otherwise the plain conv (cuDNN
on the card, XLA in the reference, outside any kernel of either) with the
layer's engines: ``conv="s2d"`` (the models' level-0 convs), ``deconv=
"subpixel"`` and ``wgrad="patches"`` (``ops/wgrad.py``). A fused or bare
conv already embodies what ``conv`` / ``deconv`` ask for (kernel 1 rewrites
stride 2 by space-to-depth, kernel 2 computes the four subpixel phases), and
its backward takes ``wgrad``. The route depends on shapes and dtype only, so
it is the same on the CPU and on the card.

:func:`batch_stats_group` syncs batch statistics: inside it, every
``kind="batch"`` layer averages its moments over a process group's ranks
(the JAX ``lax.pmean`` under an ``axis_name``), differentiably; the
data-parallel step sets it. GroupNorm's statistics are per sample and need
no sync.

:func:`model_group` shards channels: inside it, every conv block whose
kernel the model axis shards (``parallel.tp.tp_param_spec``) runs its conv,
norm and activation on its own output channels, as a layer of the shard's
width, and gathers them over the group (``models/common.py``). The blocks
call the ops below on their shards, so each shard is routed as this module
routes a layer of its width.

:func:`plain_route` is the route of the R1 penalty's inner D call: every
conv block and :func:`norm_act` inside it runs the plain ops of
``ops/reference.py`` (with the layer's engines) on every device, which
autograd can differentiate twice. The step picks it by config; nothing
falls back to it.

``ROUTES`` counts the routes taken: "fused" and "split" per conv block
outside the plain route, "bare" per split conv on kernel 1 or 2, "plain"
per conv block on the plain route, "group_plain" per GroupNorm that
:func:`norm_act` sends to the plain composite because it lies off the
standalone kernel's envelope, "s2d" and "subpixel" per conv rewritten by
its engine, "patches" per im2col weight gradient computed, and "pad_copy"
per split conv whose plain conv still writes out its padded input (an odd
size, which SAME pads more after than before; a symmetric pad is the
convolution's own, ``reference.conv2d``).

The tensor's device decides the rest: a CUDA tensor goes to the Hopper
kernel of the op or the call raises; a CPU tensor takes the plain version.
Nothing falls back from a kernel to the plain version.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from action_conditioned_gans_tpu_torch.ops import envelope, reference
from action_conditioned_gans_tpu_torch.ops import wgrad as _wgrad
from action_conditioned_gans_tpu_torch.ops.common import ROUTES
from action_conditioned_gans_tpu_torch.ops.kernels import conv as _conv
from action_conditioned_gans_tpu_torch.ops.kernels import norm_act as _norm_act

_PLAIN = [False]  # inside plain_route()
_BATCH_GROUP = [None]  # the process group of batch_stats_group()
_MODEL_GROUP = [None]  # the process group of model_group()


def reset_routes() -> None:
    for name in ROUTES:
        ROUTES[name] = 0


@contextlib.contextmanager
def plain_route():
    """Every conv block and :func:`norm_act` called inside runs the plain ops
    (the reference's XLA backend, on which it runs R1)."""
    outer, _PLAIN[0] = _PLAIN[0], True
    try:
        yield
    finally:
        _PLAIN[0] = outer


@contextlib.contextmanager
def batch_stats_group(group):
    """Batch-norm layers called inside average their moments over ``group``
    (nothing changes when it is None)."""
    outer, _BATCH_GROUP[0] = _BATCH_GROUP[0], group
    try:
        yield
    finally:
        _BATCH_GROUP[0] = outer


@contextlib.contextmanager
def model_group(group):
    """Conv blocks called inside run on their channel shard over ``group``,
    the ranks of one data index (nothing changes when it is None)."""
    outer, _MODEL_GROUP[0] = _MODEL_GROUP[0], group
    try:
        yield
    finally:
        _MODEL_GROUP[0] = outer


def current_model_group():
    """The process group of the enclosing :func:`model_group`, or None."""
    return _MODEL_GROUP[0]


def _stats_group(kind: str):
    return _BATCH_GROUP[0] if kind == "batch" else None


def dense(x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A plain matrix product plus bias; the JAX package has no kernel for it."""
    return reference.dense(x, w, b)


def leaky_relu(x: torch.Tensor, leak: float = 0.2) -> torch.Tensor:
    return reference.leaky_relu(x, leak)


def conv2d(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1, wgrad: str = "xla",
           conv: str = "xla") -> torch.Tensor:
    """The plain SAME conv (the reference's XLA conv) with the layer's
    engines: the space-to-depth rewrite where ``conv="s2d"`` applies, else
    the plain conv, with the im2col weight gradient for ``wgrad="patches"``."""
    if conv == "s2d" and reference.s2d_conv_supported(w.shape, stride) and not (
            x.shape[1] % 2 or x.shape[2] % 2):
        ROUTES["s2d"] += 1
        return reference.conv2d_s2d(x, w, stride=stride)
    if wgrad == "patches":
        return _wgrad.conv2d_patches_wgrad(x, w, stride)
    return reference.conv2d(x, w, stride=stride)


def conv2d_transpose(x: torch.Tensor, w: torch.Tensor, *, stride: int = 2, wgrad: str = "xla",
                     deconv: str = "xla") -> torch.Tensor:
    """The plain SAME conv-transpose (k=4, stride 2) with the layer's
    engines: the subpixel decomposition for ``deconv="subpixel"``, else the
    plain conv-transpose, with the im2col weight gradient for
    ``wgrad="patches"``."""
    if deconv == "subpixel" and reference.subpixel_deconv_supported(w.shape, stride):
        ROUTES["subpixel"] += 1
        return reference.conv2d_transpose_subpixel(x, w, stride=stride)
    if wgrad == "patches":
        return _wgrad.conv2d_transpose_patches_wgrad(x, w, stride)
    return reference.conv2d_transpose(x, w, stride=stride)


def _plain_conv(x, w, stride, transpose, wgrad, deconv, conv):
    if transpose:
        return conv2d_transpose(x, w, stride=stride, wgrad=wgrad, deconv=deconv)
    return conv2d(x, w, stride=stride, wgrad=wgrad, conv=conv)


def _split_conv(x, w, stride, transpose, wgrad, deconv, conv):
    """A split layer's conv: the reference's Pallas ``conv2d`` /
    ``conv2d_transpose`` (``ops/pallas/conv.py``), kernel 1 or 2 as a bare
    conv where it fits the envelope at the input's itemsize, else the plain
    conv with the layer's engines."""
    fits = (envelope.conv_transpose_norm_act_supported if transpose
            else envelope.conv_norm_act_supported)
    if fits(x.shape, w.shape, stride, "none", x.dtype):
        ROUTES["bare"] += 1
        fn = _conv.conv_transpose_norm_act if transpose else _conv.conv_norm_act
        return fn(x, w, None, None, stride=stride, kind="none", groups=1, act="none", wgrad=wgrad)
    if not transpose and not reference.pads_inside(x.shape, w.shape, stride):
        ROUTES["pad_copy"] += 1
    return _plain_conv(x, w, stride, transpose, wgrad, deconv, conv)


def conv_alone(x: torch.Tensor, w: torch.Tensor, *, stride: int = 1, transpose: bool = False,
               wgrad: str = "xla", deconv: str = "xla", conv: str = "xla") -> torch.Tensor:
    """A conv block's conv alone, as its split route runs it (kernel 1 or 2
    bare where the conv fits, else the plain conv with the layer's engines),
    or the plain conv inside :func:`plain_route`; counted as the block's
    route ("split" or "plain"). A channel shard whose GroupNorm groups span
    shards runs this, gathers, and normalises the whole layer with
    :func:`norm_act`."""
    if _PLAIN[0]:
        ROUTES["plain"] += 1
        return _plain_conv(x, w, stride, transpose, wgrad, deconv, conv)
    ROUTES["split"] += 1
    return _split_conv(x, w, stride, transpose, wgrad, deconv, conv)


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
    kernel computes in the reference either; "batch" averages its moments
    over the ranks inside :func:`batch_stats_group`.

    A GroupNorm off that envelope (fewer than 32 channels, or one sample's
    float32 plane, twice, past 10 MiB) is ``reference.norm_act`` on every
    device, counted in ``ROUTES["group_plain"]``. That is the route the
    reference takes there (its XLA composite: float32 statistics, the affine,
    the cast to the compute dtype, then the activation). It is not a fallback
    from a kernel: the reference runs no kernel for these calls either.
    Inside :func:`plain_route` every kind is the plain composite."""
    if kind == "group" and not _PLAIN[0]:
        if envelope.group_norm_act_supported(x.shape):
            return _norm_act.group_norm_act(x, scale, bias, groups=groups, eps=eps, act=act,
                                            leak=leak)
        ROUTES["group_plain"] += 1
    return reference.norm_act(
        x, scale, bias, kind=kind, groups=groups, eps=eps, act=act, leak=leak,
        group=_stats_group(kind)
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
    wgrad: str = "xla",
    deconv: str = "xla",
    conv: str = "xla",
) -> torch.Tensor:
    """The conv(-transpose) -> norm -> activation block of both models.

    On the fused route the call goes to ``ops/kernels/conv.py`` (through its
    autograd Functions when a gradient is needed); on the split route to
    :func:`_split_conv` and then :func:`norm_act`; inside
    :func:`plain_route` to the plain conv with the layer's engines and
    ``reference.norm_act``."""
    norm = dict(kind=kind, groups=groups, eps=eps, act=act, leak=leak)
    if _PLAIN[0]:
        ROUTES["plain"] += 1
        y = _plain_conv(x, w, stride, transpose, wgrad, deconv, conv)
        return reference.norm_act(y, scale, bias, group=_stats_group(kind), **norm)
    route = envelope.route(x.shape, w.shape, stride, transpose, kind, groups, x.dtype)
    ROUTES[route] += 1
    if route == "fused":
        fn = _conv.conv_transpose_norm_act if transpose else _conv.conv_norm_act
        return fn(x, w, scale, bias, stride=stride, wgrad=wgrad, **norm)
    y = _split_conv(x, w, stride, transpose, wgrad, deconv, conv)
    return norm_act(y, scale, bias, **norm)
