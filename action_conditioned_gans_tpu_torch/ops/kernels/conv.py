"""Wrappers of the fused conv and conv-transpose Hopper kernels.

Port of the JAX package's ``ops/pallas/conv.py`` forward:

* :func:`conv_norm_act` (``csrc/conv_norm_act.cu``): SAME conv ->
  GroupNorm or bias only -> affine -> activation.
* :func:`conv_transpose_norm_act` (``csrc/conv_transpose_norm_act.cu``):
  k=4 / stride-2 SAME conv-transpose -> the same epilogue.

For a CUDA tensor each wrapper launches its kernel or raises; for a CPU
tensor it computes the plain version beside it (``*_plain``: the conv of
``ops/reference.py`` plus ``norm_act``). ``LAUNCHES`` counts kernel launches,
one per wrapper call that reached the kernel. The kernels have no backward
yet, so a call that would need a gradient raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from action_conditioned_gans_tpu_torch.ops import reference
from action_conditioned_gans_tpu_torch.ops.common import ACTIVATIONS, resolve_groups, same_pad
from action_conditioned_gans_tpu_torch.ops.kernels import build

LAUNCHES = {"conv_norm_act": 0, "conv_transpose_norm_act": 0}
_KINDS = ("group", "none")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def conv_norm_act_plain(
    x, w, scale, bias, *, stride=1, kind="group", groups=32, eps=1e-5, act="lrelu", leak=0.2
) -> torch.Tensor:
    return reference.norm_act(
        reference.conv2d(x, w, stride=stride),
        scale if kind != "none" else None,
        bias,
        kind=kind, groups=groups, eps=eps, act=act, leak=leak,
    )


def conv_transpose_norm_act_plain(
    x, w, scale, bias, *, stride=2, kind="group", groups=32, eps=1e-5, act="relu", leak=0.2
) -> torch.Tensor:
    return reference.norm_act(
        reference.conv2d_transpose(x, w, stride=stride),
        scale if kind != "none" else None,
        bias,
        kind=kind, groups=groups, eps=eps, act=act, leak=leak,
    )


def _check_common(name, x, w, scale, bias, kind, act) -> None:
    if kind not in _KINDS:
        raise ValueError(f"{name}: the kernel takes kind in {_KINDS}, got {kind!r}")
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name}: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4 or w.dim() != 4 or w.shape[2] != x.shape[3]:
        raise ValueError(
            f"{name}: want x (B, H, W, Cin) and w (kh, kw, Cin, Cout), got "
            f"{tuple(x.shape)} and {tuple(w.shape)}"
        )
    for t in (x, w, scale, bias):
        if t is None:
            continue
        if t.device != x.device:
            raise ValueError(f"{name}: all tensors must be on {x.device}, one is on {t.device}")
        if torch.is_grad_enabled() and t.requires_grad:
            raise NotImplementedError(
                f"{name}: the Hopper kernel has no backward yet; call it under "
                "torch.no_grad() or torch.inference_mode()"
            )
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous NHWC")
    cout = w.shape[3]
    for label, t in (("scale", scale), ("bias", bias)):
        if t is not None and tuple(t.shape) != (cout,):
            raise ValueError(f"{name}: {label} must have shape ({cout},), got {tuple(t.shape)}")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _epilogue_operands(x, w, scale, bias, kind, groups, pixels, slots):
    """The weights in the compute dtype, the resolved group count, and the
    epilogue operands [scale, bias, y, psum, psq, stats] (None where the
    kind has no use for one). Scratch is allocated here with torch.empty:
    the kernels allocate nothing."""
    b, cout = x.shape[0], w.shape[3]
    dev = x.device
    wk = w.to(x.dtype).contiguous()
    bias_f = (bias if bias is not None else torch.zeros(cout, device=dev)).float().contiguous()
    if kind != "group":
        return wk, 1, [None, bias_f, None, None, None, None]
    g = resolve_groups(cout, groups)
    scale_f = (scale if scale is not None else torch.ones(cout, device=dev)).float().contiguous()
    y = torch.empty(b * pixels * cout, device=dev, dtype=torch.float32)
    psum = torch.empty(b * slots * cout, device=dev, dtype=torch.float32)
    psq = torch.empty_like(psum)
    stats = torch.empty(2 * b * g, device=dev, dtype=torch.float32)
    return wk, g, [scale_f, bias_f, y, psum, psq, stats]


def conv_norm_act(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    *,
    stride: int = 1,
    kind: str = "group",
    groups: int = 32,
    eps: float = 1e-5,
    act: str = "lrelu",
    leak: float = 0.2,
) -> torch.Tensor:
    """SAME conv (NHWC x HWIO) -> GroupNorm or bias -> affine -> activation."""
    if not x.is_cuda:
        return conv_norm_act_plain(
            x, w, scale, bias, stride=stride, kind=kind, groups=groups, eps=eps, act=act, leak=leak
        )
    _check_common("conv_norm_act", x, w, scale, bias, kind, act)
    kh, kw = w.shape[0], w.shape[1]
    if stride not in (1, 2) or kh != kw:
        raise ValueError(f"conv_norm_act: want a square kernel and stride 1 or 2, got {kh}x{kw}/{stride}")
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    oh, pad_h, _ = same_pad(h, kh, stride)
    ow, pad_w, _ = same_pad(wd, kw, stride)
    lib = build.load("conv_norm_act")
    slots = -(-(oh * ow) // lib.acg_tile_rows(_DTYPES[x.dtype], cout))
    wk, g, ops = _epilogue_operands(x, w, scale, bias, kind, groups, oh * ow, slots)
    out = torch.empty((b, oh, ow, cout), device=x.device, dtype=x.dtype)
    ptrs = [_ptr(t) for t in ops]
    rc = lib.acg_conv_norm_act(
        x.data_ptr(), wk.data_ptr(), ptrs[0], ptrs[1], out.data_ptr(), *ptrs[2:],
        _DTYPES[x.dtype], b, h, wd, cin, oh, ow, cout, kh, kw, stride, pad_h, pad_w,
        int(kind == "group"), g, float(eps), ACTIVATIONS.index(act), float(leak),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc:
        raise RuntimeError(f"conv_norm_act kernel launch failed: CUDA error {rc}")
    LAUNCHES["conv_norm_act"] += 1
    return out


def conv_transpose_norm_act(
    x: torch.Tensor,
    w: torch.Tensor,
    scale: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    *,
    stride: int = 2,
    kind: str = "group",
    groups: int = 32,
    eps: float = 1e-5,
    act: str = "relu",
    leak: float = 0.2,
) -> torch.Tensor:
    """k=4 / stride-2 SAME conv-transpose -> GroupNorm or bias -> affine -> act."""
    if not x.is_cuda:
        return conv_transpose_norm_act_plain(
            x, w, scale, bias, stride=stride, kind=kind, groups=groups, eps=eps, act=act, leak=leak
        )
    _check_common("conv_transpose_norm_act", x, w, scale, bias, kind, act)
    if stride != 2 or w.shape[0] != 4 or w.shape[1] != 4:
        raise ValueError(
            f"conv_transpose_norm_act: the kernel takes k=4, stride=2, got "
            f"k={tuple(w.shape[:2])}, stride={stride}"
        )
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    lib = build.load("conv_transpose_norm_act")
    slots = 4 * -(-(h * wd) // lib.acg_tile_rows(_DTYPES[x.dtype], cout))
    wk, g, ops = _epilogue_operands(x, w, scale, bias, kind, groups, 4 * h * wd, slots)
    out = torch.empty((b, 2 * h, 2 * wd, cout), device=x.device, dtype=x.dtype)
    ptrs = [_ptr(t) for t in ops]
    rc = lib.acg_conv_transpose_norm_act(
        x.data_ptr(), wk.data_ptr(), ptrs[0], ptrs[1], out.data_ptr(), *ptrs[2:],
        _DTYPES[x.dtype], b, h, wd, cin, cout,
        int(kind == "group"), g, float(eps), ACTIVATIONS.index(act), float(leak),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc:
        raise RuntimeError(f"conv_transpose_norm_act kernel launch failed: CUDA error {rc}")
    LAUNCHES["conv_transpose_norm_act"] += 1
    return out
