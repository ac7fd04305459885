"""Wrappers of the fused conv and conv-transpose Hopper kernels, with autograd.

Port of the JAX package's ``ops/pallas/conv.py``:

* :func:`conv_norm_act` (``csrc/conv_norm_act.cu``): SAME conv ->
  GroupNorm or bias only -> affine -> activation.
* :func:`conv_transpose_norm_act` (``csrc/conv_transpose_norm_act.cu``):
  k=4 / stride-2 SAME conv-transpose -> the same epilogue.

For a CUDA tensor each wrapper launches its kernel or raises; for a CPU
tensor it computes the plain version beside it (``*_plain``: the conv of
``ops/reference.py`` plus ``norm_act``). ``LAUNCHES`` counts kernel launches,
one per wrapper call that reached the kernel, and ``LAUNCHES_BY_MAINLOOP``
splits them by the mainloop the kernel's library chose, keyed
"kernel:mainloop" (``acg_conv_path``, ``acg_conv_transpose_path``): "wgmma"
for bfloat16 layers with Cin % 4 == 0 and Cout % 64 == 0, "narrow" for the
conv-transpose's bfloat16 layers with Cout <= 16 and no GroupNorm, "wmma" for
the other bfloat16 ones, "fma" for float32.

When a gradient is needed the call goes through :class:`ConvNormActFn` /
:class:`ConvTransposeNormActFn`, the port of the Pallas ops' custom VJPs.
Their forward keeps the kernel's pre-norm ``y`` (float32) and per-(sample,
group) (mean, rstd), which the serving path discards. Their backward never
re-runs the forward:

* kind "group": the GroupNorm+activation backward kernel
  (``ops/kernels/gn_bwd.py``) on (y, out, g, scale, mean, rstd);
* kind "none": ``act_bwd`` from the saved output and the bias sum, in plain
  ops;
* then dx and dw from ``aten.convolution_backward``, which runs only the
  backward-data / backward-weight convolutions (``jax.linear_transpose`` in
  the reference), honouring ``ctx.needs_input_grad``. With
  ``wgrad="patches"`` dw is instead the one im2col product of
  ``ops/wgrad.py``, so the knob means the same on every route.

The engine knobs ``deconv="subpixel"`` and ``conv0="s2d"`` need nothing
here: kernel 2 already computes a conv-transpose as its four subpixel phases
(the reference's ``ops/pallas/conv.py`` decomposition), and kernel 1 already
rewrites a stride-2 conv by space-to-depth (``envelope.conv_fits``), so a
fused layer computes what those knobs ask for.

On the CPU the same Functions run with the plain forward (``y`` in the
compute dtype, statistics recomputed in the backward, as the JAX VJP does).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from action_conditioned_gans_tpu_torch.ops import reference, wgrad as _wgrad
from action_conditioned_gans_tpu_torch.ops.common import ACTIVATIONS, act_bwd, resolve_groups, same_pad
from action_conditioned_gans_tpu_torch.ops.kernels import build, gn_bwd, library

LAUNCHES = {"conv_norm_act": 0, "conv_transpose_norm_act": 0}
# By the value of acg_conv_path / acg_conv_transpose_path.
MAINLOOPS = {
    "conv_norm_act": ("fma", "wmma", "wgmma"),
    "conv_transpose_norm_act": ("fma", "wmma", "wgmma", "narrow"),
}
LAUNCHES_BY_MAINLOOP = {f"{k}:{m}": 0 for k, loops in MAINLOOPS.items() for m in loops}
_KINDS = ("group", "none")
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# Evaluates only the backward-data / backward-weight convolutions its
# output_mask asks for.
_convolution_backward = torch.ops.aten.convolution_backward


def reset_launches() -> None:
    for counts in (LAUNCHES, LAUNCHES_BY_MAINLOOP):
        for name in counts:
            counts[name] = 0


@dataclasses.dataclass(frozen=True)
class _Opts:
    transpose: bool
    stride: int
    kind: str
    groups: int
    eps: float
    act: str
    leak: float
    wgrad: str = "xla"  # "patches": dw as one im2col product (ops/wgrad.py)


def _plain(x, w, scale, bias, o: "_Opts"):
    """(out, pre-norm y): the conv of ``ops/reference.py`` plus ``norm_act``."""
    y = (reference.conv2d_transpose if o.transpose else reference.conv2d)(x, w, stride=o.stride)
    out = reference.norm_act(
        y, scale if o.kind != "none" else None, bias,
        kind=o.kind, groups=o.groups, eps=o.eps, act=o.act, leak=o.leak,
    )
    return out, y


def conv_norm_act_plain(
    x, w, scale, bias, *, stride=1, kind="group", groups=32, eps=1e-5, act="lrelu", leak=0.2
) -> torch.Tensor:
    return _plain(x, w, scale, bias, _Opts(False, stride, kind, groups, eps, act, leak))[0]


def conv_transpose_norm_act_plain(
    x, w, scale, bias, *, stride=2, kind="group", groups=32, eps=1e-5, act="relu", leak=0.2
) -> torch.Tensor:
    return _plain(x, w, scale, bias, _Opts(True, stride, kind, groups, eps, act, leak))[0]


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
        if t is not None and t.device != x.device:
            raise ValueError(f"{name}: all tensors must be on {x.device}, one is on {t.device}")
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


def _launch_conv(x, w, scale, bias, o: _Opts):
    """One launch of the conv kernel. Returns (out, epilogue operands,
    groups); :func:`_residuals` reads y and stats from the operands."""
    _check_common("conv_norm_act", x, w, scale, bias, o.kind, o.act)
    kh, kw = w.shape[0], w.shape[1]
    if o.stride not in (1, 2) or kh != kw:
        raise ValueError(f"conv_norm_act: want a square kernel and stride 1 or 2, got {kh}x{kw}/{o.stride}")
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    oh, pad_h, _ = same_pad(h, kh, o.stride)
    ow, pad_w, _ = same_pad(wd, kw, o.stride)
    lib = build.load("conv_norm_act")
    dt = _DTYPES[x.dtype]
    mainloop = MAINLOOPS["conv_norm_act"][lib.acg_conv_path(dt, cin, cout, x.data_ptr())]
    slots = lib.acg_conv_tiles(dt, cin, cout, oh * ow, x.data_ptr())
    wk, g, ops = _epilogue_operands(x, w, scale, bias, o.kind, o.groups, oh * ow, slots)
    # The wgmma mainloop reads the weights packed (Cout, K) into this scratch.
    wt = torch.empty(wk.numel(), device=x.device, dtype=x.dtype) if mainloop == "wgmma" else None
    out = torch.empty((b, oh, ow, cout), device=x.device, dtype=x.dtype)
    ptrs = [_ptr(t) for t in ops]
    rc = lib.acg_conv_norm_act(
        x.data_ptr(), wk.data_ptr(), _ptr(wt), ptrs[0], ptrs[1], out.data_ptr(), *ptrs[2:],
        dt, b, h, wd, cin, oh, ow, cout, kh, kw, o.stride, pad_h, pad_w,
        int(o.kind == "group"), g, float(o.eps), ACTIVATIONS.index(o.act), float(o.leak),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc:
        raise RuntimeError(f"conv_norm_act kernel launch failed ({mainloop}): CUDA error {rc}")
    LAUNCHES["conv_norm_act"] += 1
    LAUNCHES_BY_MAINLOOP[f"conv_norm_act:{mainloop}"] += 1
    return out, ops, g


def _launch_conv_transpose(x, w, scale, bias, o: _Opts):
    """One launch of the conv-transpose kernel; returns as :func:`_launch_conv`."""
    _check_common("conv_transpose_norm_act", x, w, scale, bias, o.kind, o.act)
    if o.stride != 2 or w.shape[0] != 4 or w.shape[1] != 4:
        raise ValueError(
            f"conv_transpose_norm_act: the kernel takes k=4, stride=2, got "
            f"k={tuple(w.shape[:2])}, stride={o.stride}"
        )
    b, h, wd, cin = x.shape
    cout = w.shape[3]
    lib = build.load("conv_transpose_norm_act")
    dt, gn = _DTYPES[x.dtype], int(o.kind == "group")
    plan = (dt, cin, cout, gn, h, wd, x.data_ptr())
    mainloop = MAINLOOPS["conv_transpose_norm_act"][lib.acg_conv_transpose_path(*plan)]
    slots = lib.acg_conv_transpose_tiles(*plan)
    wk, g, ops = _epilogue_operands(x, w, scale, bias, o.kind, o.groups, 4 * h * wd, slots)
    # The wgmma mainloop reads the four phase kernels packed (4, Cout, 4*Cin)
    # into this scratch.
    wt = torch.empty(wk.numel(), device=x.device, dtype=x.dtype) if mainloop == "wgmma" else None
    out = torch.empty((b, 2 * h, 2 * wd, cout), device=x.device, dtype=x.dtype)
    ptrs = [_ptr(t) for t in ops]
    rc = lib.acg_conv_transpose_norm_act(
        x.data_ptr(), wk.data_ptr(), _ptr(wt), ptrs[0], ptrs[1], out.data_ptr(), *ptrs[2:],
        dt, b, h, wd, cin, cout, gn, g, float(o.eps), ACTIVATIONS.index(o.act), float(o.leak),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if rc:
        raise RuntimeError(f"conv_transpose_norm_act kernel launch failed ({mainloop}): CUDA error {rc}")
    LAUNCHES["conv_transpose_norm_act"] += 1
    LAUNCHES_BY_MAINLOOP[f"conv_transpose_norm_act:{mainloop}"] += 1
    return out, ops, g


def _launch(x, w, scale, bias, o: _Opts):
    return (_launch_conv_transpose if o.transpose else _launch_conv)(x, w, scale, bias, o)


def _residuals(out, ops, groups):
    """(out, y, stats): y the float32 pre-norm output (B, OH, OW, Cout) and
    stats the (2, B, groups) mean / rstd, both None for kind "none"."""
    y, stats = ops[2], ops[5]
    if y is None:
        return out, None, None
    return out, y.view(out.shape), stats.view(2, out.shape[0], groups)


def _forward(x, w, scale, bias, o: _Opts):
    """(out, y, stats) for the backward. On CUDA the kernel's own; on the
    CPU the plain version's, with y the conv output in the compute dtype and
    stats None."""
    if x.is_cuda:
        return _residuals(*_launch(x, w, scale, bias, o))
    out, y = _plain(x, w, scale, bias, o)
    return out, (y if o.kind == "group" else None), None


def _forward_no_grad(x, w, scale, bias, o: _Opts):
    """The output alone: the serving path keeps no residual. While
    ``torch.export`` traces, the call is the ``acgan::`` custom op
    (``ops/kernels/library.py``), whose CUDA and CPU implementations are the
    two branches below; run live, it skips the op's dispatch, about 20 us of
    host time a call on a serving path the host bounds."""
    if torch.compiler.is_exporting():
        op = library.conv_transpose_norm_act if o.transpose else library.conv_norm_act
        return op(x, w, scale, bias, o.stride, o.kind, o.groups, o.eps, o.act, o.leak)
    if x.is_cuda:
        return _launch(x, w, scale, bias, o)[0]
    return _plain(x, w, scale, bias, o)[0]


def _conv_backward(dy, x, w, o: _Opts, need_x: bool, need_w: bool):
    """(dx NHWC, dw HWIO) of the block's conv for the cotangent ``dy`` of its
    output, through ``aten.convolution_backward`` in the compute dtype. Only
    the backward convolutions that ``need_x`` / ``need_w`` ask for run; with
    ``wgrad="patches"`` dw is the im2col product of ``ops/wgrad.py``."""
    patches_dw = None
    if need_w and o.wgrad == "patches":
        patches_dw = _wgrad.patches_dw(x, dy.to(x.dtype), w.shape, o.stride, o.transpose)
        need_w = False
    if not (need_x or need_w):
        return None, None if patches_dw is None else patches_dw.to(w.dtype).contiguous()
    dt = x.dtype
    cl = torch.channels_last
    gy = dy.to(dt).permute(0, 3, 1, 2)
    xn = x.permute(0, 3, 1, 2)
    mask = [need_x, need_w, False]
    if o.transpose:
        # F.conv_transpose2d(padding=1) equals lax.conv_transpose(SAME) with
        # the kernel flipped in both spatial axes, laid out (I, O, kh, kw).
        wt = w.to(dt).flip(0, 1).permute(2, 3, 0, 1).contiguous(memory_format=cl)
        dxn, dwn, _ = _convolution_backward(
            gy, xn, wt, None, [2, 2], [1, 1], [1, 1], True, [0, 0], 1, mask
        )
        dw = dwn.flip(2, 3).permute(2, 3, 0, 1) if need_w else None
    else:
        h, wd = x.shape[1], x.shape[2]
        kh, kw = w.shape[0], w.shape[1]
        _, plo, phi = same_pad(h, kh, o.stride)
        _, qlo, qhi = same_pad(wd, kw, o.stride)
        # SAME on odd sizes pads one more after than before; convolution
        # takes symmetric padding, so the extra row / column is explicit.
        if (phi, qhi) != (plo, qlo):
            xn = F.pad(xn, (0, qhi - qlo, 0, phi - plo))
        wo = w.to(dt).permute(3, 2, 0, 1).contiguous(memory_format=cl)
        dxn, dwn, _ = _convolution_backward(
            gy, xn, wo, None, [o.stride] * 2, [plo, qlo], [1, 1], False, [0, 0], 1, mask
        )
        if need_x:
            dxn = dxn[:, :, :h, :wd]
        dw = dwn.permute(2, 3, 1, 0) if need_w else None
    dx = dxn.permute(0, 2, 3, 1).contiguous().to(x.dtype) if need_x else None
    if patches_dw is not None:
        dw = patches_dw
    if dw is not None:
        dw = dw.to(w.dtype).contiguous()
    return dx, dw


class _ConvBlockFn(torch.autograd.Function):
    """conv(-transpose) -> norm -> activation with the saved-residual backward."""

    @staticmethod
    def forward(ctx, x, w, scale, bias, o: _Opts):
        out, y, stats = _forward(x, w, scale, bias, o)
        ctx.opts = o
        ctx.save_for_backward(x, w, scale, out, y, stats)
        return out

    @staticmethod
    def backward(ctx, g):
        o = ctx.opts
        x, w, scale, out, y, stats = ctx.saved_tensors
        need_x, need_w, need_s, need_b = ctx.needs_input_grad[:4]
        g = g.contiguous()
        dscale = None
        if o.kind == "group":
            if scale is None:
                scale = torch.ones(out.shape[-1], device=out.device)
            mean, rstd = (None, None) if stats is None else stats.unbind(0)
            dy, dscale, dbias = gn_bwd.gn_act_bwd(
                y, scale, out, g, mean, rstd,
                groups=o.groups, eps=o.eps, act=o.act, leak=o.leak,
            )
        else:
            dpre = act_bwd(g.float(), out.float(), o.act, o.leak)
            dbias = dpre.sum(dim=(0, 1, 2))
            dy = dpre.to(out.dtype)
        dx, dw = _conv_backward(dy, x, w, o, need_x, need_w)
        return dx, dw, dscale if need_s else None, dbias if need_b else None, None


class ConvNormActFn(_ConvBlockFn):
    """Autograd of :func:`conv_norm_act` (``ops/pallas/conv.py`` custom VJP)."""


class ConvTransposeNormActFn(_ConvBlockFn):
    """Autograd of :func:`conv_transpose_norm_act`."""


def _needs_grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in ts)


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
    wgrad: str = "xla",
) -> torch.Tensor:
    """SAME conv (NHWC x HWIO) -> GroupNorm or bias -> affine -> activation;
    ``wgrad`` picks the weight gradient's engine."""
    o = _Opts(False, stride, kind, groups, float(eps), act, float(leak), wgrad)
    if _needs_grad(x, w, scale, bias):
        return ConvNormActFn.apply(x, w, scale, bias, o)
    return _forward_no_grad(x, w, scale, bias, o)


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
    wgrad: str = "xla",
) -> torch.Tensor:
    """k=4 / stride-2 SAME conv-transpose -> GroupNorm or bias -> affine ->
    act; ``wgrad`` picks the weight gradient's engine."""
    o = _Opts(True, stride, kind, groups, float(eps), act, float(leak), wgrad)
    if _needs_grad(x, w, scale, bias):
        return ConvTransposeNormActFn.apply(x, w, scale, bias, o)
    return _forward_no_grad(x, w, scale, bias, o)
