"""Wrapper of the standalone GroupNorm+activation Hopper kernel, with autograd.

Port of the JAX package's ``ops/pallas/norm_act.py`` (``group_norm_act``):
GroupNorm (float32 statistics, ``E[x^2] - mean^2`` clamped at 0) -> affine
-> activation over NHWC ``x``, ``csrc/group_norm_act.cu``. ``ops/api.py``
runs it after the plain conv of every layer that the reference's envelope
splits (``ops/envelope.py``).

The kernel is one launch with one thread-block cluster per sample: each block
copies its share of the sample's rows into shared memory, the blocks reduce
their per-group sums through distributed shared memory, and each normalises
its share where it lies. :func:`gn_plan` is the Python copy of the C plan
(``acg_gn_plan``, ``csrc/gn_cluster.cuh``, through ``gn_cluster.py``):
cluster size, rows per block, rows kept in shared memory and bytes read
twice.

For a CUDA tensor :func:`group_norm_act` launches the kernel or raises; for
a CPU tensor it computes the plain version, :func:`group_norm_act_plain`,
which is ``reference.norm_act(kind="group")``: the XLA composite the JAX
kernel is held to (two-pass variance, cast to the compute dtype before the
activation). The kernel activates in float32 and then casts, as the TPU
kernel does, so the card compares a bfloat16 kernel with the plain version
run in float32 on the same input. ``LAUNCHES["group_norm_act"]`` counts
kernel launches.

When a gradient is needed the call goes through :class:`GroupNormActFn`,
the port of the custom VJP (``norm_act.py:75-96``): the forward saves x,
scale, the output and, on CUDA, the kernel's (mean, rstd); the backward is
the GroupNorm+activation backward (``ops/kernels/gn_bwd.py``) with ``y=x``
in the compute dtype. On the CPU the statistics are recomputed there, as the
JAX VJP does.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from action_conditioned_gans_tpu_torch.ops import reference
from action_conditioned_gans_tpu_torch.ops.common import ACTIVATIONS, resolve_groups
from action_conditioned_gans_tpu_torch.ops.kernels import build, gn_bwd, library
from action_conditioned_gans_tpu_torch.ops.kernels.gn_cluster import (  # noqa: F401 (the tests read these here)
    FILL_BLOCKS, NT, SMEM_MAX, SMS, TWO_PER_SM, GnPlan, choose_plan, plan_at, share_rows,
)

LAUNCHES = {"group_norm_act": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    LAUNCHES["group_norm_act"] = 0


def unit_slots(vec: int, cg: int) -> int:
    """Per-group slots a thread folds its unit's ``vec`` channels into
    (``gnc::unit_slots``): each slot lies in one group of ``cg`` channels."""
    return 1 if cg % vec == 0 else (vec // cg if vec % cg == 0 else vec)


def _rows(esize: int, c: int, groups: int) -> tuple:
    """``gnc::norm_rows``: (bytes of a row of x, unit width, shared memory past
    the kept rows: lane partials S1 and S2, group partials, the mbarrier)."""
    vec = 16 // esize if c % (16 // esize) == 0 else 1
    return c * esize, vec, 4 * (2 * NT * unit_slots(vec, c // groups) + 4 * groups) + 16


def _plan_for(esize: int, hw: int, c: int, groups: int, cluster: int) -> GnPlan:
    return plan_at(*_rows(esize, c, groups), hw, cluster)


def gn_plan(dtype: torch.dtype, b: int, hw: int, c: int, groups: int) -> GnPlan:
    """The kernel's plan for x (b, hw, c) in ``dtype`` with ``groups`` (resolved)
    groups: a copy of ``gnc::make_plan`` (``gn_cluster.choose_plan``)."""
    return choose_plan(*_rows(torch.empty((), dtype=dtype).element_size(), c, groups), b, hw)


def kernel_plan(dtype: torch.dtype, b: int, hw: int, c: int, groups: int) -> GnPlan:
    """The plan as the kernel's library computes it (``acg_gn_plan``; on the card)."""
    out = (ctypes.c_int * 6)()
    rc = build.load("group_norm_act").acg_gn_plan(_DTYPES[dtype], b, hw, c, groups, out)
    if rc:
        raise RuntimeError(f"group_norm_act: no plan fits x({b}, {hw}, {c}): CUDA error {rc}")
    return GnPlan(*out)


@dataclasses.dataclass(frozen=True)
class _Opts:
    groups: int
    eps: float
    act: str
    leak: float


def group_norm_act_plain(x, scale, bias, *, groups=32, eps=1e-5, act="lrelu", leak=0.2):
    return reference.norm_act(x, scale, bias, kind="group", groups=groups, eps=eps, act=act,
                              leak=leak)


def _launch(x, scale, bias, o: _Opts):
    """One launch of the kernel: (out, stats (2, B, groups) float32)."""
    if o.act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {o.act!r}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"group_norm_act: x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"group_norm_act: want x (B, H, W, C), got {tuple(x.shape)}")
    b, h, w, c = x.shape
    for label, t in (("scale", scale), ("bias", bias)):
        if t is not None and (tuple(t.shape) != (c,) or t.device != x.device):
            raise ValueError(f"group_norm_act: {label} must be ({c},) on {x.device}")
    x = x.contiguous()
    g = resolve_groups(c, o.groups)
    dev = x.device
    scale_f = (scale if scale is not None else torch.ones(c, device=dev)).float().contiguous()
    bias_f = (bias if bias is not None else torch.zeros(c, device=dev)).float().contiguous()
    if x.data_ptr() % 16:  # the kernel copies 16-byte units
        x = x.clone()
    lib = build.load("group_norm_act")
    stats = torch.empty((2, b, g), device=dev, dtype=torch.float32)
    out = torch.empty_like(x)
    rc = lib.acg_group_norm_act(
        x.data_ptr(), scale_f.data_ptr(), bias_f.data_ptr(), out.data_ptr(), stats.data_ptr(),
        _DTYPES[x.dtype], b, h * w, c, g, float(o.eps),
        ACTIVATIONS.index(o.act), float(o.leak), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc:
        raise RuntimeError(f"group_norm_act kernel launch failed: CUDA error {rc}")
    LAUNCHES["group_norm_act"] += 1
    return out, stats


def group_norm_act_with_stats(x, scale, bias, *, groups=32, eps=1e-5, act="lrelu", leak=0.2):
    """(out, stats). On CUDA one launch of the kernel, and stats its (2, B,
    groups) float32 mean and rstd; on the CPU the plain version's output and
    None. No autograd."""
    o = _Opts(groups, float(eps), act, float(leak))
    if x.is_cuda:
        return _launch(x, scale, bias, o)
    return group_norm_act_plain(x, scale, bias, groups=groups, eps=eps, act=act, leak=leak), None


class GroupNormActFn(torch.autograd.Function):
    """Autograd of :func:`group_norm_act` (``ops/pallas/norm_act.py`` custom VJP)."""

    @staticmethod
    def forward(ctx, x, scale, bias, o: _Opts):
        out, stats = group_norm_act_with_stats(x, scale, bias, **dataclasses.asdict(o))
        ctx.opts = o
        ctx.save_for_backward(x, scale, out, stats)
        return out

    @staticmethod
    def backward(ctx, g):
        o = ctx.opts
        x, scale, out, stats = ctx.saved_tensors
        if scale is None:
            scale = torch.ones(x.shape[-1], device=x.device)
        mean, rstd = (None, None) if stats is None else stats.unbind(0)
        dx, dscale, dbias = gn_bwd.gn_act_bwd(
            x.contiguous(), scale, out, g.contiguous(), mean, rstd,
            groups=o.groups, eps=o.eps, act=o.act, leak=o.leak,
        )
        need_x, need_s, need_b = ctx.needs_input_grad[:3]
        return dx if need_x else None, dscale if need_s else None, dbias if need_b else None, None


def group_norm_act(
    x: torch.Tensor,
    scale: Optional[torch.Tensor],
    bias: Optional[torch.Tensor],
    *,
    groups: int = 32,
    eps: float = 1e-5,
    act: str = "lrelu",
    leak: float = 0.2,
) -> torch.Tensor:
    """GroupNorm -> affine -> activation over NHWC ``x``, in ``x``'s dtype."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, scale, bias)):
        return GroupNormActFn.apply(x, scale, bias, _Opts(groups, float(eps), act, float(leak)))
    if torch.compiler.is_exporting():  # the acgan:: op, as conv._forward_no_grad
        return library.group_norm_act(x, scale, bias, groups, float(eps), act, float(leak))
    return group_norm_act_with_stats(x, scale, bias, groups=groups, eps=eps, act=act, leak=leak)[0]
