"""Wrapper of the GroupNorm+activation backward Hopper kernel.

Port of the JAX package's ``ops/pallas/gn_bwd.py`` (``gn_act_bwd_pallas``):
the closed-form gradient of GroupNorm -> affine -> activation from the
forward's saved statistics, ``csrc/gn_act_bwd.cu``. It is the backward of
every GroupNorm layer on the training path: the fused conv kernels' autograd
Functions (``ops/kernels/conv.py``) call it with their float32 pre-norm ``y``
and the (mean, rstd) their forward already computed, and the standalone
GroupNorm kernel's (``ops/kernels/norm_act.py``) with its input ``x`` in the
compute dtype as ``y``.

The kernel is one cluster launch and a batch sum. The cluster launch runs
one thread-block cluster per sample: each block copies its share of the
sample's rows of ``y``, ``out`` and ``g`` into shared memory, sums
``dpre`` and ``dpre * xhat`` per channel, the blocks reduce their
scale-weighted per-group sums through distributed shared memory for ``dx``
and their per-channel sums into the sample's (dbias, dscale) partials, and
each block writes ``dx`` from its share where it lies. The second launch sums
the per-sample partials over the batch in sample order. :func:`gn_bwd_plan`
is the Python copy of the C plan (``acg_gn_bwd_plan``: the smallest cluster,
1 to 16 blocks, whose shares fit a block's shared memory;
``gn_cluster.fit_plan``).

For a CUDA tensor :func:`gn_act_bwd` launches the kernel or raises; for a CPU
tensor it computes the plain version, ``reference.gn_act_grads``.
``LAUNCHES["gn_act_bwd"]`` counts calls that launched the kernel.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from action_conditioned_gans_tpu_torch.ops import reference
from action_conditioned_gans_tpu_torch.ops.common import ACTIVATIONS, resolve_groups
from action_conditioned_gans_tpu_torch.ops.kernels import build
from action_conditioned_gans_tpu_torch.ops.kernels.gn_cluster import NT, GnPlan, align16, fit_plan

LAUNCHES = {"gn_act_bwd": 0}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
STAGES = 4  # csrc/gn_act_bwd.cu: mbarriers a block's kept rows are copied on


def reset_launches() -> None:
    LAUNCHES["gn_act_bwd"] = 0


def _rows(y_bytes: int, t_bytes: int, c: int, groups: int) -> tuple:
    """``bwd_rows`` of csrc/gn_act_bwd.cu: (bytes of a row of y, out and g,
    unit width in channels: 16 bytes of out, shared memory past the kept
    rows: the mbarriers, lane partials of S1 and S2, per-channel sums, five
    per-channel coefficients, this block's and the cluster's group sums)."""
    vec = 16 // t_bytes if c % (16 // t_bytes) == 0 else 1
    scratch = align16(8 * STAGES + 4 * (2 * NT * vec + 7 * c + 4 * groups))
    return c * (y_bytes + 2 * t_bytes), vec, scratch


def gn_bwd_plan(y_dtype: torch.dtype, dtype: torch.dtype, b: int, hw: int, c: int,
                groups: int) -> GnPlan:
    """The kernel's plan for y (b, hw, c) in ``y_dtype`` and out, g in ``dtype``
    with ``groups`` (resolved) groups: a copy of ``acg_gn_bwd_plan``. The
    smallest cluster whose shares fit a block (``gn_cluster.fit_plan``); the
    batch ``b`` does not change it."""
    size = lambda dt: torch.empty((), dtype=dt).element_size()  # noqa: E731
    return fit_plan(*_rows(size(y_dtype), size(dtype), c, groups), hw)


def kernel_plan(y_dtype: torch.dtype, dtype: torch.dtype, b: int, hw: int, c: int,
                groups: int) -> GnPlan:
    """The plan as the kernel's library computes it (``acg_gn_bwd_plan``; on the card)."""
    out = (ctypes.c_int * 6)()
    size = lambda dt: torch.empty((), dtype=dt).element_size()  # noqa: E731
    rc = build.load("gn_act_bwd").acg_gn_bwd_plan(size(y_dtype), size(dtype), b, hw, c, groups, out)
    if rc:
        raise RuntimeError(f"gn_act_bwd: no plan fits y({b}, {hw}, {c}): CUDA error {rc}")
    return GnPlan(*out)


def gn_act_bwd_plain(
    y, scale, out, g, mean=None, rstd=None, *, groups=32, eps=1e-5, act="lrelu", leak=0.2
):
    """(dy in ``out``'s dtype, dscale, dbias) through ``reference.gn_act_grads``."""
    dy, dscale, dbias = reference.gn_act_grads(
        y, scale, out, g, mean, rstd, groups=groups, eps=eps, act=act, leak=leak
    )
    return dy.to(out.dtype), dscale, dbias


def gn_act_bwd(
    y: torch.Tensor,
    scale: torch.Tensor,
    out: torch.Tensor,
    g: torch.Tensor,
    mean: Optional[torch.Tensor] = None,
    rstd: Optional[torch.Tensor] = None,
    *,
    groups: int = 32,
    eps: float = 1e-5,
    act: str = "lrelu",
    leak: float = 0.2,
) -> tuple:
    """(dy, dscale, dbias) of GroupNorm -> affine -> activation.

    ``y`` (B, H, W, C) is the pre-norm input, float32 or the compute dtype,
    read as it is (not cast); ``out`` is the block's output and ``g`` its cotangent,
    both in the compute dtype; ``mean``/``rstd`` are the
    forward's (B, groups) float32 statistics. ``dy`` comes back in ``out``'s
    dtype, ``dscale``/``dbias`` (C,) in float32. The kernel needs ``mean`` and
    ``rstd``; the CPU path recomputes them when they are absent.
    """
    if not y.is_cuda:
        return gn_act_bwd_plain(
            y, scale, out, g, mean, rstd, groups=groups, eps=eps, act=act, leak=leak
        )
    if act not in ACTIVATIONS:
        raise ValueError(f"unknown activation {act!r}")
    if act == "lrelu" and leak < 0:
        raise ValueError("the saved-output activation backward needs leak >= 0")
    if out.dtype not in _DTYPES or g.dtype != out.dtype:
        raise TypeError(f"gn_act_bwd: out and g must share float32 or bfloat16, got {out.dtype}, {g.dtype}")
    if y.dim() != 4 or y.dtype not in (torch.float32, out.dtype):
        raise ValueError(
            f"gn_act_bwd: y must be (B, H, W, C) in float32 or {out.dtype}, got {y.dtype} {tuple(y.shape)}"
        )
    if out.shape != y.shape or g.shape != y.shape:
        raise ValueError("gn_act_bwd: y, out and g must share one shape")
    b, h, w, c = y.shape
    grp = resolve_groups(c, groups)
    if mean is None or rstd is None:
        raise ValueError("gn_act_bwd: the kernel takes the forward's mean and rstd")
    if tuple(mean.shape) != (b, grp) or tuple(rstd.shape) != (b, grp) or tuple(scale.shape) != (c,):
        raise ValueError(
            f"gn_act_bwd: want mean, rstd ({b}, {grp}) and scale ({c},), got "
            f"{tuple(mean.shape)}, {tuple(rstd.shape)}, {tuple(scale.shape)}"
        )
    ts = (y, out, g, scale, mean, rstd)
    if any(t.device != y.device for t in ts):
        raise ValueError(f"gn_act_bwd: all tensors must be on {y.device}")
    if not all(t.is_contiguous() for t in (y, out, g, mean, rstd)):
        raise ValueError("gn_act_bwd: y, out, g, mean and rstd must be contiguous")
    if mean.dtype != torch.float32 or rstd.dtype != torch.float32:
        raise TypeError("gn_act_bwd: mean and rstd must be float32")
    if gn_bwd_plan(y.dtype, out.dtype, b, h * w, c, grp).smem < 0:
        raise ValueError(f"gn_act_bwd: no plan fits a block for C={c}, groups={grp}")
    return _launch(y, scale.float().contiguous(), out, g, mean, rstd, grp, act, leak)


def _launch(y, scale, out, g, mean, rstd, groups, act, leak):
    """The kernel's two launches on checked operands (``groups`` resolved,
    ``scale`` float32): (dx, dscale, dbias)."""
    b, h, w, c = y.shape
    lib = build.load("gn_act_bwd")
    dx = torch.empty_like(out)
    dscale = torch.empty(c, device=y.device, dtype=torch.float32)
    dbias = torch.empty_like(dscale)
    scratch = torch.empty(lib.acg_gn_bwd_scratch_floats(b, c), device=y.device,
                          dtype=torch.float32)
    rc = lib.acg_gn_act_bwd(
        y.data_ptr(), out.data_ptr(), g.data_ptr(), scale.data_ptr(), mean.data_ptr(),
        rstd.data_ptr(), dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), scratch.data_ptr(),
        _DTYPES[y.dtype], _DTYPES[out.dtype], b, h * w, c, groups, ACTIVATIONS.index(act),
        float(leak), torch.cuda.current_stream(y.device).cuda_stream,
    )
    if rc:
        raise RuntimeError(f"gn_act_bwd kernel launch failed: CUDA error {rc}")
    LAUNCHES["gn_act_bwd"] += 1
    return dx, dscale, dbias
