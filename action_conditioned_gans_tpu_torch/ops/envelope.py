"""Which layers take the fused conv kernels and which are split into a plain
conv followed by the standalone GroupNorm+activation kernel.

A copy of the JAX package's routing arithmetic: the per-sample VMEM plans of
``ops/pallas/conv.py`` (``_plan``, ``_plan_transpose``) against
``ops/pallas/common.py``'s ``VMEM_BUDGET``, and the envelope of
``ops/pallas/norm_act.py``. The numbers are a TPU's (a 10 MB VMEM budget),
not the H100's: the routing is carried over as it is so that every layer of
the port decomposes as it does in the reference with ``backend="pallas"``,
and computes what the reference computes, op for op. Pure functions of
shapes and dtype; nothing here touches a tensor.
"""

from __future__ import annotations

from typing import Sequence

import torch

from action_conditioned_gans_tpu_torch.ops.common import same_pad

# The reference's per-program working-set budget (bytes).
VMEM_BUDGET = 10 * 1024 * 1024


def conv_fits(x_shape: Sequence[int], w_shape: Sequence[int], stride: int, item: int) -> bool:
    """The reference's ``_plan`` with one output block (``outputs=1``, as
    ``conv_norm_act_supported`` asks it): whether one sample's SAME conv,
    rewritten to stride 1 by space-to-depth, fits the budget with ``item``
    bytes per element."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    _, h, w, cin = x_shape
    kh, kw, wcin, cout = w_shape
    if wcin != cin or kh != kw or stride not in (1, 2):
        return False
    k = kh
    oh, plo, phi = same_pad(h, k, stride)
    ow, qlo, qhi = same_pad(w, k, stride)
    if stride == 2:
        if k % 2 or (h + plo + phi) % 2 or (w + qlo + qhi) % 2:
            return False
        kk, cin_eff = k // 2, cin * 4
        hp, wp = (h + plo + phi) // 2, (w + qlo + qhi) // 2
    else:
        kk, cin_eff = k, cin
        hp, wp = h + plo + phi, w + qlo + qhi
    if hp - kk + 1 < oh or wp - kk + 1 < ow:
        return False
    per_sample = (
        hp * wp * cin_eff * item  # input block
        + oh * ow * cin_eff * item  # shifted slice
        + oh * ow * cout * 4  # float32 accumulator
        + oh * ow * cout * item  # output block
    )
    w_bytes = kk * kk * cin_eff * cout * item
    return 2 * (per_sample + w_bytes) <= VMEM_BUDGET  # double-buffered


def conv_transpose_fits(x_shape: Sequence[int], w_shape: Sequence[int], stride: int,
                        item: int) -> bool:
    """The reference's ``_plan_transpose`` (k=4 / stride 2 only)."""
    if len(x_shape) != 4 or len(w_shape) != 4:
        return False
    _, h, w, cin = x_shape
    kh, kw, wcin, cout = w_shape
    if stride != 2 or kh != 4 or kw != 4 or wcin != cin:
        return False
    in_bytes = (h + 2) * (w + 2) * cin * item
    slice_bytes = h * w * cin * item
    acc_bytes = 4 * h * w * cout * 4
    w_bytes = 16 * cin * cout * item
    out_bytes = 2 * 4 * h * w * cout * item  # output + residual blocks
    return 2 * (in_bytes + slice_bytes + acc_bytes + w_bytes + out_bytes) <= VMEM_BUDGET


def conv_norm_act_supported(x_shape, w_shape, stride, kind, dtype: torch.dtype) -> bool:
    return kind in ("group", "none") and conv_fits(x_shape, w_shape, stride, dtype.itemsize)


def conv_transpose_norm_act_supported(x_shape, w_shape, stride, kind, dtype: torch.dtype) -> bool:
    return kind in ("group", "none") and conv_transpose_fits(x_shape, w_shape, stride,
                                                             dtype.itemsize)


def group_norm_act_supported(x_shape: Sequence[int]) -> bool:
    """The reference's ``group_norm_act_supported``: NHWC with at least 32
    channels, one sample's float32 copy and result within the budget."""
    if len(x_shape) != 4:
        return False
    _, h, w, c = x_shape
    if c < 32:
        return False
    return h * w * c * 4 * 2 <= VMEM_BUDGET


def route(x_shape, w_shape, stride: int, transpose: bool, kind: str, groups: int,
          dtype: torch.dtype) -> str:
    """"fused" when the reference runs the layer as one fused conv kernel,
    "split" when it runs the plain conv and then ``norm_act``. ``groups``
    does not enter the reference's predicates; it is taken for the call's
    symmetry with the layer's arguments."""
    del groups
    fits = conv_transpose_norm_act_supported if transpose else conv_norm_act_supported
    return "fused" if fits(x_shape, w_shape, stride, kind, dtype) else "split"
