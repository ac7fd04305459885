"""The collectives of the data-parallel step.

``mean_reduce_`` averages a set of tensors over the group in place with ONE
all-reduce of their flattened concatenation (the step's gradient sets and
metrics). ``all_reduce_mean`` is the differentiable average the synced batch
statistics take: its backward sums the cotangents over the ranks (the
transpose of the JAX ``lax.pmean``, so that the ranks' mean gradient is the
gradient of the global batch's loss), and is itself an all-reduce that
autograd differentiates again (R1's double backward through batch norm).
Every rank must issue the same collectives in the same order; the step's
graph is the same on every rank, so its backward is too.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over ``group``'s ranks, differentiable (any order)."""
    return _AllReduceSum.apply(x, group) / dist.get_world_size(group)


def mean_reduce_(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Replace each tensor (same dtype and device) by its mean over
    ``group``, through one all-reduce of their flattened concatenation;
    returns them."""
    tensors = list(tensors)
    flat = torch.cat([t.detach().reshape(-1) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    flat.div_(dist.get_world_size(group))
    parts = flat.split([t.numel() for t in tensors])
    torch._foreach_copy_([t.detach() for t in tensors],
                         [p.view_as(t) for p, t in zip(parts, tensors)])
    return tensors


def any_rank(flag: bool, group, device) -> bool:
    """Whether ``flag`` is set on any rank of ``group`` (a max-reduce; on
    ``device`` under NCCL, on the host under gloo)."""
    if dist.get_backend(group) != "nccl":
        device = torch.device("cpu")
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def barrier(group, device) -> None:
    """Every rank of ``group`` waits here for the others (on ``device``'s
    stream under NCCL)."""
    if device.type == "cuda" and dist.get_backend(group) == "nccl":
        index = torch.cuda.current_device() if device.index is None else device.index
        dist.barrier(group=group, device_ids=[index])
    else:
        dist.barrier(group=group)
