"""The collectives of the data- and tensor-parallel steps.

``mean_reduce_`` averages a set of tensors over the group in place with ONE
all-reduce of their flattened concatenation (the step's gradient sets and
metrics), or of the one flat gradient itself. ``all_reduce_mean`` is the
differentiable average the synced batch statistics take: its backward sums
the cotangents over the ranks (the transpose of the JAX ``lax.pmean``, so
that the ranks' mean gradient is the gradient of the global batch's loss),
and is itself an all-reduce that autograd differentiates again (R1's double
backward through batch norm).
Every rank must issue the same collectives in the same order; the step's
graph is the same on every rank, so its backward is too.

Channel tensor parallelism (``parallel/tp.py``) wraps each sharded conv
block in the Megatron pair over the model group: :func:`copy_to_model` at
its input (identity forward; the backward sums the ranks' partial input
cotangents, each rank's conv having seen only its output channels) and
:func:`gather_from_model` at its output (all-gather of the channel axis
forward; every rank of the group holds the same gathered tensor and the
same cotangent of it, so the backward is this rank's slice, and an
all-reduce there would multiply the gradient by the group's size). Their
backwards are the pair's other two members (an all-reduce with an identity
backward, a slice with a gathering backward), so autograd differentiates
them again, as R1's double backward does.
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


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group``'s ranks, differentiable (any order);
    its backward sums the cotangents too: for a sum whose every rank uses
    the result in its own way (a spectral norm's sigma over a kernel's
    channel shards)."""
    return _AllReduceSum.apply(x, group)


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    """The mean of ``x`` over ``group``'s ranks, differentiable (any order)."""
    return _AllReduceSum.apply(x, group) / dist.get_world_size(group)


class _Copy(torch.autograd.Function):
    """Identity forward; the backward all-reduces (:class:`_Reduce`)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _Reduce.apply(grad, ctx.group), None


class _Reduce(torch.autograd.Function):
    """All-reduce (sum) forward; identity backward (:class:`_Copy`): every
    rank uses the sum alike."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return _Copy.apply(grad, ctx.group), None


def _gather_last(x: torch.Tensor, group) -> torch.Tensor:
    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


def _own_slice(x: torch.Tensor, group) -> torch.Tensor:
    return x.chunk(dist.get_world_size(group), dim=-1)[dist.get_rank(group)].contiguous()


class _Gather(torch.autograd.Function):
    """All-gather of the last axis forward; this rank's slice backward
    (:class:`_Split`)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather_last(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _Split.apply(grad, ctx.group), None


class _Split(torch.autograd.Function):
    """This rank's slice of the last axis forward; all-gather backward
    (:class:`_Gather`)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _own_slice(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _Gather.apply(grad, ctx.group), None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` at the input of a channel-sharded block (module docstring)."""
    return _Copy.apply(x, group)


def gather_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """A channel shard's output, gathered over ``group`` in rank order along
    the last axis (module docstring)."""
    return _Gather.apply(x, group)


def mean_reduce_(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Replace each tensor (same dtype and device) by its mean over
    ``group``, through one all-reduce of their flattened concatenation;
    returns them. One contiguous tensor (a flat gradient of
    ``train.flatten_optimizer``) is reduced in place: no concatenation, no
    copy back."""
    tensors = list(tensors)
    if len(tensors) == 1 and tensors[0].is_contiguous():
        (t,) = tensors
        with torch.no_grad():
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
            t.div_(dist.get_world_size(group))
        return tensors
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
