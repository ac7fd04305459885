"""Wrapper of the fused flat Adam kernel (kernel 5, ``csrc/adam_flat.cu``).

With ``train.flatten_optimizer`` the JAX package runs its optimizer chain as
``optax.flatten(inner)`` (its ``train/state.py:182``): clipping by the global
norm, Adam and the learning rate over one concatenated parameter vector, in
one XLA fusion. No Pallas kernel does it; kernel 5 is that fusion on the
card, over the port's flat buffers (``train/state.py``'s flat layout): one
pass that reads the parameter, gradient and both moment vectors and writes
the parameter and moments in place.

:func:`adam_flat` launches the kernel for CUDA tensors or raises; for CPU
(and meta) tensors it runs the plain version, :func:`adam_flat_plain`, which
is ``train.state.Adam``'s per-tensor arithmetic (:func:`clip_by_norm`,
:func:`adam_foreach_`) on lists of one tensor. The kernel writes through raw
pointers, so the wrapper bumps the three tensors' autograd version counters
as an in-place torch op would. ``LAUNCHES["adam_flat"]`` counts launches.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from action_conditioned_gans_tpu_torch.ops.kernels import build

LAUNCHES = {"adam_flat": 0}
_MOMENTS = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    LAUNCHES["adam_flat"] = 0


def clip_by_norm(grads: Sequence[torch.Tensor], norm: torch.Tensor, clip: float) -> List[torch.Tensor]:
    """optax.clip_by_global_norm given the global ``norm``: each gradient
    unchanged where ``norm < clip``, else ``(g / norm) * clip`` (a NaN norm
    gives NaN, as in the reference)."""
    keep = norm < clip
    return [torch.where(keep, g, (g / norm) * clip) for g in grads]


def adam_foreach_(ps, gs, mu, nu, *, b1: float, b2: float, eps: float, lr: float, bc1: float,
                  bc2: float) -> None:
    """The Adam update of ``ps`` (float32) and the moments ``mu`` / ``nu``
    (float32 or bfloat16) in place, from float32 gradients ``gs``: the
    update reads the unrounded float32 moments; stored bfloat16 moments are
    rounded to nearest even. ``torch._foreach`` ops over lists of tensors."""
    f32 = mu[0].dtype == torch.float32
    mu_f = mu if f32 else [m.float() for m in mu]
    nu_f = nu if f32 else [v.float() for v in nu]
    torch._foreach_mul_(mu_f, b1)
    torch._foreach_add_(mu_f, gs, alpha=1.0 - b1)
    torch._foreach_mul_(nu_f, b2)
    torch._foreach_addcmul_(nu_f, gs, gs, value=1.0 - b2)
    denom = torch._foreach_div(nu_f, bc2)
    torch._foreach_sqrt_(denom)
    torch._foreach_add_(denom, eps)
    step = torch._foreach_div(mu_f, bc1)
    torch._foreach_div_(step, denom)
    torch._foreach_add_(ps, step, alpha=-lr)
    if not f32:
        for dst, src in zip(list(mu) + list(nu), mu_f + nu_f):
            dst.copy_(src)


@torch.no_grad()
def adam_flat_plain(p, g, mu, nu, *, b1, b2, eps, lr, bc1, bc2, clip=0.0,
                    norm: Optional[torch.Tensor] = None) -> None:
    """The plain version of kernel 5: clip (with ``norm``), then Adam, on the
    flat tensors in place."""
    gs = [g] if norm is None else clip_by_norm([g], norm, clip)
    adam_foreach_([p], gs, [mu], [nu], b1=b1, b2=b2, eps=eps, lr=lr, bc1=bc1, bc2=bc2)


def _check(p, g, mu, nu, norm):
    if p.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError(f"adam_flat: p and g must be float32, got {p.dtype}, {g.dtype}")
    if mu.dtype not in _MOMENTS or nu.dtype != mu.dtype:
        raise TypeError(f"adam_flat: mu and nu must share float32 or bfloat16, got {mu.dtype}, "
                        f"{nu.dtype}")
    ts = (p, g, mu, nu)
    if any(t.dim() != 1 or t.numel() != p.numel() for t in ts):
        raise ValueError(f"adam_flat: p, g, mu and nu must be 1-D of one length, got "
                         f"{[tuple(t.shape) for t in ts]}")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("adam_flat: p, g, mu and nu must be contiguous")
    if any(t.device != p.device for t in ts):
        raise ValueError(f"adam_flat: all tensors must be on {p.device}")
    if norm is not None and (norm.numel() != 1 or norm.dtype != torch.float32
                             or norm.device != p.device):
        raise ValueError(f"adam_flat: norm must be one float32 on {p.device}")


@torch.no_grad()
def adam_flat(p, g, mu, nu, *, b1, b2, eps, lr, bc1, bc2, clip=0.0,
              norm: Optional[torch.Tensor] = None) -> None:
    """One Adam update of the flat parameter vector ``p`` (float32) and its
    moments ``mu`` / ``nu`` (float32 or bfloat16, 1-D, same length) in
    place, from the flat gradient ``g`` (float32), clipped first when
    ``norm`` (a 0-d float32 tensor, the global norm of ``g``) is given.
    ``lr``, ``bc1`` and ``bc2`` are the update's learning rate and bias
    corrections (``1 - b**count``); every scalar is rounded to float32 as a
    torch op on the card rounds a Python number (a division by ``bc``
    multiplies by ``1 / bc`` taken in double, then rounded)."""
    if not p.is_cuda:
        adam_flat_plain(p, g, mu, nu, b1=b1, b2=b2, eps=eps, lr=lr, bc1=bc1, bc2=bc2, clip=clip,
                        norm=norm)
        return
    _check(p, g, mu, nu, norm)
    if norm is not None and norm.data_ptr() % 4:
        norm = norm.clone()
    lib = build.load("adam_flat")
    rc = lib.acg_adam_flat(
        p.data_ptr(), g.data_ptr(), mu.data_ptr(), nu.data_ptr(),
        None if norm is None else norm.data_ptr(), _MOMENTS[mu.dtype], p.numel(),
        b1, 1.0 - b1, b2, 1.0 - b2, 1.0 / bc1, 1.0 / bc2, eps, -lr, clip,
        torch.cuda.current_stream(p.device).cuda_stream,
    )
    if rc:
        raise RuntimeError(f"adam_flat kernel launch failed: CUDA error {rc}")
    for t in (p, mu, nu):
        torch.autograd.graph.increment_version(t)
    LAUNCHES["adam_flat"] += 1
