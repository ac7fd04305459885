"""Multi-step rollout of the generator for training (port of ``train/rollout.py``).

With scheduled sampling off, step t of the autoregressive rollout conditions
only on ground-truth frame t, so the rollout is one generator call over all
(sample, timestep) pairs folded into a B*T batch (:func:`rollout_teacher_forced`;
``time_chunk`` bounds it to B*c). GroupNorm is per sample, so the fold gives
each transition exactly what a step-by-step loop would. With scheduled
sampling on, :func:`rollout_generator` runs the T steps in turn, each
conditioned on a per-example mix of the ground truth and the previous
prediction, differentiated through that carry (backpropagation through time).

``remat`` checkpoints each generator call (``torch.utils.checkpoint``,
non-reentrant): its activations are dropped after the forward and recomputed
in the backward, so the forward kernels launch twice. The generator draws no
random numbers, so the recompute needs no saved RNG state.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint


def scheduled_sampling_prob(step: int, tcfg) -> float:
    """Linear anneal from ss_start_prob to ss_end_prob over ss_decay_steps:
    the probability of feeding the model its own prediction; 0 with
    scheduled sampling off (pure teacher forcing)."""
    if not tcfg.scheduled_sampling:
        return 0.0
    frac = min(max(step / max(tcfg.ss_decay_steps, 1), 0.0), 1.0)
    return tcfg.ss_start_prob + frac * (tcfg.ss_end_prob - tcfg.ss_start_prob)


def _call(g_apply, remat: bool, *args):
    if remat:
        return checkpoint(g_apply, *args, use_reentrant=False, preserve_rng_state=False)
    return g_apply(*args)


def time_chunk_size(t: int, time_chunk: int) -> int:
    """The chunk the fold runs: the largest divisor of ``t`` that is at most
    ``time_chunk``; ``t`` (the whole fold) for 0 or a chunk of ``t`` or more."""
    c = time_chunk if 0 < time_chunk < t else t
    while t % c:
        c -= 1
    return c


def rollout_teacher_forced(
    g_apply: Callable[..., torch.Tensor],
    g_params: Any,
    frames: torch.Tensor,  # (B, T+1, H, W, C) ground truth in [-1, 1]
    actions: torch.Tensor,  # (B, T, A)
    states: Optional[torch.Tensor],  # (B, T, S) or None
    time_chunk: int = 0,
    remat: bool = False,
) -> torch.Tensor:
    """Teacher-forced rollout -> (B, T, H, W, C). ``g_apply(params, frame,
    action, state)``.

    ``time_chunk`` 0 folds all of T into one (B*T) call; otherwise T/c calls
    of folded (B*c) batches in time-chunk-major order, c the largest divisor
    of T at most ``time_chunk``. ``remat`` checkpoints each call (or the one
    fold)."""
    b, tp1 = frames.shape[:2]
    t = tp1 - 1
    c = time_chunk_size(t, time_chunk)
    n = t // c

    def chunked(x):
        """(B, T, ...) -> (n, B*c, ...), time-chunk-major."""
        if x is None:
            return None
        x = x.reshape((b, n, c) + tuple(x.shape[2:])).transpose(0, 1)
        return x.reshape((n, b * c) + tuple(x.shape[3:]))

    xs = [chunked(frames[:, :t]), chunked(actions), chunked(states)]
    preds = torch.stack([
        _call(g_apply, remat, g_params, xs[0][i], xs[1][i], None if states is None else xs[2][i])
        for i in range(n)
    ])  # (n, B*c, H, W, C)
    preds = preds.reshape((n, b, c) + tuple(preds.shape[2:])).transpose(0, 1)
    return preds.reshape((b, t) + tuple(preds.shape[3:]))


def draw_use_pred(generator: Optional[torch.Generator], b: int, t: int, ss_prob: float,
                  device=None) -> torch.Tensor:
    """(B, T) bool: per example and step, whether the rollout feeds the
    model its own previous prediction; Bernoulli(``ss_prob``), drawn from
    ``generator`` on ``device``."""
    return torch.rand((b, t), generator=generator, device=device) < ss_prob


def rollout_generator(
    g_apply: Callable[..., torch.Tensor],
    g_params: Any,
    frames: torch.Tensor,  # (B, T+1, H, W, C) ground truth in [-1, 1]
    actions: torch.Tensor,  # (B, T, A)
    states: Optional[torch.Tensor],  # (B, T, S) or None
    use_pred: torch.Tensor,  # (B, T) bool
    remat: bool = False,
) -> torch.Tensor:
    """The generator unrolled T steps -> (B, T, H, W, C).

    Step t's input is ``where(use_pred[:, t], carry, frame_t)``; the carry
    starts at frame 0 (so step 0 always sees the ground truth) and is each
    prediction cast to the frames' dtype. Gradients flow through the carry
    into the earlier steps. ``remat`` checkpoints each step's call."""
    t = actions.shape[1]
    carry, preds = frames[:, 0], []
    for i in range(t):
        inp = torch.where(use_pred[:, i, None, None, None], carry, frames[:, i])
        pred = _call(g_apply, remat, g_params, inp, actions[:, i],
                     None if states is None else states[:, i])
        preds.append(pred)
        carry = pred.to(frames.dtype)
    return torch.stack(preds, dim=1)
