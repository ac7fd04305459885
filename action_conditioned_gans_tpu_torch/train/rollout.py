"""Multi-step rollout of the generator for training (port of ``train/rollout.py``).

With scheduled sampling off, step t of the autoregressive rollout conditions
only on ground-truth frame t, so the rollout is one generator call over all
(sample, timestep) pairs folded into a B*T batch. GroupNorm is per sample, so
the fold gives each transition exactly what a step-by-step loop would.
Scheduled sampling and the time-chunked fold (``rollout_time_chunk``) are not
ported yet (``config.check_ported_train`` refuses them).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import torch


def scheduled_sampling_prob(step: int, tcfg) -> float:
    """Linear anneal from ss_start_prob to ss_end_prob over ss_decay_steps;
    0 with scheduled sampling off (pure teacher forcing)."""
    if not tcfg.scheduled_sampling:
        return 0.0
    frac = min(max(step / max(tcfg.ss_decay_steps, 1), 0.0), 1.0)
    return tcfg.ss_start_prob + frac * (tcfg.ss_end_prob - tcfg.ss_start_prob)


def rollout_teacher_forced(
    g_apply: Callable[..., torch.Tensor],
    g_params: Any,
    frames: torch.Tensor,  # (B, T+1, H, W, C) ground truth in [-1, 1]
    actions: torch.Tensor,  # (B, T, A)
    states: Optional[torch.Tensor],  # (B, T, S) or None
) -> torch.Tensor:
    """Teacher-forced rollout as one folded (B*T) generator call ->
    (B, T, H, W, C). ``g_apply(params, frame, action, state)``."""
    b, tp1 = frames.shape[:2]
    t = tp1 - 1

    def fold(x):
        return None if x is None else x.reshape((-1,) + tuple(x.shape[2:]))

    preds = g_apply(g_params, fold(frames[:, :t]), fold(actions), fold(states))
    return preds.reshape((b, t) + tuple(preds.shape[1:]))
