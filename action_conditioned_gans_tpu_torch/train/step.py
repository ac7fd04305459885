"""The fused G+D training step (port of the JAX package's ``train/step.py``).

One step, with the JAX package's semantics:

1. ONE generator forward, teacher-forced and folded over B*T, kept with its
   graph (the JAX ``jax.vjp``);
2. D's loss and gradient on real vs detached fake transitions, both halves
   in ONE discriminator call, then D's Adam update (``disc_steps`` times);
3. G's adversarial + ``recon_weight`` * reconstruction loss against the
   UPDATED D. D's parameters are frozen for this call (no D weight gradient
   is computed, as in JAX): the head is differentiated with respect to the
   predictions only, and that cotangent is chained into G through the saved
   forward. Then G's Adam update.

On CUDA every conv block runs its Hopper kernel forward and, for a GroupNorm
layer, the GroupNorm+activation backward kernel (``ops/kernels``); on the CPU
the plain versions.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch
from torch.func import functional_call

from action_conditioned_gans_tpu_torch.config import Config, check_ported_train, resolve_device
from action_conditioned_gans_tpu_torch.models import Discriminator, Generator
from action_conditioned_gans_tpu_torch.train import losses as L
from action_conditioned_gans_tpu_torch.train.rollout import (
    rollout_teacher_forced,
    scheduled_sampling_prob,
)
from action_conditioned_gans_tpu_torch.train.state import TrainState, global_norm, make_optimizers


def _fold_time(x):
    """(B, T, ...) -> (B*T, ...): D sees every transition as one batch."""
    return None if x is None else x.reshape((-1,) + tuple(x.shape[2:]))


def make_train_step(cfg: Config, device=None):
    """Build the step: ``(TrainState, batch) -> (TrainState, metrics)``.

    The batch is the JAX package's clip layout, numpy arrays or tensors:
    ``frames`` (B, T+1, H, W, C) in [-1, 1], ``actions`` (B, T, A), and
    ``states`` (B, T, S) when ``cfg.model.state_dim`` > 0. The step runs on
    ``cuda`` unless another ``device`` is given; the state must live there.
    It updates the state's parameter and moment tensors in place and returns
    the state with ``step`` + 1, plus the metrics as 0-d float32 tensors under
    the JAX package's keys.
    """
    check_ported_train(cfg)
    m, t = cfg.model, cfg.train
    if t.gan_loss not in ("ce", "hinge"):
        raise ValueError(f"unknown gan_loss {t.gan_loss!r} (expected 'ce' or 'hinge')")
    if t.gan_loss == "hinge" and t.d_label_smooth > 0:
        raise ValueError("d_label_smooth is a cross-entropy concept; unset it or use gan_loss='ce'")
    dev = resolve_device(device)
    # The modules give structure only; the parameters come from the state.
    gen = Generator(m).to(dev)
    disc = Discriminator(m).to(dev)
    g_tx, d_tx = make_optimizers(cfg)

    def g_apply(params, frame, action, state):
        return functional_call(gen, params, (frame, action, state))

    def d_apply(params, next_frame, frame, action, state):
        return functional_call(disc, params, (
            next_frame,
            frame if m.d_condition_frame else None,
            action if m.d_condition_action else None,
            state,
        ))

    def tensor(a):
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.array(a, dtype=np.float32))
        return a.to(dev, torch.float32).contiguous()

    def leaves(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Fresh autograd leaves sharing the parameters' storage."""
        return {k: v.detach().requires_grad_() for k, v in params.items()}

    def adv_loss_d(real_logits, fake_logits):
        if t.gan_loss == "hinge":
            return L.discriminator_hinge_loss(real_logits, fake_logits)
        return L.discriminator_loss(real_logits, fake_logits, t.d_label_smooth)

    def adv_loss_g(fake_logits):
        if t.gan_loss == "hinge":
            return L.generator_hinge_adv_loss(fake_logits)
        return L.generator_adv_loss(fake_logits)

    def train_step(state: TrainState, batch):
        where = next(iter(state.g_params.values())).device
        if where.type != dev.type or dev.index not in (None, where.index):
            raise ValueError(f"the train state is on {where}, the step on {dev}")
        frames = tensor(batch["frames"])
        actions = tensor(batch["actions"])
        states = tensor(batch["states"]) if m.state_dim else None
        horizon = actions.shape[1]
        ss_prob = scheduled_sampling_prob(state.step, t)

        # One generator forward, kept with its graph for G's update.
        g_leaves = leaves(state.g_params)
        preds = rollout_teacher_forced(g_apply, g_leaves, frames, actions, states)
        flat_preds = _fold_time(preds)

        cond_frames = _fold_time(frames[:, :horizon])
        real_next = _fold_time(frames[:, 1:])
        flat_actions = _fold_time(actions)
        flat_states = _fold_time(states)

        # D update(s) on the detached fakes; real and fake share one D call.
        two = lambda x: None if x is None else torch.cat([x, x])  # noqa: E731
        both = torch.cat([real_next, flat_preds.detach().float()])
        for _ in range(max(t.disc_steps, 1)):
            d_leaves = leaves(state.d_params)
            logits = d_apply(d_leaves, both, two(cond_frames), two(flat_actions), two(flat_states))
            real_logits, fake_logits = logits.chunk(2)
            d_loss = adv_loss_d(real_logits, fake_logits)
            real_acc, fake_acc = L.discriminator_accuracy(real_logits, fake_logits)
            d_grads = torch.autograd.grad(d_loss, list(d_leaves.values()))
            d_tx.update_(state.d_params, d_grads, state.d_opt)

        # G head against the updated, frozen D: differentiate w.r.t. the
        # predictions only, then chain that cotangent through G's forward
        # (preds.backward(d_preds), with the gradients returned).
        d_frozen = {k: v.detach() for k, v in state.d_params.items()}
        preds_in = flat_preds.detach().requires_grad_()
        fake_logits = d_apply(d_frozen, preds_in, cond_frames, flat_actions, flat_states)
        g_adv = adv_loss_g(fake_logits)
        g_recon = L.reconstruction_loss(preds_in, real_next, t.recon_type)
        g_loss = g_adv + t.recon_weight * g_recon
        (d_preds,) = torch.autograd.grad(g_loss, preds_in)
        g_grads = torch.autograd.grad(flat_preds, list(g_leaves.values()), d_preds)
        g_tx.update_(state.g_params, g_grads, state.g_opt)

        metrics = {
            "d_loss": d_loss, "g_loss": g_loss, "g_adv": g_adv, "g_recon": g_recon,
            "d_real_acc": real_acc, "d_fake_acc": fake_acc,
        }
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["ss_prob"] = torch.tensor(ss_prob, dtype=torch.float32, device=dev)
        if t.log_grad_norms:
            # Pre-clip global norms; D's is the last disc_steps iteration's.
            metrics["g_grad_norm"] = global_norm(g_grads)
            metrics["d_grad_norm"] = global_norm(d_grads)
        return dataclasses.replace(state, step=state.step + 1), metrics

    return train_step


def make_multi_train_step(cfg: Config, device=None):
    """k = ``cfg.train.steps_per_call`` fused steps a call, in sequence, over
    a stacked batch whose leaves have a leading (k, ...) axis; returns the
    LAST step's metrics (the JAX package's ``lax.scan`` of the step). With
    k <= 1 this is the single step over an unstacked batch."""
    step = make_train_step(cfg, device)
    k = cfg.train.steps_per_call
    if k <= 1:
        return step

    def multi(state: TrainState, batches):
        for key, leaf in batches.items():
            if leaf.shape[0] != k:
                raise ValueError(f"batch leaf {key!r} has {leaf.shape[0]} steps on its leading "
                                 f"axis, want steps_per_call={k}")
        metrics = None
        for i in range(k):
            state, metrics = step(state, {key: leaf[i] for key, leaf in batches.items()})
        return state, metrics

    return multi
