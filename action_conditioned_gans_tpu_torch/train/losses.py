"""GAN and reconstruction losses (port of the JAX package's ``train/losses.py``).

Sigmoid cross-entropy in the softplus form (``d_loss = CE(D(real), 1) +
CE(D(fake), 0)``, non-saturating ``g_adv = CE(D(fake), 1)``), the hinge pair,
L2 / L1 reconstruction and D's accuracy. Everything reduces in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) without a threshold, as ``jax.nn.softplus``."""
    return torch.logaddexp(x, torch.zeros_like(x))


def discriminator_loss(
    real_logits: torch.Tensor, fake_logits: torch.Tensor, real_label_smooth: float = 0.0
) -> torch.Tensor:
    """CE(D(real), 1 - eps) + CE(D(fake), 0): one-sided label smoothing
    softens only the real targets; eps = 0 is the plain loss."""
    rl = real_logits.float()
    fake = _softplus(fake_logits.float()).mean()
    if real_label_smooth == 0.0:
        return _softplus(-rl).mean() + fake
    eps = real_label_smooth
    return ((1.0 - eps) * _softplus(-rl) + eps * _softplus(rl)).mean() + fake


def generator_adv_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    """Non-saturating CE(D(fake), 1) == softplus(-fake)."""
    return _softplus(-fake_logits.float()).mean()


def discriminator_hinge_loss(real_logits: torch.Tensor, fake_logits: torch.Tensor) -> torch.Tensor:
    """E[relu(1 - D(real))] + E[relu(1 + D(fake))]."""
    return F.relu(1.0 - real_logits.float()).mean() + F.relu(1.0 + fake_logits.float()).mean()


def generator_hinge_adv_loss(fake_logits: torch.Tensor) -> torch.Tensor:
    """-E[D(fake)]."""
    return -fake_logits.float().mean()


def reconstruction_loss(pred: torch.Tensor, target: torch.Tensor, kind: str = "l2") -> torch.Tensor:
    diff = pred.float() - target.float()
    if kind == "l2":
        return diff.square().mean()
    if kind == "l1":
        return diff.abs().mean()
    raise ValueError(f"unknown reconstruction loss {kind!r}")


def discriminator_accuracy(real_logits: torch.Tensor, fake_logits: torch.Tensor):
    """Fractions of real (fake) examples D classifies correctly."""
    return (real_logits > 0).float().mean(), (fake_logits < 0).float().mean()
