"""Differentiable D-input augmentation (port of the JAX package's
``train/augment.py``; the DiffAugment genre, Zhao et al. 2020).

The discriminator's real and fake inputs are both augmented with
differentiable transforms, so gradients flow through the transform to the
generator. The randomness is drawn up front as one ``(N, K)`` uniform tensor
(``n_params`` scalars a sample for the policy), and :func:`apply` is a
deterministic function of it: the rows chunk with their images under
discriminator microbatching, and the tests feed it the values JAX draws. The
conditioning frame gets the SAME per-sample transform as its paired next
frame.

Ops (inputs in [-1, 1], NHWC):

* ``color``: per-sample brightness (+-0.5), saturation (x[0, 2) around the
  per-pixel channel mean), contrast (x[0.5, 1.5) around the per-sample
  mean). 3 scalars.
* ``translation``: integer shift dy, dx in [-ceil(H/8), ceil(H/8)], zero
  padding. 2 scalars.
* ``cutout``: zero a ceil(H/2) x ceil(W/2) box at a random position. 2
  scalars.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

_OPS = ("color", "translation", "cutout")
_N_PARAMS = {"color": 3, "translation": 2, "cutout": 2}


def parse_policy(policy: str) -> Tuple[str, ...]:
    """'color,translation,cutout' -> the validated op tuple ('' -> ())."""
    if not policy:
        return ()
    ops = tuple(p.strip() for p in policy.split(",") if p.strip())
    for op in ops:
        if op not in _OPS:
            raise ValueError(f"unknown d_augment op {op!r} (expected a comma-list of {_OPS})")
    return ops


def n_params(ops: Tuple[str, ...]) -> int:
    return sum(_N_PARAMS[op] for op in ops)


def draw_params(generator: Optional[torch.Generator], ops: Tuple[str, ...], n: int,
                device=None) -> Optional[torch.Tensor]:
    """(n, n_params) uniform [0, 1) float32 draws from ``generator`` on
    ``device``; None for the empty policy."""
    if not ops:
        return None
    return torch.rand((n, n_params(ops)), generator=generator, device=device,
                      dtype=torch.float32)


def _color(x, u):
    x = x + (u[:, 0] - 0.5)[:, None, None, None]
    m_pix = x.mean(dim=-1, keepdim=True)
    x = m_pix + (x - m_pix) * (u[:, 1] * 2.0)[:, None, None, None]
    m = x.mean(dim=(1, 2, 3), keepdim=True)
    return m + (x - m) * (u[:, 2] + 0.5)[:, None, None, None]


def _translation(x, u):
    n, h, w, _ = x.shape
    sh, sw = -(-h // 8), -(-w // 8)
    # dy, dx in [-s, s]: floor(u * (2s + 1)) - s (u < 1 keeps it in range).
    dy = torch.floor(u[:, 0] * (2 * sh + 1)).long() - sh
    dx = torch.floor(u[:, 1] * (2 * sw + 1)).long() - sw
    padded = F.pad(x, (0, 0, sw, sw, sh, sh))
    rows = (sh + dy)[:, None] + torch.arange(h, device=x.device)[None]  # (n, h)
    cols = (sw + dx)[:, None] + torch.arange(w, device=x.device)[None]  # (n, w)
    return padded[torch.arange(n, device=x.device)[:, None, None], rows[:, :, None],
                  cols[:, None, :]]


def _cutout(x, u):
    n, h, w, _ = x.shape
    ch, cw = -(-h // 2), -(-w // 2)
    # Top-left corner in [0, h - ch] x [0, w - cw].
    ty = torch.floor(u[:, 0] * (h - ch + 1)).long()[:, None, None]
    tx = torch.floor(u[:, 1] * (w - cw + 1)).long()[:, None, None]
    ys = torch.arange(h, device=x.device)[None, :, None]
    xs = torch.arange(w, device=x.device)[None, None, :]
    inside = (ys >= ty) & (ys < ty + ch) & (xs >= tx) & (xs < tx + cw)  # (n, h, w)
    return x * (~inside)[..., None].to(x.dtype)


_APPLY = {"color": _color, "translation": _translation, "cutout": _cutout}


def apply(ops: Tuple[str, ...], u: Optional[torch.Tensor], imgs: torch.Tensor,
          pair: Optional[torch.Tensor] = None):
    """The policy with pre-drawn parameters ``u`` (from :func:`draw_params`),
    computed in float32 and cast back: ``(imgs_aug, pair_aug)``, the pair
    (the conditioning frame) given the same per-sample transform, None when
    none is given. Differentiable with respect to ``imgs`` and ``pair``."""
    if not ops or u is None:
        return imgs, pair
    x = imgs.float()
    p = pair.float() if pair is not None else None
    off = 0
    for op in ops:
        cols = u[:, off:off + _N_PARAMS[op]]
        x = _APPLY[op](x, cols)
        if p is not None:
            p = _APPLY[op](p, cols)
        off += _N_PARAMS[op]
    return x.to(imgs.dtype), (p.to(pair.dtype) if p is not None else None)
