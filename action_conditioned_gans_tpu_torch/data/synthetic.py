"""Seeded synthetic pushing-style clips, made on the device (port of the JAX
package's ``data/synthetic.py``).

A pusher (the end effector) moves under a 4-dim action; when it touches the
object, the object is carried along. Each clip has the BAIR-robot-pushing
TFRecord schema: frames, 4-dim actions and the 3-dim end-effector state.

Actions: a[0], a[1] move the pusher (dx, dy in normalised image
coordinates); a[2] (grip) scales the pusher's rendered half-size; a[3]
(push strength) scales how far a touched object is carried. With fewer
dims, strength is 1 and grip is 0. State = (pusher_x, pusher_y, grip).

The generator is split in two. :func:`draw_clip_randoms` draws, in a fixed
order, the five random arrays the JAX ``_single_clip`` draws;
:func:`render_clips` is everything else, deterministic: the smoothed
actions, the contact dynamics (one loop over time, vectorised over clips),
the states and the render. JAX's threefry stream cannot be reproduced by a
``torch.Generator``, so the port's clips differ from the JAX package's;
the split lets the physics and the render be held against JAX on the same
random arrays all the same.

A ``torch.Generator`` draws on its own device: a CPU generator (mt19937)
and a CUDA one (Philox) give different streams, so the same seed makes
different clips on the CPU and on the card. Everything stays on the
generator's device; a batch never touches the host.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from action_conditioned_gans_tpu_torch.config import resolve_device
from action_conditioned_gans_tpu_torch.parallel.mesh import shard_rows

# World constants (normalised [0, 1] coordinates).
_PUSHER_HALF = 0.06
_OBJECT_HALF = 0.09
_CONTACT = _PUSHER_HALF + _OBJECT_HALF
_MARGIN = 0.08
_EDGE_SHARPNESS = 60.0  # softness of the rendered squares' edges
_PUSHER_COLOR = (0.85, 0.85, 0.9)
_FRAME_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def draw_clip_randoms(generator: torch.Generator, n: int, seq_len: int,
                      action_dim: int) -> Dict[str, torch.Tensor]:
    """The random arrays of ``n`` clips, drawn from ``generator`` in this
    order: the background gradient ``g`` (n, 2, 3) and colour ``base`` (n, 3),
    ``obj_color`` (n, 3), the pusher's and the object's start ``positions``
    (n, 2, 2) and the action ``noise`` (n, T-1, A), float32 on the
    generator's device (a generator draws only there)."""
    dev = generator.device

    def uniform(shape, lo, hi):
        return torch.rand(shape, generator=generator, device=dev) * (hi - lo) + lo

    g = uniform((n, 2, 3), 0.0, 0.35)
    base = uniform((n, 3), 0.15, 0.45)
    obj_color = uniform((n, 3), 0.3, 1.0)
    positions = uniform((n, 2, 2), 2 * _MARGIN, 1 - 2 * _MARGIN)
    noise = torch.randn((n, seq_len - 1, action_dim), generator=generator, device=dev) * 0.6
    return dict(g=g, base=base, obj_color=obj_color, positions=positions, noise=noise)


def _soft_square_1d(coords: torch.Tensor, center: torch.Tensor, half) -> torch.Tensor:
    """One axis of the soft square mask: (..., S) in [0, 1]."""
    return torch.sigmoid((half - (coords - center[..., None]).abs()) * _EDGE_SHARPNESS)


def render_clips(randoms: Dict[str, torch.Tensor], seq_len: int, image_size: int,
                 action_dim: int) -> Dict[str, torch.Tensor]:
    """The deterministic part of the generator: ``randoms`` (from
    :func:`draw_clip_randoms`) -> frames (n, T, H, W, 3) float32 in [-1, 1],
    actions (n, T-1, A) and states (n, T-1, 3) at each transition's source
    frame."""
    noise, positions = randoms["noise"], randoms["positions"]
    n, dev = noise.shape[0], noise.device
    t = seq_len - 1

    # Smooth random-walk actions, scaled to a plausible per-step displacement.
    v = torch.zeros((n, action_dim), device=dev)
    acts = []
    for i in range(t):
        v = 0.7 * v + 0.3 * noise[:, i]
        acts.append(v)
    acts = torch.stack(acts, dim=1) if t else noise
    scale = torch.ones(action_dim, device=dev)
    scale[:2] = 0.07
    actions = torch.tanh(acts) * scale

    # Contact dynamics: a pusher that overlaps the object's box after its
    # move carries the object, scaled by the push-strength dim.
    pusher, obj = positions[:, 0], positions[:, 1]
    pushers, objs, grips = [pusher], [obj], [torch.zeros(n, device=dev)]
    for i in range(t):
        action = actions[:, i]
        delta = action[:, :2]
        pusher = (pusher + delta).clamp(_MARGIN, 1 - _MARGIN)
        gap = (obj - pusher).abs().amax(dim=-1)
        strength = 1.0 + 0.5 * torch.tanh(action[:, 3:4]) if action_dim > 3 else 1.0
        pushed = (obj + delta * strength).clamp(_MARGIN, 1 - _MARGIN)
        obj = torch.where((gap < _CONTACT)[:, None], pushed, obj)
        pushers.append(pusher)
        objs.append(obj)
        grips.append(action[:, 2] if action_dim > 2 else torch.zeros(n, device=dev))
    pushers, objs, grips = (torch.stack(x, dim=1) for x in (pushers, objs, grips))
    # states[t]: the end effector AT source frame t (before action t), as the
    # file readers slice it.
    states = torch.stack([pushers[:, :-1, 0], pushers[:, :-1, 1], grips[:, :-1]], dim=-1)

    # Render: background, then the object, then the pusher. A square's mask
    # is the product of its row and column profiles.
    coords = (torch.arange(image_size, dtype=torch.float32, device=dev) + 0.5) / image_size
    g, base, obj_color = randoms["g"], randoms["base"], randoms["obj_color"]
    bg = (base[:, None, None] + coords[:, None, None] * g[:, None, None, 0]
          + coords[None, :, None] * g[:, None, None, 1])  # (n, H, W, 3)

    def mask(pos, half):  # (n, T, 2) -> (n, T, H, W, 1)
        rows = _soft_square_1d(coords, pos[..., 0], half)
        cols = _soft_square_1d(coords, pos[..., 1], half)
        return (rows[..., :, None] * cols[..., None, :])[..., None]

    obj_mask = mask(objs, _OBJECT_HALF)
    pusher_mask = mask(pushers, (_PUSHER_HALF * (1.0 + 0.5 * torch.tanh(grips)))[..., None])
    frame = bg[:, None] * (1 - obj_mask) + obj_color[:, None, None, None] * obj_mask
    color = torch.tensor(_PUSHER_COLOR, device=dev)
    frame = frame * (1 - pusher_mask) + color * pusher_mask
    frames = frame.clamp(0.0, 1.0) * 2.0 - 1.0
    return dict(frames=frames, actions=actions, states=states)


def generate_clips(generator: torch.Generator, batch: int, seq_len: int, image_size: int,
                   action_dim: int = 4, with_state: bool = True) -> Dict[str, torch.Tensor]:
    """A batch of clips on the generator's device: frames (B, seq_len, H, W, 3)
    float32 in [-1, 1], actions (B, seq_len-1, A) and, with ``with_state``,
    states (B, seq_len-1, 3)."""
    randoms = draw_clip_randoms(generator, batch, seq_len, action_dim)
    out = render_clips(randoms, seq_len, image_size, action_dim)
    if not with_state:
        del out["states"]
    return out


def batch_seed(seed: int, index: int) -> int:
    """The generator seed of batch ``index``: a pure function of (seed, index)."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1, np.uint64)[0])


class SyntheticClips:
    """A seeded, index-addressed batch stream on ``device`` (cuda unless
    another device is given).

    Batch i is a pure function of (seed, i) on a given device type, whatever
    was asked before it, so a resumed run meets the batches an uninterrupted
    one would. ``stack`` = k makes k*B clips in one call and returns them as
    (k, B, ...) for the multi-step train step. Frames are cast to
    ``frames_dtype`` after generation.

    With ``num_hosts`` > 1, host ``host_id`` gets its rows of each step's
    batch of ``batch`` clips (``parallel.mesh.shard_rows``), bit for bit
    those of the one-host stream: every host draws the randoms of the whole
    batch (cheap) and renders only its own clips (a clip's render is its
    own).
    """

    def __init__(self, batch: int, seq_len: int, image_size: int, action_dim: int = 4,
                 with_state: bool = True, seed: int = 0, stack: int = 1,
                 frames_dtype: str = "float32", device=None, host_id: int = 0,
                 num_hosts: int = 1):
        if frames_dtype not in _FRAME_DTYPES:
            raise ValueError(f"unsupported frames_dtype {frames_dtype!r}")
        self.batch, self.seq_len, self.image_size = batch, seq_len, image_size
        self.action_dim, self.with_state, self.seed = action_dim, with_state, seed
        self.stack = max(stack, 1)
        self.frames_dtype = _FRAME_DTYPES[frames_dtype]
        self.device = resolve_device(device)
        self.rows = shard_rows(batch, host_id, num_hosts)

    def batch_at(self, index: int) -> Dict[str, torch.Tensor]:
        generator = torch.Generator(self.device)
        generator.manual_seed(batch_seed(self.seed, index))
        randoms = draw_clip_randoms(generator, self.batch * self.stack, self.seq_len,
                                    self.action_dim)
        local = self.rows.stop - self.rows.start
        if local != self.batch:
            randoms = {k: v.reshape((self.stack, self.batch) + tuple(v.shape[1:]))[:, self.rows]
                       .reshape((self.stack * local,) + tuple(v.shape[1:]))
                       for k, v in randoms.items()}
        out = render_clips(randoms, self.seq_len, self.image_size, self.action_dim)
        if not self.with_state:
            del out["states"]
        if self.stack > 1:
            out = {k: v.reshape((self.stack, local) + tuple(v.shape[1:]))
                   for k, v in out.items()}
        out["frames"] = out["frames"].to(self.frames_dtype)
        return out

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        i = 0
        while True:
            yield self.batch_at(i)
            i += 1


