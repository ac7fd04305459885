"""The inputs both sides get, made from the run's seed on the device: the
weights (in the Flax init distribution, in one large draw per model) and
the banks of clip batches and planner requests.

Seeds are any whole number: each draw takes a 64-bit seed of its own from
``SeedSequence([seed, tag])``, so the same seed gives the same inputs and
two tags never share a stream.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

TAGS = {"g": 1, "d": 2, "train_bank": 3, "requests": 4, "sample": 5}


def sub_seed(seed: int, tag: str) -> int:
    return int(np.random.SeedSequence([seed % 2**64, TAGS[tag]]).generate_state(1, np.uint64)[0])


def generator(seed: int, tag: str, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, tag))
    return gen


def make_params(spec: Mapping[str, Tuple[tuple, str]], seed: int, tag: str,
                device) -> Dict[str, torch.Tensor]:
    """Float32 parameters of ``spec`` (name -> (shape, init)): every
    "normal" leaf a slice of one truncated-normal draw (std 0.02, cut at 2
    std, as Flax's ``truncated_normal``), "ones" and "zeros" filled."""
    names = sorted(spec)
    sizes = [math.prod(spec[n][0]) if spec[n][1] == "normal" else 0 for n in names]
    flat = torch.empty(sum(sizes), device=device)
    torch.nn.init.trunc_normal_(flat, std=0.02, a=-0.04, b=0.04,
                                generator=generator(seed, tag, device))
    out, at = {}, 0
    for name, size in zip(names, sizes):
        shape, init = spec[name]
        if init == "normal":
            out[name] = flat[at:at + size].view(shape)
            at += size
        else:
            out[name] = (torch.ones if init == "ones" else torch.zeros)(shape, device=device)
    return out


def train_bank(cfg: Mapping, n: int, seed: int, device) -> list:
    """``n`` stacked batches of ``steps_per_call`` steps: frames (k, B,
    T+1, H, W, C) and actions (k, B, T, A), uniform in [-1, 1], float32,
    every row distinct."""
    m, t = cfg["model"], cfg["train"]
    k, b, horizon = max(t["steps_per_call"], 1), t["batch_size"], max(t["rollout_length"], 1)
    size, c = m["image_size"], m["image_channels"]
    gen = generator(seed, "train_bank", device)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=device).mul_(2).sub_(1)

    bank = []
    for _ in range(n):
        frames = uniform(k, b, horizon + 1, size, size, c)
        actions = uniform(k, b, horizon, m["action_dim"])
        bank.append({"frames": frames if k > 1 else frames[0],
                     "actions": actions if k > 1 else actions[0]})
    return bank


def requests(cfg: Mapping, n: int, batch: int, horizon: int, seed: int, device) -> list:
    """``n`` planner requests: numpy float32 ``frame0`` (B, H, W, C) and
    ``actions`` (B, T, A) uniform in [-1, 1] (drawn on the device, then
    copied to the host, where a planner holds them), and a goal frame
    (H, W, C) that stays on the device."""
    m = cfg["model"]
    size, c = m["image_size"], m["image_channels"]
    gen = generator(seed, "requests", device)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=device).mul_(2).sub_(1)

    out = []
    for _ in range(n):
        frame0 = uniform(batch, size, size, c)
        actions = uniform(batch, horizon, m["action_dim"])
        out.append({"frame0": frame0.cpu().numpy(), "actions": actions.cpu().numpy(),
                    "goal": uniform(size, size, c)})
    return out
