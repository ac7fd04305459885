"""Sampling and evaluation (port of the JAX package's ``train/sample.py``).

``make_rollout_fn`` is the fully autoregressive rollout (every step after
the first conditions on the previous prediction: scheduled sampling at
probability 1), run with the training generator's parameters.
``eval_metrics`` computes L2 / L1 / PSNR / SSIM on the host in numpy, as the
JAX package does; the port keeps its own copy of the SSIM helpers.
``evaluate`` averages them over held-out batches; ``sample`` also writes PNG
grids, GIFs and comparison strips (``utils/images.py``). Both run on the
device of the state's parameters.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterator, Optional

import numpy as np
import torch
from torch.func import functional_call

from action_conditioned_gans_tpu_torch.config import Config, resolve_device
from action_conditioned_gans_tpu_torch.data.pipeline import FILE_SOURCES, make_dataset
from action_conditioned_gans_tpu_torch.data.synthetic import SyntheticClips
from action_conditioned_gans_tpu_torch.infer import rollout_scan
from action_conditioned_gans_tpu_torch.models import Generator
from action_conditioned_gans_tpu_torch.train.state import TrainState
from action_conditioned_gans_tpu_torch.utils.images import (
    save_gif,
    save_image_grid,
    save_rollout_strip,
)


def make_rollout_fn(cfg: Config, device=None):
    """``(g_params, batch) -> preds`` (B, T, H, W, C): the generator rolled
    out over the batch's T actions from its first frame, feeding each
    prediction back; ``g_params`` is a TrainState's ``g_params``. Runs on
    ``device`` (cuda unless another device is given)."""
    gen = Generator(cfg.model).to(resolve_device(device))

    def fn(g_params, batch):
        states = batch.get("states") if cfg.model.state_dim else None
        apply = lambda f, a, s: functional_call(gen, g_params, (f, a, s))  # noqa: E731
        # frames[:, 0] is a strided view: the kernels read contiguous NHWC,
        # and a cast to the compute dtype copies only when the dtype differs.
        with torch.no_grad():
            return rollout_scan(apply, batch["frames"][:, 0].contiguous(), batch["actions"],
                                states)

    return fn


def _gaussian_window(size: int, sigma: float) -> np.ndarray:
    r = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    w = np.exp(-(r**2) / (2.0 * sigma**2))
    return w / w.sum()


def _filter_axis(x: np.ndarray, w: np.ndarray, axis: int) -> np.ndarray:
    """Valid-mode 1-D correlation with window ``w`` along ``axis``."""
    n, k = x.shape[axis], len(w)
    out = None
    for i in range(k):
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(i, n - k + 1 + i)
        term = w[i] * x[tuple(sl)]
        out = term if out is None else out + term
    return out


def _ssim(p: np.ndarray, t: np.ndarray, window: int = 11, sigma: float = 1.5) -> float:
    """SSIM (Wang et al. 2004) with an 11x11 Gaussian window (sigma 1.5) over
    valid positions, per channel, averaged; inputs in [-1, 1] (L = 2). The
    window shrinks to the largest odd size within H and W."""
    c1, c2 = (0.01 * 2) ** 2, (0.03 * 2) ** 2
    h, w_ = p.shape[-3], p.shape[-2]
    win = min(window, h, w_)
    if win % 2 == 0:
        win -= 1
    g = _gaussian_window(win, sigma)

    def filt(x):
        x = x.astype(np.float64)
        return _filter_axis(_filter_axis(x, g, x.ndim - 3), g, x.ndim - 2)

    mu_p, mu_t = filt(p), filt(t)
    var_p = filt(p * p) - mu_p**2
    var_t = filt(t * t) - mu_t**2
    cov = filt(p * t) - mu_p * mu_t
    ssim = ((2 * mu_p * mu_t + c1) * (2 * cov + c2)) / (
        (mu_p**2 + mu_t**2 + c1) * (var_p + var_t + c2)
    )
    return float(ssim.mean())


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, np.float32)


def eval_metrics(preds, targets) -> Dict[str, float]:
    """L2 / L1 / PSNR / SSIM between predicted and ground-truth frames in
    [-1, 1] (tensors or arrays)."""
    p, t = _host(preds), _host(targets)
    mse = float(np.mean((p - t) ** 2))
    l1 = float(np.mean(np.abs(p - t)))
    # PSNR on the [0, 1] scale (peak 1 after the /2 denormalisation).
    psnr = float(10 * np.log10(4.0 / max(mse, 1e-12)))
    return {"eval_l2": mse, "eval_l1": l1, "eval_psnr": psnr, "eval_ssim": _ssim(p, t)}


def held_out_batches(cfg: Config, batch_size: int, horizon: int, seed: int,
                     device=None) -> Iterator[Dict[str, torch.Tensor]]:
    """Held-out clips of ``horizon + 1`` frames from the configured source.

    Synthetic: seeded apart from the training stream by the caller (the loop
    passes ``train.seed + 7919``). File sources read ``data.eval_data_dir``,
    a held-out split, or ``data.data_dir`` (the training clips) when it is
    unset, with the batch, horizon and seed replaced. The reader is closed
    when the generator is (``close()``, or when it is collected): its fill
    thread stops only then."""
    if cfg.data.source not in FILE_SOURCES:
        yield from SyntheticClips(batch_size, horizon + 1, cfg.model.image_size,
                                  cfg.model.action_dim, seed=seed, device=device)
        return
    eval_cfg = cfg.replace(
        data=dataclasses.replace(cfg.data, data_dir=cfg.data.eval_data_dir or cfg.data.data_dir),
        train=dataclasses.replace(cfg.train, batch_size=batch_size, rollout_length=horizon,
                                  seed=seed))
    ds = make_dataset(eval_cfg, device=device)
    try:
        yield from ds
    finally:
        ds.close()


def _device(state: TrainState) -> torch.device:
    return next(iter(state.g_params.values())).device


def evaluate(cfg: Config, state: TrainState, num_batches: int = 8, batch_size: int = 16,
             horizon: Optional[int] = None, seed: int = 1234) -> Dict[str, float]:
    """Mean L1 / L2 / PSNR / SSIM of fully autoregressive rollouts over
    ``num_batches`` held-out batches (no image export), with
    ``eval_batches`` and ``eval_horizon``."""
    horizon = horizon or max(cfg.train.rollout_length, 1)
    dev = _device(state)
    fn = make_rollout_fn(cfg, dev)
    stream = held_out_batches(cfg, batch_size, horizon, seed, device=dev)
    acc: Dict[str, float] = {}
    try:
        for _ in range(num_batches):
            batch = next(stream)
            m = eval_metrics(fn(state.g_params, batch), batch["frames"][:, 1:])
            for k, v in m.items():
                acc[k] = acc.get(k, 0.0) + v / num_batches
    finally:
        stream.close()
    acc["eval_batches"] = num_batches
    acc["eval_horizon"] = horizon
    return acc


def sample(cfg: Config, state: TrainState, out_dir: str, num_clips: int = 8,
           horizon: Optional[int] = None, seed: int = 1234) -> Dict[str, float]:
    """Roll out ``num_clips`` held-out clips, write ``pred_final_frame.png``
    and ``gt_final_frame.png`` (grids of the last frames) and, for the first
    four clips, ``rollout_{i}.gif`` and ``strip_{i}.png`` (ground truth over
    prediction); return their eval metrics."""
    os.makedirs(out_dir, exist_ok=True)
    horizon = horizon or max(cfg.train.rollout_length, 1)
    dev = _device(state)
    stream = held_out_batches(cfg, num_clips, horizon, seed, device=dev)
    try:
        batch = next(stream)
    finally:
        stream.close()
    preds = _host(make_rollout_fn(cfg, dev)(state.g_params, batch))
    targets = _host(batch["frames"][:, 1:])

    save_image_grid(os.path.join(out_dir, "pred_final_frame.png"), preds[:, -1])
    save_image_grid(os.path.join(out_dir, "gt_final_frame.png"), targets[:, -1])
    for i in range(min(num_clips, 4)):
        save_gif(os.path.join(out_dir, f"rollout_{i}.gif"), preds[i])
        save_rollout_strip(os.path.join(out_dir, f"strip_{i}.png"), targets[i], preds[i])
    return eval_metrics(preds, targets)
