"""Train state: G / D parameters and two independent Adam states.

Port of the JAX package's ``train/state.py``. Parameters are dictionaries
keyed by the port's ``state_dict`` names (Flax names joined with "."),
float32, on the training device. The optimizer is Adam written here with
``torch._foreach_*`` ops rather than ``torch.optim``, which cannot store bf16
moments for float32 parameters: optax's ``scale_by_adam`` (and the JAX
package's ``scale_by_adam_moment_dtype``) with global-norm clipping before
it. Unlike the JAX state, which is immutable, a step updates the parameter
and moment tensors in place (one copy of each, not two). With
``train.ema_decay`` > 0 the state also holds ``g_ema``, an exponential
moving average of G's parameters (float32), updated after each G step.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from action_conditioned_gans_tpu_torch.config import Config, resolve_device

Params = Dict[str, torch.Tensor]
Schedule = Union[float, Callable[[int], float]]
_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class AdamState:
    count: int
    mu: Params
    nu: Params


@dataclasses.dataclass
class TrainState:
    step: int
    g_params: Params
    d_params: Params
    g_opt: AdamState
    d_opt: AdamState
    g_ema: Optional[Params] = None


# -- learning-rate schedules ---------------------------------------------------


def _linear(init: float, end: float, steps: int) -> Callable[[int], float]:
    """optax.linear_schedule."""
    if steps <= 0:
        return lambda count: init

    def schedule(count):
        frac = 1 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def _cosine(init: float, steps: int, alpha: float) -> Callable[[int], float]:
    """optax.cosine_decay_schedule."""

    def schedule(count):
        decay = 0.5 * (1 + math.cos(math.pi * min(count, steps) / steps))
        return init * ((1 - alpha) * decay + alpha)

    return schedule


def make_lr_schedule(t, peak_lr: float, updates_per_step: int = 1) -> Schedule:
    """TrainConfig's schedule knobs -> a float (constant, no warmup) or a
    function of the optimizer's update count, as the JAX package's optax
    schedule. ``updates_per_step``: updates this optimizer takes per train
    step (D takes ``disc_steps``); horizons scale with it, so warmup and decay
    steps always mean train steps."""
    if t.lr_schedule not in ("constant", "linear", "cosine"):
        raise ValueError(
            f"unknown lr_schedule {t.lr_schedule!r} (expected 'constant', 'linear', or 'cosine')"
        )
    if t.warmup_steps == 0 and t.lr_schedule == "constant":
        return peak_lr
    k = max(updates_per_step, 1)
    warmup = t.warmup_steps * k
    decay = (t.lr_decay_steps or max(t.total_steps - t.warmup_steps, 1)) * k
    end = peak_lr * t.lr_end_factor
    if t.lr_schedule == "constant":
        body = lambda count: peak_lr  # noqa: E731
    elif t.lr_schedule == "linear":
        body = _linear(peak_lr, end, decay)
    else:
        body = _cosine(peak_lr, decay, t.lr_end_factor)
    if warmup == 0:
        return body
    warm = _linear(0.0, peak_lr, warmup)
    return lambda count: warm(count) if count < warmup else body(count - warmup)


def lr_value(t, peak_lr: float, count: int) -> float:
    """The schedule in TRAIN-STEP units (the JAX package's host-side mirror)."""
    if t.warmup_steps == 0 and t.lr_schedule == "constant":
        return peak_lr
    w = t.warmup_steps
    if count < w:
        return peak_lr * count / w
    if t.lr_schedule == "constant":
        return peak_lr
    decay = t.lr_decay_steps or max(t.total_steps - w, 1)
    frac = min((count - w) / decay, 1.0)
    end = peak_lr * t.lr_end_factor
    if t.lr_schedule == "linear":
        return peak_lr + (end - peak_lr) * frac
    return end + (peak_lr - end) * 0.5 * (1.0 + math.cos(math.pi * frac))


# -- Adam ------------------------------------------------------------------------


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, float32 (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm([t.float() for t in tensors])))


class Adam:
    """clip_by_global_norm (when ``clip_norm`` > 0) -> Adam -> -lr.

    Moments are stored in ``moment_dtype``; the update math is float32:
    ``mu = b1 mu + (1 - b1) g``, ``nu = b2 nu + (1 - b2) g^2``, then
    ``p -= lr * (mu / bc1) / (sqrt(nu / bc2) + eps)`` from the unrounded
    float32 moments; only the stored moments are rounded. ``lr`` is a float
    or a function of the update count before this update (optax's
    ``scale_by_learning_rate``).
    """

    def __init__(self, lr: Schedule, b1: float, b2: float, eps: float = 1e-8,
                 moment_dtype: torch.dtype = torch.float32, clip_norm: float = 0.0):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.moment_dtype, self.clip_norm = moment_dtype, clip_norm

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamState:
        zeros = lambda p: torch.zeros_like(p, dtype=self.moment_dtype)  # noqa: E731
        return AdamState(
            count=0,
            mu={k: zeros(p) for k, p in params.items()},
            nu={k: zeros(p) for k, p in params.items()},
        )

    def clip(self, grads: Sequence[torch.Tensor], norm_fn=global_norm) -> Sequence[torch.Tensor]:
        """optax.clip_by_global_norm: unchanged below the norm, else
        ``(g / norm) * clip_norm``; ``norm_fn`` takes the global norm (a
        channel-sharded step's sums the shards over its model group)."""
        if self.clip_norm <= 0:
            return grads
        norm = norm_fn(grads)
        keep = norm < self.clip_norm
        return [torch.where(keep, g, (g / norm) * self.clip_norm) for g in grads]

    @torch.no_grad()
    def update_(self, params: Mapping[str, torch.Tensor], grads: Sequence[torch.Tensor],
                state: AdamState, norm=global_norm) -> None:
        """One update of ``params`` (and ``state``) in place; ``grads`` in the
        order of ``params``; ``norm``: as :meth:`clip`'s ``norm_fn``."""
        keys = list(params)
        ps = [params[k] for k in keys]
        gs = self.clip([g.float() for g in grads], norm)
        lr = self.lr(state.count) if callable(self.lr) else self.lr
        state.count += 1
        bc1 = 1.0 - self.b1**state.count
        bc2 = 1.0 - self.b2**state.count
        mu = [state.mu[k] for k in keys]
        nu = [state.nu[k] for k in keys]
        f32 = self.moment_dtype == torch.float32
        mu_f = mu if f32 else [m.float() for m in mu]
        nu_f = nu if f32 else [v.float() for v in nu]
        torch._foreach_mul_(mu_f, self.b1)
        torch._foreach_add_(mu_f, gs, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu_f, self.b2)
        torch._foreach_addcmul_(nu_f, gs, gs, value=1.0 - self.b2)
        denom = torch._foreach_div(nu_f, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        step = torch._foreach_div(mu_f, bc1)
        torch._foreach_div_(step, denom)
        torch._foreach_add_(ps, step, alpha=-lr)
        if not f32:
            for dst, src in zip(mu + nu, mu_f + nu_f):
                dst.copy_(src)


def make_optimizers(cfg: Config) -> Tuple[Adam, Adam]:
    """G's and D's optimizers; D's schedule counter ticks ``disc_steps``
    times a train step."""
    t = cfg.train
    if t.adam_moment_dtype not in _MOMENT_DTYPES:
        raise ValueError(f"unsupported adam_moment_dtype {t.adam_moment_dtype!r}")

    def tx(peak_lr: float, updates_per_step: int) -> Adam:
        return Adam(make_lr_schedule(t, peak_lr, updates_per_step), t.adam_b1, t.adam_b2, 1e-8,
                    _MOMENT_DTYPES[t.adam_moment_dtype], t.grad_clip_norm)

    return tx(t.g_lr, 1), tx(t.d_lr, max(t.disc_steps, 1))


# -- state -----------------------------------------------------------------------


def state_from_params(
    cfg: Config,
    g_state_dict: Mapping[str, torch.Tensor],
    d_state_dict: Mapping[str, torch.Tensor],
    device=None,
) -> TrainState:
    """A step-0 TrainState over copies of the given parameters (float32, on
    ``device``: cuda unless another device is given), with fresh Adam states
    and, with ``train.ema_decay`` > 0, ``g_ema`` a copy of G's."""
    dev = resolve_device(device)
    copy = lambda sd: {k: v.detach().to(dev, torch.float32).clone() for k, v in sd.items()}  # noqa: E731
    g_params, d_params = copy(g_state_dict), copy(d_state_dict)
    g_tx, d_tx = make_optimizers(cfg)
    return TrainState(step=0, g_params=g_params, d_params=d_params,
                      g_opt=g_tx.init(g_params), d_opt=d_tx.init(d_params),
                      g_ema=ema_init(cfg, g_params))


def ema_init(cfg: Config, g_params: Params) -> Optional[Params]:
    """A copy of G's parameters with ``train.ema_decay`` > 0, else None."""
    if cfg.train.ema_decay <= 0:
        return None
    return {k: v.detach().clone() for k, v in g_params.items()}


@torch.no_grad()
def ema_update_(g_ema: Params, g_params: Params, decay: float) -> None:
    """``e <- e * d + p * (1 - d)`` in float32, in place, with ``d`` and
    ``1 - d`` rounded to float32 as the JAX package rounds them."""
    d = np.float32(decay)
    keys = list(g_ema)
    ema = [g_ema[k] for k in keys]
    torch._foreach_mul_(ema, float(d))
    torch._foreach_add_(ema, [g_params[k] for k in keys], alpha=float(np.float32(1) - d))


def init_state(cfg: Config, generator: Optional[torch.Generator] = None, device=None) -> TrainState:
    """Parameters in the Flax init distribution, drawn from ``generator``
    (a seeded ``torch.Generator``), and fresh Adam states."""
    from action_conditioned_gans_tpu_torch.models import Discriminator, Generator

    gen = Generator(cfg.model, generator=generator)
    disc = Discriminator(cfg.model, generator=generator)
    return state_from_params(cfg, gen.state_dict(), disc.state_dict(), device=device)


def param_count(state: TrainState) -> Tuple[int, int]:
    return (sum(p.numel() for p in state.g_params.values()),
            sum(p.numel() for p in state.d_params.values()))


# -- checkpoints -------------------------------------------------------------------


def state_tree(state: TrainState, cfg: Optional[Config] = None) -> Dict[str, Any]:
    """The state as the nested dict a checkpoint holds, over the state's own
    tensors (no copy): ``step``, ``g_params`` / ``d_params`` (float32),
    ``g_opt`` / ``d_opt`` with their ``count`` and their ``mu`` / ``nu`` in
    their own dtype, ``g_ema`` when the state has one, and, with ``cfg``, the
    config as JSON."""
    tree: Dict[str, Any] = {"step": int(state.step), "g_params": dict(state.g_params),
                            "d_params": dict(state.d_params)}
    for name in ("g_opt", "d_opt"):
        opt = getattr(state, name)
        tree[name] = {"count": int(opt.count), "mu": dict(opt.mu), "nu": dict(opt.nu)}
    if state.g_ema is not None:
        tree["g_ema"] = dict(state.g_ema)
    if cfg is not None:
        tree["config"] = json.dumps(dataclasses.asdict(cfg))
    return tree


def _map_tensors(tree, fn):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    return tree


def state_to_host(state: TrainState, cfg: Optional[Config] = None) -> Dict[str, Any]:
    """:func:`state_tree` copied to the CPU (the copy waits for the device)."""
    return _map_tensors(state_tree(state, cfg),
                        lambda t: t.detach().to("cpu", copy=True))


def state_to_device(tree: Mapping[str, Any], device=None) -> TrainState:
    """A :func:`state_tree` dict -> a TrainState on ``device`` (cuda unless
    another device is given)."""
    dev = resolve_device(device)
    move = lambda params: {k: v.to(dev) for k, v in params.items()}  # noqa: E731

    def opt(o):
        return AdamState(count=int(o["count"]), mu=move(o["mu"]), nu=move(o["nu"]))

    return TrainState(step=int(tree["step"]), g_params=move(tree["g_params"]),
                      d_params=move(tree["d_params"]), g_opt=opt(tree["g_opt"]),
                      d_opt=opt(tree["d_opt"]),
                      g_ema=move(tree["g_ema"]) if "g_ema" in tree else None)


def restore_state(cfg: Config, mgr, step: Optional[int] = None,
                  template: Optional[TrainState] = None) -> TrainState:
    """The checkpoint at ``step`` (the latest when None) of ``mgr`` (a
    ``utils.checkpoint.CheckpointManager``), shaped and typed as ``template``
    (``init_state(cfg)`` when None) and on its device.

    A checkpoint whose EMA tree differs from the config's is reconciled, as
    the JAX package's ``restore_state`` does: the template's structure is
    tried first, then the one with the EMA tree toggled; with EMA on and no
    stored tree, ``g_ema`` is seeded from the restored parameters; with EMA
    off, a stored tree is dropped. Any other mismatch raises the first
    attempt's error."""
    template = template if template is not None else init_state(cfg)
    device = next(iter(template.g_params.values())).device
    want = state_tree(template, cfg)
    try:
        tree = mgr.restore(want, step=step)
    except ValueError as first:
        toggled = dict(want)
        if "g_ema" in toggled:
            del toggled["g_ema"]
        else:
            toggled["g_ema"] = want["g_params"]
        try:
            tree = mgr.restore(toggled, step=step)
        except ValueError:
            raise first from None
    state = state_to_device(tree, device)
    want_ema = cfg.train.ema_decay > 0
    if want_ema and state.g_ema is None:
        state.g_ema = ema_init(cfg, state.g_params)
    if not want_ema:
        state.g_ema = None
    return state
