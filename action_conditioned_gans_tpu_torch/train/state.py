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

With ``train.flatten_optimizer`` (and no model axis: ``mesh.model <= 1``,
the JAX package's rule) each optimizer keeps the flat layout of the JAX
package's ``optax.flatten``: G's (and D's) parameters are views of one
float32 buffer, in ``jax.tree.flatten`` order of the Flax tree
(:func:`flat_layout`), the Adam moments ``mu`` / ``nu`` are one 1-D tensor
each, and an update is one clip-and-Adam pass over the buffer, kernel 5 of
``ops/kernels/adam.py`` on the card. The parameter dicts keep the port's
names, so the models, serving and checkpoints still see a dict; a
checkpoint holds the parameters by name and the moments as the flat
vectors, and restoring one makes the parameters views of one buffer again
(:func:`flat_params`).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from action_conditioned_gans_tpu_torch.config import Config, resolve_device
from action_conditioned_gans_tpu_torch.ops.kernels import adam as adam_kernel

Params = Dict[str, torch.Tensor]
Schedule = Union[float, Callable[[int], float]]
_MOMENT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class AdamState:
    """``mu`` / ``nu``: per-parameter dicts, or in the flat layout one 1-D
    tensor each."""

    count: int
    mu: Union[Params, torch.Tensor]
    nu: Union[Params, torch.Tensor]


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


# -- the flat layout ---------------------------------------------------------------


def flatten_optimizer(cfg: Config) -> bool:
    """Whether ``cfg``'s optimizers keep the flat layout: the JAX package's
    ``train.flatten_optimizer and mesh.model <= 1`` (a concatenated vector
    cannot shard like channel-sharded parameters)."""
    return bool(cfg.train.flatten_optimizer) and cfg.mesh.model <= 1


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Where each parameter lies in the flat vector: ``names`` in order,
    their ``shapes``, element ``offsets`` and the vector's length."""

    names: Tuple[str, ...]
    shapes: Tuple[Tuple[int, ...], ...]
    offsets: Tuple[int, ...]
    numel: int


def jax_leaf_order(names) -> list:
    """The port's parameter names in ``jax.tree.flatten`` order of the Flax
    tree they name: the names nested at their dots (``"enc_0.kernel"`` is
    ``{"enc_0": {"kernel": ...}}``, as ``convert.state_dict_to_flax`` nests
    them) and the tree walked with its keys sorted at every level."""
    tree: Dict[str, Any] = {}
    for name in names:
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = name
    order = []

    def walk(node):
        for key in sorted(node):
            if isinstance(node[key], dict):
                walk(node[key])
            else:
                order.append(node[key])

    walk(tree)
    return order


def flat_layout(params: Mapping[str, torch.Tensor]) -> FlatLayout:
    """The flat layout of these parameters (by name; any device, meta
    included), in :func:`jax_leaf_order`: optax.flatten's concatenation."""
    names = jax_leaf_order(params)
    shapes = tuple(tuple(params[n].shape) for n in names)
    offsets = [0, *itertools.accumulate(math.prod(shape) for shape in shapes)]
    return FlatLayout(tuple(names), shapes, tuple(offsets[:-1]), offsets[-1])


def flat_params(tensors: Mapping[str, torch.Tensor], device=None) -> Params:
    """Copies of ``tensors`` (by name) in one new float32 buffer on
    ``device`` (theirs when None), in the flat layout: a dict, in layout
    order, of views of the buffer."""
    layout = flat_layout(tensors)
    if device is None:
        device = next(iter(tensors.values())).device
    buf = torch.empty(layout.numel, dtype=torch.float32, device=device)
    out = {}
    for name, shape, off in zip(layout.names, layout.shapes, layout.offsets):
        view = buf[off:off + math.prod(shape)].view(shape)
        view.copy_(tensors[name].detach())
        out[name] = view
    return out


def flat_buffer(params: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """The one float32 vector whose views ``params`` are (as
    :func:`flat_params` makes them), as a 1-D tensor over the same storage;
    raises naming the first parameter that is not its view at its place in
    the layout (a copy made by a device move, a clone or a per-name
    restore would no longer be updated by the optimizer)."""
    layout = flat_layout(params)
    first = params[layout.names[0]]
    base, storage = first.storage_offset(), first.untyped_storage()
    for name, shape, off in zip(layout.names, layout.shapes, layout.offsets):
        t = params[name]
        if not (t.dtype == torch.float32 and t.is_contiguous() and t.device == first.device
                and t.storage_offset() == base + off
                and t.untyped_storage().data_ptr() == storage.data_ptr()):
            raise ValueError(
                f"train.flatten_optimizer: parameter {name!r} is not a view of the flat "
                "parameter buffer at its place in the layout (build the state with "
                "init_state / state_from_params / state_to_device, which keep the views)")
    if storage.nbytes() < (base + layout.numel) * 4:
        raise ValueError("train.flatten_optimizer: the flat parameter buffer is too short")
    return first.as_strided((layout.numel,), (1,), base)


def flat_grad(params: Mapping[str, torch.Tensor], grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """Gradients given in the order of ``params``, concatenated in the flat
    layout's order (float32): optax.flatten's ``_flatten`` of them."""
    by_name = dict(zip(params, grads))
    return torch.cat([by_name[n].reshape(-1).float() for n in flat_layout(params).names])


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

    With ``flat`` the optimizer is the JAX package's ``optax.flatten`` of
    that chain: the parameters are views of one buffer (:func:`flat_params`),
    the moments one vector each, the clip takes the norm of the flat
    gradient, and an update is one launch of ``ops.kernels.adam.adam_flat``
    (its plain version on the CPU: the same arithmetic over one tensor).
    """

    def __init__(self, lr: Schedule, b1: float, b2: float, eps: float = 1e-8,
                 moment_dtype: torch.dtype = torch.float32, clip_norm: float = 0.0,
                 flat: bool = False):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.moment_dtype, self.clip_norm, self.flat = moment_dtype, clip_norm, flat

    def init(self, params: Mapping[str, torch.Tensor]) -> AdamState:
        if self.flat:
            buf = flat_buffer(params)
            zeros = lambda: torch.zeros_like(buf, dtype=self.moment_dtype)  # noqa: E731
            return AdamState(count=0, mu=zeros(), nu=zeros())
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
        return adam_kernel.clip_by_norm(grads, norm_fn(grads), self.clip_norm)

    def _scalars(self, state: AdamState) -> Dict[str, float]:
        """This update's lr and bias corrections (the count advances)."""
        lr = self.lr(state.count) if callable(self.lr) else self.lr
        state.count += 1
        return dict(b1=self.b1, b2=self.b2, eps=self.eps, lr=lr,
                    bc1=1.0 - self.b1**state.count, bc2=1.0 - self.b2**state.count)

    @torch.no_grad()
    def update_(self, params: Mapping[str, torch.Tensor],
                grads: Union[Sequence[torch.Tensor], torch.Tensor], state: AdamState,
                norm=global_norm) -> None:
        """One update of ``params`` (and ``state``) in place; ``grads`` in the
        order of ``params``, or in the flat layout the flat gradient
        (:func:`flat_grad`); ``norm``: as :meth:`clip`'s ``norm_fn`` (the
        flat layout takes the flat gradient's norm)."""
        if self.flat:
            if not isinstance(state.mu, torch.Tensor):
                raise ValueError("train.flatten_optimizer: this Adam state is per-tensor; build "
                                 "it with Adam.init over flat parameters")
            g = grads if isinstance(grads, torch.Tensor) else flat_grad(params, grads)
            g = g.float().contiguous()
            adam_kernel.adam_flat(
                flat_buffer(params), g, state.mu, state.nu, **self._scalars(state),
                clip=self.clip_norm,
                norm=torch.linalg.vector_norm(g) if self.clip_norm > 0 else None)
            return
        if isinstance(state.mu, torch.Tensor):
            raise ValueError("this Adam state is flat (train.flatten_optimizer) and the "
                             "optimizer per-tensor")
        keys = list(params)
        gs = self.clip([g.float() for g in grads], norm)
        adam_kernel.adam_foreach_([params[k] for k in keys], gs, [state.mu[k] for k in keys],
                                  [state.nu[k] for k in keys], **self._scalars(state))


def make_optimizers(cfg: Config) -> Tuple[Adam, Adam]:
    """G's and D's optimizers; D's schedule counter ticks ``disc_steps``
    times a train step."""
    t = cfg.train
    if t.adam_moment_dtype not in _MOMENT_DTYPES:
        raise ValueError(f"unsupported adam_moment_dtype {t.adam_moment_dtype!r}")

    def tx(peak_lr: float, updates_per_step: int) -> Adam:
        return Adam(make_lr_schedule(t, peak_lr, updates_per_step), t.adam_b1, t.adam_b2, 1e-8,
                    _MOMENT_DTYPES[t.adam_moment_dtype], t.grad_clip_norm,
                    flat=flatten_optimizer(cfg))

    return tx(t.g_lr, 1), tx(t.d_lr, max(t.disc_steps, 1))


# -- state -----------------------------------------------------------------------


def state_from_params(
    cfg: Config,
    g_state_dict: Mapping[str, torch.Tensor],
    d_state_dict: Mapping[str, torch.Tensor],
    device=None,
) -> TrainState:
    """A step-0 TrainState over copies of the given parameters (float32, on
    ``device``: cuda unless another device is given; in the flat layout
    views of one buffer each for G and D), with fresh Adam states and, with
    ``train.ema_decay`` > 0, ``g_ema`` a copy of G's."""
    dev = resolve_device(device)
    if flatten_optimizer(cfg):
        copy = lambda sd: flat_params(sd, dev)  # noqa: E731
    else:
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
    tensors (no copy): ``step``, ``g_params`` / ``d_params`` (float32, by
    name in either layout), ``g_opt`` / ``d_opt`` with their ``count`` and
    their ``mu`` / ``nu`` in their own dtype (dicts, or the flat vectors),
    ``g_ema`` when the state has one, and, with ``cfg``, the config as
    JSON."""
    tree: Dict[str, Any] = {"step": int(state.step), "g_params": dict(state.g_params),
                            "d_params": dict(state.d_params)}
    moments = lambda m: m if isinstance(m, torch.Tensor) else dict(m)  # noqa: E731
    for name in ("g_opt", "d_opt"):
        opt = getattr(state, name)
        tree[name] = {"count": int(opt.count), "mu": moments(opt.mu), "nu": moments(opt.nu)}
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


def tree_is_flat(tree: Mapping[str, Any]) -> bool:
    """Whether a :func:`state_tree` dict holds the flat layout's moments."""
    return isinstance(tree["g_opt"]["mu"], torch.Tensor)


def state_to_device(tree: Mapping[str, Any], device=None) -> TrainState:
    """A :func:`state_tree` dict -> a TrainState on ``device`` (cuda unless
    another device is given). A tree with flat moments gives the flat
    layout: each parameter tree copied into one buffer whose views the
    parameters are."""
    dev = resolve_device(device)
    move = lambda params: {k: v.to(dev) for k, v in params.items()}  # noqa: E731
    flat = tree_is_flat(tree)
    params = (lambda p: flat_params(p, dev)) if flat else move

    def opt(o):
        if flat:
            return AdamState(count=int(o["count"]), mu=o["mu"].to(dev), nu=o["nu"].to(dev))
        return AdamState(count=int(o["count"]), mu=move(o["mu"]), nu=move(o["nu"]))

    return TrainState(step=int(tree["step"]), g_params=params(tree["g_params"]),
                      d_params=params(tree["d_params"]), g_opt=opt(tree["g_opt"]),
                      d_opt=opt(tree["d_opt"]),
                      g_ema=move(tree["g_ema"]) if "g_ema" in tree else None)


def refuse_other_layout(cfg: Config, mgr, step: Optional[int] = None) -> None:
    """Raise ValueError naming ``train.flatten_optimizer`` when the
    checkpoint at ``step`` (the latest when None) of ``mgr`` holds the other
    optimizer layout than ``cfg`` keeps; return otherwise."""
    try:
        on_disk = tree_is_flat(mgr.load(step, device="cpu"))
    except (OSError, KeyError, TypeError, RuntimeError):
        return  # no such step or no optimizer state: the caller's error stands
    want = flatten_optimizer(cfg)
    if on_disk != want:
        layout = lambda flat: "flat (one vector each)" if flat else "per-tensor"  # noqa: E731
        raise ValueError(
            f"checkpoint: the Adam moments are {layout(on_disk)}; this config keeps them "
            f"{layout(want)} (train.flatten_optimizer={cfg.train.flatten_optimizer}, "
            f"mesh.model={cfg.mesh.model}: flat needs train.flatten_optimizer=true and "
            f"mesh.model <= 1). Use the settings the run was trained with.")


def restore_state(cfg: Config, mgr, step: Optional[int] = None,
                  template: Optional[TrainState] = None) -> TrainState:
    """The checkpoint at ``step`` (the latest when None) of ``mgr`` (a
    ``utils.checkpoint.CheckpointManager``), shaped and typed as ``template``
    (``init_state(cfg)`` when None) and on its device.

    A checkpoint whose EMA tree differs from the config's is reconciled, as
    the JAX package's ``restore_state`` does: the template's structure is
    tried first, then the one with the EMA tree toggled; with EMA on and no
    stored tree, ``g_ema`` is seeded from the restored parameters; with EMA
    off, a stored tree is dropped. A checkpoint in the other optimizer
    layout raises naming ``train.flatten_optimizer`` (the JAX package's
    template restore refuses it too); any other mismatch raises the first
    attempt's error. A flat state comes back as views of one buffer."""
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
            refuse_other_layout(cfg, mgr, step)
            raise first from None
    state = state_to_device(tree, device)
    want_ema = cfg.train.ema_decay > 0
    if want_ema and state.g_ema is None:
        state.g_ema = ema_init(cfg, state.g_params)
    if not want_ema:
        state.g_ema = None
    return state
