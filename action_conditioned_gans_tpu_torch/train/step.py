"""The fused G+D training step (port of the JAX package's ``train/step.py``).

One step, with the JAX package's semantics:

1. ONE generator rollout, kept with its graph (the JAX ``jax.vjp``):
   teacher-forced and folded over B*T (in time chunks of
   ``rollout_time_chunk``), or, with ``scheduled_sampling``, T steps in turn
   each fed the ground truth or the previous prediction; ``remat_rollout``
   checkpoints each generator call (``train/rollout.py``);
2. D's loss and gradient on real vs detached fake transitions, both halves
   in ONE discriminator call (two calls with ``norm="batch"``, whose
   statistics must not mix them), then D's Adam update (``disc_steps``
   times). With ``disc_microbatch`` the folded transitions go through D in
   ``nc`` equal chunks, the loss and gradient accumulated as loss/nc and
   grad/nc (batch norm keeps one chunk); with ``d_augment`` real and fake
   are augmented with their own parameters (``train/augment.py``). With
   ``r1_weight`` the loss gains (r1_weight / 2) * E[|grad_x sum D(x)|^2] at
   the augmented real transitions, conditioning held fixed; that inner D
   call runs on ``ops.api.plain_route``, the plain ops autograd can
   differentiate twice (the reference runs R1 on its XLA backend), while the
   loss's own D call keeps the kernels;
3. G's adversarial + ``recon_weight`` * reconstruction loss against the
   UPDATED D. D's parameters are frozen for this call (no D weight gradient
   is computed, as in JAX): the head is differentiated with respect to the
   predictions only, chunk by chunk as D was (each chunk's cotangent scaled
   by 1/nc), the augmentation inside it and the reconstruction on the raw
   predictions, and that cotangent is chained once into G through the saved
   forward. Then G's Adam update and, with ``ema_decay``, the EMA of G.

With ``norm="batch"`` the teacher-forced fold runs in time chunks of 1, so
G's statistics are per timestep, as in the step-by-step rollout.

The step's randomness (the rollout mask, the augmentation parameters) is a
pure function of (seed, step): :func:`draw_step_randoms`. A resumed run
draws what the uninterrupted one drew, without a host sync.

Under a process group (``parallel/dp.py``) each rank runs the step on its
share of the batch and folds its rank into the draws, as the JAX step folds
``axis_index``; D's and G's gradients are averaged over the ranks before
their Adam updates, each set in one all-reduce, the metrics too (the
gradient norms after the average), and batch-norm layers average their
moments over the ranks (``ops.api.batch_stats_group``).

On a mesh with a model axis (``parallel/tp.py``) the state holds this
rank's channel shards, every conv block that the axis shards runs on its
channels inside ``ops.api.model_group``, and the step follows the
reference's GSPMD step: its draws are the one-rank draws of the global
batch, of which each rank takes its data index's rows; gradients and
metrics are averaged over the data group (and batch norm's moments, each
shard's own channels); the replicated parameters' gradients are also
averaged over the model group, which holds them equal already, so that
their ranks stay bit for bit equal; the gradient norms (``log_grad_norms``,
``grad_clip_norm``) are the whole model's.

With ``train.flatten_optimizer`` (``train/state.py``'s flat layout) each
gradient set is concatenated into one vector in the layout's order, as
optax.flatten does (D's microbatch chunks add into it), averaged over the
ranks by one all-reduce in place, and applied by one fused Adam launch.

On CUDA every conv block runs its Hopper kernel forward and, for a GroupNorm
layer, the GroupNorm+activation backward kernel (``ops/kernels``); on the CPU
the plain versions.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.func import functional_call

from action_conditioned_gans_tpu_torch.config import Config, resolve_device
from action_conditioned_gans_tpu_torch.data.synthetic import batch_seed
from action_conditioned_gans_tpu_torch.models import Discriminator, Generator
from action_conditioned_gans_tpu_torch.ops import api
from action_conditioned_gans_tpu_torch.parallel import comm
from action_conditioned_gans_tpu_torch.train import augment
from action_conditioned_gans_tpu_torch.train import losses as L
from action_conditioned_gans_tpu_torch.train.rollout import (
    draw_use_pred,
    rollout_generator,
    rollout_teacher_forced,
    scheduled_sampling_prob,
)
from action_conditioned_gans_tpu_torch.train.state import (
    TrainState,
    ema_update_,
    flat_grad,
    global_norm,
    make_optimizers,
)
from action_conditioned_gans_tpu_torch.utils import profiling


def _fold_time(x):
    """(B, T, ...) -> (B*T, ...): D sees every transition as one batch."""
    return None if x is None else x.reshape((-1,) + tuple(x.shape[2:]))


@dataclasses.dataclass
class StepRandoms:
    """The random draws of one step; None where the knob that uses a draw is
    off. ``use_pred`` (B, T) bool: the scheduled-sampling rollout mask;
    ``u_real``, ``u_fake``, ``u_g`` (B*T, n_params) float32: the
    augmentation parameters of D's real and fake halves and of the G head."""

    use_pred: Optional[torch.Tensor] = None
    u_real: Optional[torch.Tensor] = None
    u_fake: Optional[torch.Tensor] = None
    u_g: Optional[torch.Tensor] = None


def draw_step_randoms(cfg: Config, seed: int, step: int, b: int, horizon: int,
                      device, rank: Optional[int] = None) -> StepRandoms:
    """Step ``step``'s draws, from a fresh ``torch.Generator`` on ``device``
    seeded from ``SeedSequence([seed, step])`` (with ``spawn_key=(rank,)``
    for a rank of a process group, rank 0 included: a trailing 0 in the
    entropy would change nothing), in this order: the rollout
    mask (with ``scheduled_sampling``; Bernoulli of the step's
    ``scheduled_sampling_prob``), then ``u_real``, ``u_fake`` and ``u_g``
    (with ``d_augment``). The JAX package folds the step, then the rank's
    ``axis_index``, into its key and splits it in the same order; threefry
    itself is not reproduced."""
    t = cfg.train
    ops = augment.parse_policy(t.d_augment)
    if not (t.scheduled_sampling or ops):
        return StepRandoms()
    device = torch.device(device)
    gen = None
    if device.type != "meta":  # meta tensors hold shapes only
        gen = torch.Generator(device=device)
        gen.manual_seed(batch_seed(seed, step) if rank is None else int(
            np.random.SeedSequence([seed, step], spawn_key=(rank,))
            .generate_state(1, np.uint64)[0]))
    out = StepRandoms()
    if t.scheduled_sampling:
        out.use_pred = draw_use_pred(gen, b, horizon, scheduled_sampling_prob(step, t), device)
    if ops:
        out.u_real, out.u_fake, out.u_g = (augment.draw_params(gen, ops, b * horizon, device)
                                           for _ in range(3))
    return out


def disc_chunks(n_flat: int, disc_microbatch: int, norm: str = "group") -> int:
    """How many chunks D runs over ``n_flat`` transitions: n_flat / mb for
    mb the largest divisor of ``n_flat`` at most ``disc_microbatch``; 1
    when microbatching is off, the chunk holds them all, or ``norm`` is
    "batch" (per-chunk statistics would change the function)."""
    mb = disc_microbatch if 0 < disc_microbatch < n_flat and norm != "batch" else 0
    while mb and n_flat % mb:
        mb -= 1
    return n_flat // mb if mb else 1


def _rows(randoms: StepRandoms, index: int, size: int) -> StepRandoms:
    """Data index ``index`` of ``size``'s rows of a global batch's draws:
    equal blocks of ``use_pred`` (B, T) and of the augmentation parameters
    (B*T, .), whose folded time is sample-major."""
    return StepRandoms(**{f.name: None if getattr(randoms, f.name) is None
                          else getattr(randoms, f.name).chunk(size)[index]
                          for f in dataclasses.fields(randoms)})


def make_train_step(cfg: Config, device=None, seed: Optional[int] = None, group=None, tp=None):
    """Build the step: ``(TrainState, batch, randoms=None) -> (TrainState,
    metrics)``; over ``group`` (a ``torch.distributed`` process group) a
    rank's step of the data-parallel step (module docstring), and with
    ``tp`` (a ``parallel.mesh.Mesh`` with a model axis, whose data group is
    ``group``) a rank's step of the dp x tp step on its shard of the state.

    The batch is the JAX package's clip layout, numpy arrays or tensors:
    ``frames`` (B, T+1, H, W, C) in [-1, 1], ``actions`` (B, T, A), and
    ``states`` (B, T, S) when ``cfg.model.state_dim`` > 0. The step runs on
    ``cuda`` unless another ``device`` is given; the state must live there.
    Its draws come from ``seed`` (``train.seed + 1`` when None, the key the
    JAX loop passes) and the state's step, unless ``randoms`` (a
    :class:`StepRandoms`) gives them. It updates the state's parameter,
    moment and EMA tensors in place and returns the state with ``step`` + 1,
    plus the metrics as 0-d float32 tensors under the JAX package's keys
    (``d_r1`` with ``r1_weight`` > 0).
    """
    m, t = cfg.model, cfg.train
    if t.r1_weight > 0 and m.backend == "pallas":
        raise ValueError(
            "train.r1_weight > 0 needs model.backend='xla': the JAX package cannot "
            "differentiate its Pallas kernels twice (its R1 step fails to linearize), so the "
            "reference trains R1 only on its XLA backend; the port runs R1's inner D call on "
            "the plain ops under backend='xla'")
    aug_ops = augment.parse_policy(t.d_augment)
    if t.gan_loss not in ("ce", "hinge"):
        raise ValueError(f"unknown gan_loss {t.gan_loss!r} (expected 'ce' or 'hinge')")
    if t.gan_loss == "hinge" and t.d_label_smooth > 0:
        raise ValueError("d_label_smooth is a cross-entropy concept; unset it or use gan_loss='ce'")
    dev = resolve_device(device)
    seed = t.seed + 1 if seed is None else seed
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

    batch_norm = m.norm == "batch"
    # Per-rank draws on the data-parallel path; one global draw under TP.
    rank = dist.get_rank(group) if group is not None and tp is None else None
    model_group = tp.model_group if tp is not None else None
    g_specs = d_specs = {}
    if tp is not None:
        from action_conditioned_gans_tpu_torch.parallel.tp import param_specs

        g_specs = param_specs(gen.state_dict(), tp.model)
        d_specs = param_specs(disc.state_dict(), tp.model)

    flat = g_tx.flat

    def gathered(params, grads):
        """A gradient set as the update takes it: the list in the order of
        ``params``, or in the flat layout one vector."""
        return flat_grad(params, grads) if flat else list(grads)

    def mean_over_ranks(tensors):
        """The set (a list, or the flat layout's one vector, reduced in
        place) averaged over the data group."""
        if group is None:
            return tensors
        if isinstance(tensors, torch.Tensor):
            return comm.mean_reduce_([tensors], group)[0]
        return comm.mean_reduce_(tensors, group)

    def sharded(params, specs):
        """Whether each parameter (in order) is a channel shard."""
        return [specs.get(k) is not None for k in params]

    def mean_replicated(grads, mask):
        """The replicated parameters' gradients averaged over the model group."""
        if model_group is not None and not all(mask):
            comm.mean_reduce_([g for g, s in zip(grads, mask) if not s], model_group)
        return grads

    def norm_of(mask):
        """The whole model's global norm of gradients in the order of
        ``mask``: the shards' squares summed over the model group, each
        replicated tensor counted once."""
        if model_group is None:
            return global_norm

        def squares(tensors):
            if not tensors:
                return torch.zeros((), device=dev)
            return torch.stack(torch._foreach_norm([t.float() for t in tensors])).square().sum()

        def norm(tensors):
            shard_sq = squares([t for t, s in zip(tensors, mask) if s])
            dist.all_reduce(shard_sq, group=model_group)
            return torch.sqrt(shard_sq + squares([t for t, s in zip(tensors, mask) if not s]))

        return norm

    def r1_penalty(d_params, real, cond, action, st):
        """E over the batch of |grad_x sum D(x)|^2 at ``real`` (float32),
        differentiable in ``d_params``: the inner D call on the plain route."""
        x = real.detach().requires_grad_()
        with api.plain_route():
            score = d_apply(d_params, x, cond, action, st).sum()
        (gx,) = torch.autograd.grad(score, x, create_graph=True)
        return gx.float().square().sum(dim=tuple(range(1, gx.dim()))).mean()

    def train_step(state: TrainState, batch, randoms: Optional[StepRandoms] = None):
        with api.batch_stats_group(group), api.model_group(model_group), profiling.span(
                "step", unit=True, device=dev):
            return one_step(state, batch, randoms)

    def one_step(state: TrainState, batch, randoms: Optional[StepRandoms]):
        profiling.phase("inputs")
        where = next(iter(state.g_params.values())).device
        if where.type != dev.type or dev.index not in (None, where.index):
            raise ValueError(f"the train state is on {where}, the step on {dev}")
        if t.ema_decay > 0 and state.g_ema is None:
            raise ValueError("train.ema_decay > 0 but the state has no g_ema; build it with "
                             "init_state(cfg) or state_from_params(cfg, ...)")
        frames = tensor(batch["frames"])
        actions = tensor(batch["actions"])
        states = tensor(batch["states"]) if m.state_dim else None
        b, horizon = actions.shape[:2]
        ss_prob = scheduled_sampling_prob(state.step, t)
        if tp is not None:
            # The global batch's draws (given, or the one-rank draw), this
            # rank's rows of them.
            if randoms is None:
                randoms = draw_step_randoms(cfg, seed, state.step, b * tp.data, horizon, dev)
            randoms = _rows(randoms, tp.data_index, tp.data)
        elif randoms is None:
            randoms = draw_step_randoms(cfg, seed, state.step, b, horizon, dev, rank)
        g_mask, d_mask = sharded(state.g_params, g_specs), sharded(state.d_params, d_specs)
        g_norm, d_norm = norm_of(g_mask), norm_of(d_mask)

        # One generator rollout, kept with its graph for G's update.
        profiling.phase("g_rollout")
        g_leaves = leaves(state.g_params)
        if t.scheduled_sampling:
            preds = rollout_generator(g_apply, g_leaves, frames, actions, states,
                                      randoms.use_pred, remat=t.remat_rollout)
        else:
            # Batch norm keeps per-timestep statistics: one time step a chunk.
            preds = rollout_teacher_forced(g_apply, g_leaves, frames, actions, states,
                                           time_chunk=1 if batch_norm else t.rollout_time_chunk,
                                           remat=t.remat_rollout)
        flat_preds = _fold_time(preds)

        profiling.phase("d_update")
        cond_frames = _fold_time(frames[:, :horizon])
        real_next = _fold_time(frames[:, 1:])
        flat_actions = _fold_time(actions)
        flat_states = _fold_time(states)

        # D's inputs: each conditioning frame gets its next frame's transform.
        fake = flat_preds.detach()
        real_d, cond_real = augment.apply(aug_ops, randoms.u_real, real_next, cond_frames)
        fake_d, cond_fake = augment.apply(aug_ops, randoms.u_fake, fake, cond_frames)
        nc = disc_chunks(real_next.shape[0], t.disc_microbatch, m.norm)

        def chunks(x):
            return [None] * nc if x is None else x.split(x.shape[0] // nc)

        def mean_of(total, x):
            """The running sum of x / nc over the chunks (x itself when nc == 1)."""
            x = x / nc if nc > 1 else x
            return x if total is None else total + x

        two = lambda x: None if x is None else torch.cat([x, x])  # noqa: E731

        # D update(s) on the detached fakes; real and fake share one D call
        # per chunk (two under batch norm); loss, accuracies, R1 and gradient
        # accumulate as x / nc.
        for i in range(max(t.disc_steps, 1)):
            if i:
                profiling.phase("d_update")
            d_leaves = leaves(state.d_params)
            d_loss = real_acc = fake_acc = d_r1 = d_grads = None
            for rl, fk, cr, cf, ac, st in zip(*map(chunks, (
                    real_d, fake_d, cond_real, cond_fake, flat_actions, flat_states))):
                if batch_norm:
                    real_logits = d_apply(d_leaves, rl, cr, ac, st)
                    fake_logits = d_apply(d_leaves, fk, cf, ac, st)
                else:
                    logits = d_apply(d_leaves, torch.cat([rl, fk.float()]), torch.cat([cr, cf]),
                                     two(ac), two(st))
                    real_logits, fake_logits = logits.chunk(2)
                loss = adv_loss_d(real_logits, fake_logits)
                accs = L.discriminator_accuracy(real_logits, fake_logits)
                if t.r1_weight > 0:
                    r1 = r1_penalty(d_leaves, rl, cr, ac, st)
                    loss = loss + 0.5 * t.r1_weight * r1
                    d_r1 = mean_of(d_r1, r1)
                grads = gathered(d_leaves, torch.autograd.grad(loss, list(d_leaves.values())))
                if nc > 1:
                    grads = (grads / float(nc) if flat
                             else torch._foreach_div(grads, float(nc)))
                if d_grads is None:
                    d_grads = grads
                elif flat:
                    d_grads.add_(grads)
                else:
                    torch._foreach_add_(d_grads, grads)
                d_loss = mean_of(d_loss, loss)
                real_acc, fake_acc = mean_of(real_acc, accs[0]), mean_of(fake_acc, accs[1])
            d_grads = mean_replicated(mean_over_ranks(d_grads), d_mask)
            profiling.phase("d_adam")
            d_tx.update_(state.d_params, d_grads, state.d_opt, norm=d_norm)

        # G head against the updated, frozen D: differentiate w.r.t. the
        # predictions only, chunk by chunk, then chain that cotangent through
        # G's forward (preds.backward(d_preds), with the gradients returned).
        profiling.phase("g_grad")
        d_frozen = {k: v.detach() for k, v in state.d_params.items()}
        g_loss = g_adv = g_recon = None
        d_preds = []
        for pr, rl, cd, ac, st, ug in zip(*map(chunks, (
                flat_preds.detach(), real_next, cond_frames, flat_actions, flat_states,
                randoms.u_g))):
            pr = pr.requires_grad_()
            d_in, cond_in = augment.apply(aug_ops, ug, pr, cd)
            adv = adv_loss_g(d_apply(d_frozen, d_in, cond_in, ac, st))
            recon = L.reconstruction_loss(pr, rl, t.recon_type)
            loss = adv + t.recon_weight * recon
            (dp,) = torch.autograd.grad(loss, pr)
            d_preds.append(dp * (1.0 / nc) if nc > 1 else dp)
            g_loss, g_adv = mean_of(g_loss, loss), mean_of(g_adv, adv)
            g_recon = mean_of(g_recon, recon)
        g_grads = mean_replicated(mean_over_ranks(gathered(g_leaves, torch.autograd.grad(
            flat_preds, list(g_leaves.values()), d_preds[0] if nc == 1 else torch.cat(d_preds)))),
            g_mask)
        profiling.phase("g_adam")
        g_tx.update_(state.g_params, g_grads, state.g_opt, norm=g_norm)
        if t.ema_decay > 0:
            ema_update_(state.g_ema, state.g_params, t.ema_decay)

        profiling.phase("metrics")
        metrics = {
            "d_loss": d_loss, "g_loss": g_loss, "g_adv": g_adv, "g_recon": g_recon,
            "d_real_acc": real_acc, "d_fake_acc": fake_acc,
        }
        if t.r1_weight > 0:  # the last disc_steps iteration's, as d_loss
            metrics["d_r1"] = d_r1
        metrics = {k: v.detach().float().reshape(()) for k, v in metrics.items()}
        mean_over_ranks(metrics.values())
        metrics["ss_prob"] = torch.tensor(ss_prob, dtype=torch.float32, device=dev)
        if t.log_grad_norms:
            # Pre-clip global norms of the averaged gradients; D's is the last
            # disc_steps iteration's.
            metrics["g_grad_norm"] = g_norm([g_grads] if flat else g_grads)
            metrics["d_grad_norm"] = d_norm([d_grads] if flat else d_grads)
        return dataclasses.replace(state, step=state.step + 1), metrics

    return train_step


def make_multi_train_step(cfg: Config, device=None, seed: Optional[int] = None, group=None,
                          tp=None):
    """k = ``cfg.train.steps_per_call`` fused steps a call, in sequence, over
    a stacked batch whose leaves have a leading (k, ...) axis; returns the
    LAST step's metrics (the JAX package's ``lax.scan`` of the step; each
    step draws from ``seed`` and its own step number). With k <= 1 this is
    the single step over an unstacked batch. ``group``, ``tp``: as
    :func:`make_train_step`.

    Each call is one span ``train_call[k=K]`` (``utils/profiling.py``; the
    ``acgan:train_call[k=K]`` of a trace, by which ``profile-report``
    counts steps), on CUDA with the caching allocator's device
    allocations, frees and retries over the call (:func:`_call_span`), and
    one ``step`` span a step, split into its phases: ``inputs``,
    ``g_rollout``, ``d_update``, ``d_adam``, ``g_grad``, ``g_adam``,
    ``metrics``."""
    step = make_train_step(cfg, device, seed, group, tp)
    dev = resolve_device(device)
    k = cfg.train.steps_per_call
    if k <= 1:
        @functools.wraps(step)
        def single(state: TrainState, batch, *randoms):
            with _call_span(dev, 1):
                return step(state, batch, *randoms)

        return single

    def multi(state: TrainState, batches):
        for key, leaf in batches.items():
            if leaf.shape[0] != k:
                raise ValueError(f"batch leaf {key!r} has {leaf.shape[0]} steps on its leading "
                                 f"axis, want steps_per_call={k}")
        metrics = None
        with _call_span(dev, k):
            for i in range(k):
                state, metrics = step(state, {key: leaf[i] for key, leaf in batches.items()})
        return state, metrics

    return multi


# The caching allocator's counts a training call's span records: attribute
# name -> ``torch.cuda.memory_stats`` key (cudaMalloc and cudaFree calls,
# and frees-and-retries after a failed allocation).
ALLOCATOR_COUNTS = {"device_alloc": "num_device_alloc", "device_free": "num_device_free",
                    "alloc_retries": "num_alloc_retries"}


@contextlib.contextmanager
def _call_span(dev: torch.device, k: int):
    """The span ``train_call[k=K]`` of one call; on CUDA it gains the
    change of each of ``ALLOCATOR_COUNTS`` over the call."""
    with profiling.span(f"train_call[k={k}]", k=k) as span:
        if dev.type != "cuda" or not profiling.ENABLED:
            yield
            return
        # The nested form skips memory_stats' flattening of every statistic.
        before = torch.cuda.memory_stats_as_nested_dict(dev)
        yield
        after = torch.cuda.memory_stats_as_nested_dict(dev)
        span.set(**{a: after.get(s, 0) - before.get(s, 0) for a, s in ALLOCATOR_COUNTS.items()})
