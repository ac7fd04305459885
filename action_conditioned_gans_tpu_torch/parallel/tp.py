"""Channel tensor parallelism over the mesh's model axis (port of the JAX
package's ``parallel/gspmd.py``).

The reference shards conv output channels over ``model`` and lets GSPMD
insert the collectives. Here every rank of a model group holds its shard
of each sharded parameter (:func:`tp_param_spec`, the reference's rule),
the rows of the batch that its data index holds, and the replicated
parameters whole. A sharded conv block runs its conv, norm and activation
on its output channels and gathers them (``models/common.py``, with the
Megatron pair of ``parallel/comm.py``); everything else runs whole on
every rank of the group. The step (:func:`make_tp_train_step`) averages
every gradient over the data group, takes the full model's norms, and
draws its randoms once for the global batch, as ``make_gspmd_train_step``
(the reference's ``make_multi_train_step`` with no axis name) does.

The state is made whole from the seed, as the one-rank ``init_state``
makes it, and sharded (:func:`shard_state`): a TP run starts from the
one-rank run's weights. :func:`gather_state` is the inverse, bit for bit;
checkpoints hold the gathered state, in the one-rank format.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence

import torch
import torch.distributed as dist


def tp_param_spec(shape: Sequence[int], model_size: int) -> Optional[int]:
    """The dimension of a parameter that the model axis shards, or None
    (replicated): a rank-4 HWIO conv kernel's output channels, a rank-1
    vector's only dimension, each only when its size is a multiple of
    ``model_size`` and at least twice it (the reference's
    ``tp_param_pspec``). The dense logit (rank 2), ``dec_0``'s 3 channels
    and any size the axis does not divide stay whole."""
    if model_size <= 1:
        return None
    if len(shape) == 4 and shape[-1] % model_size == 0 and shape[-1] >= 2 * model_size:
        return 3
    if len(shape) == 1 and shape[0] % model_size == 0 and shape[0] >= 2 * model_size:
        return 0
    return None


def param_specs(params: Mapping[str, torch.Tensor], model_size: int) -> Dict[str, Optional[int]]:
    """:func:`tp_param_spec` of each full-size parameter."""
    return {k: tp_param_spec(tuple(v.shape), model_size) for k, v in params.items()}


def _map_trees(state, g_fn, d_fn):
    """``state`` with ``g_fn`` applied to each of G's trees (parameters,
    moments, EMA) and ``d_fn`` to each of D's."""
    from action_conditioned_gans_tpu_torch.train.state import AdamState

    def opt(o, fn):
        return AdamState(count=o.count, mu=fn(o.mu), nu=fn(o.nu))

    return dataclasses.replace(
        state, g_params=g_fn(state.g_params), d_params=d_fn(state.d_params),
        g_opt=opt(state.g_opt, g_fn), d_opt=opt(state.d_opt, d_fn),
        g_ema=None if state.g_ema is None else g_fn(state.g_ema))


def state_shardings(state, model_size: int):
    """The specs of a full-size ``TrainState``, as a ``TrainState`` of the
    same structure: each parameter's :func:`tp_param_spec`; the Adam
    moments and ``g_ema`` follow their parameters; ``step`` and the counts
    are replicated (None)."""
    g, d = param_specs(state.g_params, model_size), param_specs(state.d_params, model_size)
    specs = _map_trees(state, lambda _: dict(g), lambda _: dict(d))
    for opt in (specs.g_opt, specs.d_opt):
        opt.count = None
    return dataclasses.replace(specs, step=None)


def shard(t: torch.Tensor, dim: Optional[int], index: int, size: int) -> torch.Tensor:
    """Shard ``index`` of ``size`` of ``t`` along ``dim``, or all of ``t``
    when ``dim`` is None: a contiguous copy either way."""
    part = t if dim is None else t.chunk(size, dim=dim)[index]
    return part.clone(memory_format=torch.contiguous_format)


def shard_state(state, index: int, size: int):
    """Model index ``index``'s shard of a full-size ``TrainState`` on a
    model axis of ``size`` (:func:`state_shardings`), over copies of its
    tensors."""
    specs = state_shardings(state, size)

    def sharder(spec):
        return lambda params: {k: shard(t, spec[k], index, size) for k, t in params.items()}

    return _map_trees(state, sharder(specs.g_params), sharder(specs.d_params))


def full_shapes(cfg) -> Dict[str, Dict[str, tuple]]:
    """The full-size shapes of G's and D's parameters (built on the meta
    device)."""
    from action_conditioned_gans_tpu_torch.models import Discriminator, Generator

    with torch.device("meta"):
        gen, disc = Generator(cfg.model), Discriminator(cfg.model)
    return {"g": {k: tuple(v.shape) for k, v in gen.state_dict().items()},
            "d": {k: tuple(v.shape) for k, v in disc.state_dict().items()}}


def gather_params(params: Mapping[str, torch.Tensor], shapes: Mapping[str, tuple],
                  group) -> Dict[str, torch.Tensor]:
    """The full-size tensors of channel-sharded ``params`` (full shapes
    ``shapes``), every rank of the model ``group`` calling: the shards
    gathered in rank order, bit for bit (a non-float32 tensor crosses as
    float32, exactly); replicated tensors as they are."""
    size = dist.get_world_size(group)
    out = {}
    for k, t in params.items():
        dim = tp_param_spec(shapes[k], size)
        if dim is None:
            out[k] = t
            continue
        src = t.float().contiguous()
        parts = [torch.empty_like(src) for _ in range(size)]
        dist.all_gather(parts, src, group=group)
        out[k] = torch.cat(parts, dim=dim).to(t.dtype)
    return out


def gather_state(state, cfg, group):
    """The full-size ``TrainState`` of a sharded one, every rank of the
    model ``group`` calling (:func:`gather_params` of each tree; the
    inverse of :func:`shard_state`)."""
    shapes = full_shapes(cfg)
    return _map_trees(state, lambda p: gather_params(p, shapes["g"], group),
                      lambda p: gather_params(p, shapes["d"], group))


def place_state(state, mesh):
    """A full-size ``TrainState`` as this rank of ``mesh`` holds it: its
    shard on a mesh with a model axis (the reference's
    ``place_state_global``), else the state itself."""
    return shard_state(state, mesh.model_index, mesh.model) if mesh.model > 1 else state


def whole_state(state, cfg, mesh):
    """The full-size ``TrainState`` of this rank's state, every rank of
    ``mesh`` calling on a mesh with a model axis (:func:`gather_state`),
    else the state itself: what a checkpoint holds."""
    return gather_state(state, cfg, mesh.model_group) if mesh.model > 1 else state


def whole_generator(params, cfg, mesh) -> Dict[str, torch.Tensor]:
    """G's full-size parameters of this rank's (shards of) ``params``, every
    rank of ``mesh`` calling on a mesh with a model axis."""
    if mesh.model <= 1:
        return params
    return gather_params(params, full_shapes(cfg)["g"], mesh.model_group)


def make_tp_train_step(cfg, mesh, seed: Optional[int] = None):
    """The counterpart of the reference's ``make_gspmd_train_step``:
    ``(state, local_batch, randoms=None) -> (state, metrics)`` on
    ``mesh.device`` for a rank of a ``(data, model)`` mesh with ``model`` >
    1 (``parallel.dp.make_dp_train_step``, which takes this path on such a
    mesh). ``state`` is this rank's shard (:func:`shard_state`),
    ``local_batch`` its data index's rows of the global batch
    (``parallel.mesh.batch_slice``), and ``randoms``, when given, the global
    batch's draws, of which the step takes its rows. The metrics are the
    data group's means, the same on every rank."""
    from action_conditioned_gans_tpu_torch.parallel.dp import make_dp_train_step

    if mesh.model <= 1:
        raise ValueError(f"make_tp_train_step needs a mesh with a model axis; this one has "
                         f"model={mesh.model} (parallel.dp.make_dp_train_step)")
    return make_dp_train_step(cfg, mesh, seed)
