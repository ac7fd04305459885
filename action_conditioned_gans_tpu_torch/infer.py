"""Inference API: port of the JAX package's ``infer.py``.

    from action_conditioned_gans_tpu_torch.infer import Predictor
    p = Predictor.from_npz("generator.npz")        # a JAX export_generator archive
    nxt = p.predict(frame, action)                 # (B,H,W,C) -> (B,H,W,C)
    clip = p.rollout(frame0, actions)              # (B,H,W,C),(B,T,A) -> (B,T,H,W,C)

    p = Predictor.from_checkpoint(cfg, "/path/workdir")   # what ``train`` wrote there

A Predictor runs on ``cuda`` unless it is given another ``device``; with no
CUDA device and no ``device`` it raises. Given ``mesh``, a sequence of
devices, it serves data-parallel: one replica of the generator per device,
each batch split over them (``shard_batches``) and the outputs gathered on
the first. Given a ``(data, model)`` grid of devices (a sequence of equal
rows), it also shards channels, in this one process as the reference's
single-controller GSPMD serving does: each row serves its share of the
batch; in a row, each column's device holds its shard of every layer that
the model axis shards (``parallel.tp.tp_param_spec``, the training rule)
and computes those channels, and the row's first device concatenates them
and runs the replicated layers (:func:`grid_replica`). A batch-norm model
(``model.norm="batch"``) normalises with its whole batch's moments, so a
mesh serves each of its batches whole on the grid's first row, whose
columns still shard channels (the moments are per channel): the
reference's GSPMD function exactly (:func:`serves_whole`).
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from typing import Any, Callable, List, Mapping, Optional, Sequence

import numpy as np
import torch

from action_conditioned_gans_tpu_torch.config import Config, ModelConfig, resolve_device
from action_conditioned_gans_tpu_torch.convert import flax_to_state_dict, flatten_flax, state_dict_to_flax
from action_conditioned_gans_tpu_torch.utils import profiling

_META_KEY = "__model_config__"
# Knobs that say how a host executes the model, not what the model is: from_npz
# keeps the caller's values of these over the archive's.
RUNTIME_ONLY = ("compute_dtype", "backend", "gn_backward", "wgrad", "deconv", "conv0")


def export_generator(cfg: Config, state_dict: Mapping[str, torch.Tensor], path: str) -> None:
    """Write generator weights as the JAX package's portable ``.npz``: flat
    ``"enc_0/kernel"`` keys plus the ModelConfig as JSON."""
    arrays = flatten_flax(state_dict_to_flax(state_dict))
    arrays[_META_KEY] = np.asarray(json.dumps(dataclasses.asdict(cfg.model)))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def rollout_scan(
    apply_fn: Callable, frame0: torch.Tensor, actions: torch.Tensor, states=None
) -> torch.Tensor:
    """Autoregressive rollout: ``apply_fn(prev, action, state)`` over T.

    ``actions`` (B, T, A), ``states`` (B, T, S) or None -> (B, T, H, W, C).
    Each prediction is fed back cast to the previous frame's dtype. Spans
    ``rollout.steps`` (the T calls and casts) and ``rollout.stack``.
    """
    prev, preds = frame0, []
    with profiling.span("rollout.steps"):
        for t in range(actions.shape[1]):
            pred = apply_fn(prev, actions[:, t], None if states is None else states[:, t])
            preds.append(pred)
            prev = pred.to(prev.dtype)
    with profiling.span("rollout.stack"):
        return torch.stack(preds, dim=1)


def shard_batches(devices: Sequence, *arrays) -> List[tuple]:
    """Split batch-leading tensors over ``devices``: entry i holds each
    array's i-th equal share of the batch axis on ``devices[i]`` (None
    entries pass through). The one data-parallel serving split, shared by
    ``Predictor`` and ``aot.AotPredictor``; raises where the device count
    does not divide the batch."""
    n = len(devices)
    for a in arrays:
        if a is not None and a.shape[0] % n:
            raise ValueError(f"batch {a.shape[0]} is not divisible by the mesh data axis "
                             f"({n} devices); pad or resize the batch")
    return [tuple(None if a is None else a.chunk(n)[i].to(dev) for a in arrays)
            for i, dev in enumerate(devices)]


def run_sharded(call: Callable, replicas: Mapping[Any, Any], devices: Sequence,
                args: tuple) -> torch.Tensor:
    """``call(replicas[device], *share)`` on each device's share of ``args``
    (:func:`shard_batches`), concatenated on the first device. A device may
    be a grid's row (a tuple of devices), whose share goes to its first."""
    firsts = [d[0] if isinstance(d, tuple) else d for d in devices]
    outs = [call(replicas[dev], *share)
            for dev, share in zip(devices, shard_batches(firsts, *args))]
    return torch.cat([o.to(firsts[0]) for o in outs])


def serves_whole(m: ModelConfig) -> bool:
    """Whether a predictor over a mesh serves each batch whole on its first
    row, unsplit: batch norm takes its moments over the whole batch, which
    a share of it does not see."""
    return m.norm == "batch"


def _is_row(entry) -> bool:
    return isinstance(entry, (list, tuple))


def mesh_devices(mesh: Optional[Sequence], device) -> Optional[List[torch.device]]:
    """``mesh`` as a list of devices (None without one); ``device``, when
    given, must be its first. A data axis only: a grid raises."""
    if mesh is None:
        return None
    if any(_is_row(d) for d in mesh):
        raise ValueError("this predictor shards the batch only: give it a sequence of devices "
                         "(a data axis), not a (data, model) grid")
    devices = [torch.device(d) for d in mesh]
    if not devices:
        raise ValueError("mesh holds no device")
    if device is not None and torch.device(device) != devices[0]:
        raise ValueError(f"device {device} is not the mesh's first device {devices[0]}")
    return devices


def mesh_grid(mesh: Optional[Sequence], device) -> Optional[List[List[torch.device]]]:
    """``mesh`` as the rows of a ``(data, model)`` grid of devices (None
    without one): a sequence of devices is a data axis, one device a row; a
    sequence of equal rows gives each row's model columns. ``device``, when
    given, must be its first."""
    if mesh is None:
        return None
    if not any(_is_row(r) for r in mesh):
        return [[d] for d in mesh_devices(mesh, device)]
    if not all(_is_row(r) for r in mesh) or len({len(r) for r in mesh}) != 1 or not mesh[0]:
        raise ValueError(f"a (data, model) grid needs rows of one length, each a sequence of "
                         f"devices; got {mesh}")
    grid = [[torch.device(d) for d in row] for row in mesh]
    if device is not None and torch.device(device) != grid[0][0]:
        raise ValueError(f"device {device} is not the mesh's first device {grid[0][0]}")
    return grid


def grid_replica(generator, row: Sequence[torch.device]):
    """One row of a ``(data, model)`` grid: a copy of ``generator`` (its
    parameters on the CPU) on the row's first device, in which every conv
    block that a model axis of ``len(row)`` shards holds, in ``columns``,
    each column's shard of its kernel, scale and bias on the column's device
    (``models.common.ConvBlock``; its own parameters become column 0's
    shard). Replicated blocks stay whole."""
    from torch import nn

    from action_conditioned_gans_tpu_torch.models.common import ConvBlock
    from action_conditioned_gans_tpu_torch.parallel.tp import shard, tp_param_spec

    rep, m = copy.deepcopy(generator), len(row)
    for block in rep.modules():
        if not isinstance(block, ConvBlock) or tp_param_spec(block.kernel_shape, m) is None:
            continue
        block.columns = [
            (dev, *(None if p is None else shard(p.detach(), p.dim() - 1, j, m).to(dev)
                    for p in (block.kernel, block.scale, block.bias)))
            for j, dev in enumerate(row)]
        for i, name in enumerate(("kernel", "scale", "bias")):
            if getattr(block, name) is not None:
                setattr(block, name, nn.Parameter(block.columns[0][i + 1], requires_grad=False))
    return rep.to(row[0])


def _tensor(a, name: str, shape: tuple, device) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
    if t.dim() != len(shape) or any(want not in (None, got) for want, got in zip(shape, t.shape)):
        want = tuple("B" if s is None else s for s in shape)
        raise ValueError(f"{name} must have shape {want}, got {tuple(t.shape)}")
    return t.to(device).contiguous()


def model_inputs(m: ModelConfig, device, frame, action, state, time: bool):
    """(frame, action, state) as tensors on ``device``, checked against the
    model's geometry: ValueError names the first input that does not fit.
    ``time`` takes per-step actions and states (B, T, .) for a rollout.
    Shared by ``Predictor`` and ``aot.AotPredictor``."""
    t = (None,) if time else ()
    frame = _tensor(frame, "frame", (None, m.image_size, m.image_size, m.image_channels), device)
    action = _tensor(action, "actions" if time else "action", (None, *t, m.action_dim), device)
    if m.state_dim and state is None:
        raise ValueError("model config has state_dim > 0 but no state was passed")
    if state is not None:
        if not m.state_dim:
            raise ValueError("model config has state_dim 0 but a state was passed")
        state = _tensor(state, "states" if time else "state", (None, *t, m.state_dim), device)
    if action.shape[0] != frame.shape[0] or (state is not None and state.shape[0] != frame.shape[0]):
        raise ValueError("frame, action and state must share the batch size")
    if time and state is not None and state.shape[1] != action.shape[1]:
        raise ValueError("actions and states must share the horizon T")
    return frame, action, state


class Predictor:
    """Generator inference over given parameters.

    ``params`` is the Flax generator tree (nested, or flat ``"a/b"`` keys)
    with numpy leaves, as the JAX package's ``Predictor`` takes it, or the
    port's ``state_dict`` (``"a.b"`` keys) with CPU tensors.

    ``mesh`` (a sequence of devices; or :meth:`with_mesh`) serves over
    several devices: a replica of the generator on each distinct device,
    the batch split over the sequence (``shard_batches``: it must divide the
    batch) and the outputs gathered on the first device. A ``(data, model)``
    grid (a sequence of equal rows of devices) splits the batch over its
    rows and, in each row, the sharded layers' channels over its columns
    (module docstring; :func:`grid_replica`). A batch-norm model's batch is
    served whole on the first row (:func:`serves_whole`).
    """

    def __init__(self, cfg: Config, params: Mapping[str, Any], device=None,
                 mesh: Optional[Sequence] = None):
        # models/ is imported where a model is built: aot.AotPredictor imports
        # this module and serves without the model code.
        from action_conditioned_gans_tpu_torch.models import Generator

        self.cfg, self.params, self.grid = cfg, params, mesh_grid(mesh, device)
        self.mesh = None if self.grid is None else [row[0] for row in self.grid]
        self.device = self.mesh[0] if self.mesh else resolve_device(device)
        gen = Generator(cfg.model)
        gen.load_state_dict(flax_to_state_dict(params))
        gen.eval().requires_grad_(False)
        self._replicas = {}
        # A batch served whole runs on the first row alone.
        for row in (self.grid or [[self.device]])[:1 if serves_whole(cfg.model) else None]:
            if tuple(row) not in self._replicas:
                self._replicas[tuple(row)] = (grid_replica(gen, row) if len(row) > 1
                                              else copy.deepcopy(gen).to(row[0]))
        self.generator = next(iter(self._replicas.values()))

    def with_mesh(self, mesh: Sequence) -> "Predictor":
        """A copy of this predictor serving over ``mesh`` (class docstring)."""
        return Predictor(self.cfg, self.params, mesh=mesh)

    def _call(self, fn: Callable, args: tuple) -> torch.Tensor:
        """``fn(generator, *args)`` on this predictor's device, or on each
        mesh row's share of the batch (the whole batch on the first row
        where :func:`serves_whole`)."""
        if self.grid is None or serves_whole(self.cfg.model):
            return fn(self.generator, *args)
        return run_sharded(fn, self._replicas, [tuple(row) for row in self.grid], args)

    @classmethod
    def from_checkpoint(cls, cfg: Config, workdir: Optional[str] = None,
                        step: Optional[int] = None, use_ema: bool = False,
                        device=None, mesh: Optional[Sequence] = None) -> "Predictor":
        """Restore G's parameters from ``<workdir>/checkpoints/<step>/state.pt``
        (the latest step when None; ``cfg.workdir`` when no ``workdir``), as
        ``train`` writes it. ``use_ema=True`` serves the EMA weights.

        The JAX package's EMA rules: the template's EMA tree follows the
        checkpoint, not the config, so a plain checkpoint restores under an
        EMA config and an EMA checkpoint under a plain one; ``use_ema=True``
        on a checkpoint without EMA weights raises ValueError; a checkpoint
        whose optimizer layout is not the config's raises naming
        ``train.flatten_optimizer``, as the JAX package's template restore
        refuses it; any other failure (no such step, a key, shape or dtype)
        raises the first restore attempt's own error. Whether EMA weights exist is read from
        the stored tree: no EMA tree is made up from the parameters.
        ``mesh``: as the constructor's."""
        from action_conditioned_gans_tpu_torch.models import Discriminator, Generator
        from action_conditioned_gans_tpu_torch.train.state import (
            refuse_other_layout,
            state_from_params,
            state_tree,
        )
        from action_conditioned_gans_tpu_torch.utils.checkpoint import CheckpointManager

        meta = torch.device("meta")
        with meta:
            g_sd, d_sd = Generator(cfg.model).state_dict(), Discriminator(cfg.model).state_dict()

        def template(ema: bool):
            c = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, ema_decay=0.999 if ema else 0.0))
            return state_tree(state_from_params(c, g_sd, d_sd, device=meta), cfg)

        mesh_grid(mesh, device)  # a bad mesh raises before the restore
        dev = resolve_device(device) if mesh is None else device
        want_ema = use_ema or cfg.train.ema_decay > 0
        mgr = CheckpointManager(os.path.join(workdir or cfg.workdir, "checkpoints"))
        try:
            tree = mgr.restore(template(want_ema), step=step, device="cpu")
        except Exception as first:
            try:
                tree = mgr.restore(template(not want_ema), step=step, device="cpu")
            except Exception:
                refuse_other_layout(cfg, mgr, step)
                raise first from None
            if use_ema:
                raise ValueError("use_ema=True but the checkpoint has no EMA weights "
                                 "(train with train.ema_decay > 0)") from first
        return cls(cfg, tree["g_ema"] if use_ema else tree["g_params"], device=dev, mesh=mesh)

    @classmethod
    def from_npz(cls, path, cfg: Optional[Config] = None, device=None,
                 mesh: Optional[Sequence] = None) -> "Predictor":
        """Load a JAX ``export_generator`` archive (a path or a file object).

        The architecture comes from the archive. With ``cfg`` given, its
        runtime-only knobs (dtype, backend, engines) win over the archive's;
        with none, the archive's values are kept, engines included, as the
        JAX package keeps them. ``mesh``: as the constructor's.
        """
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z[_META_KEY]))
            params = {k: z[k] for k in z.files if k != _META_KEY}
        model = ModelConfig(**meta)
        if cfg is None:
            cfg = Config(model=model)
        else:
            arch = {
                f.name: getattr(model, f.name)
                for f in dataclasses.fields(ModelConfig)
                if f.name not in RUNTIME_ONLY
            }
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **arch))
        return cls(cfg, params, device=device, mesh=mesh)

    def predict(self, frame, action, state=None) -> torch.Tensor:
        """One next-frame prediction, (B, H, W, C) in the compute dtype."""
        with torch.inference_mode():
            return self._call(lambda g, *a: g(*a), model_inputs(
                self.cfg.model, self.device, frame, action, state, time=False))

    def rollout(self, frame0, actions, states=None) -> torch.Tensor:
        """Autoregressive T-step prediction, (B, T, H, W, C). One span
        ``rollout`` a request (attributes ``B``, ``T`` and ``dispatches``, the
        conv block calls it made: ``ops.common.conv_blocks``), its children
        ``rollout.inputs`` (``model_inputs``) and :func:`rollout_scan`'s."""
        from action_conditioned_gans_tpu_torch.ops.common import conv_blocks

        with torch.inference_mode(), profiling.span("rollout", unit=True) as span:
            blocks = conv_blocks()
            with profiling.span("rollout.inputs"):
                args = model_inputs(self.cfg.model, self.device, frame0, actions, states,
                                    time=True)
            out = self._call(rollout_scan, args)
            span.set(B=args[1].shape[0], T=args[1].shape[1], dispatches=conv_blocks() - blocks)
            return out
