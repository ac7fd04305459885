"""Ahead-of-time serving artifacts through ``torch.export`` (port of the JAX
package's ``aot.py``, whose artifact holds StableHLO).

The generator FUNCTION, traced with its weights inside, so a serving process
needs no model code: only torch and ``ops/kernels/library.py``, which
registers the ``acgan::`` custom ops that stand for kernels 1-3 in the
traced graph.

* **Symbolic batch.** The batch is a ``torch.export.Dim`` (traced at 2 and
  allowed from 1 up), so one artifact serves any batch.
* **Any device.** An artifact exported on the CPU serves on the card: the
  loader moves the weights and the device literals of the graph with
  ``torch.export.passes.move_to_device_pass``, and the ``acgan::`` nodes then
  launch the kernels (their launch counters move).
* **Rollouts.** ``infer.rollout_scan`` is a Python loop, so each horizon is
  its own program, unrolled at its T, as the reference's ``lax.scan`` length
  is part of its program.

Format: a zip holding ``meta.json`` (``format_version``, ``model_config``,
``state_dim``, ``rollout_lengths``, ``torch_version``), ``predict.pt2`` and
one ``rollout_T{t}.pt2`` per horizon, each a ``torch.export.save``d program.

    from action_conditioned_gans_tpu_torch.aot import export_aot, AotPredictor
    export_aot(cfg, g_params, "/path/generator.aot", rollout_length=10)
    p = AotPredictor("/path/generator.aot")          # cuda unless a device is given
    nxt = p.predict(frame, action)                    # any batch size
    clip = p.rollout(frame0, actions)                 # T must be an exported horizon

Inputs are float32; outputs are in the model's compute dtype, as the live
``infer.Predictor``'s are. ``AotPredictor(path, mesh=devices)`` serves
data-parallel as the live predictor does: the programs loaded once per
distinct device, the batch split by ``infer.shard_batches``, the outputs
gathered on the first device; a batch-norm model (``meta.json``'s
``model_config``) has each batch served whole on the first device, since
its moments are the whole batch's (``infer.serves_whole``).
"""

from __future__ import annotations

import dataclasses
import io
import json
import os
import zipfile
from typing import Mapping, Optional, Sequence, Union

import torch
import torch.export.passes

from action_conditioned_gans_tpu_torch.config import Config, ModelConfig, resolve_device
from action_conditioned_gans_tpu_torch.infer import (
    mesh_devices,
    model_inputs,
    rollout_scan,
    run_sharded,
    serves_whole,
)
from action_conditioned_gans_tpu_torch.ops.kernels import library  # noqa: F401 (registers acgan::)

FORMAT_VERSION = 1
_META = "meta.json"
_PREDICT = "predict.pt2"
_ROLLOUT_T = "rollout_T{t}.pt2"


def _horizons(rollout_length: Union[int, Sequence[int]]) -> list:
    given = [rollout_length] if isinstance(rollout_length, int) else list(rollout_length)
    if any(int(t) < 0 for t in given):
        raise ValueError(f"negative rollout_length in {rollout_length!r}")
    return sorted({int(t) for t in given if int(t) > 0})


class _Program(torch.nn.Module):
    """The generator's predict (``horizon`` 0) or its T-step rollout."""

    def __init__(self, generator: torch.nn.Module, horizon: int):
        super().__init__()
        self.generator, self.horizon = generator, horizon

    def forward(self, frame, action, state=None):
        if not self.horizon:
            return self.generator(frame, action, state)
        return rollout_scan(self.generator, frame, action, state)


def export_aot(cfg: Config, g_params: Mapping[str, torch.Tensor], path: str, *,
               rollout_length: Union[int, Sequence[int]] = 0, device=None) -> dict:
    """Write the generator over ``g_params`` (the port's ``state_dict``) as an
    AOT artifact at ``path``, traced on ``device`` (cuda unless another is
    given): the predict program and one rollout program per horizon in
    ``rollout_length`` (an int or a sequence; 0 or empty: predict only).
    Published atomically. Returns ``meta.json``'s dict plus ``bytes``."""
    from action_conditioned_gans_tpu_torch.models import Generator

    dev = resolve_device(device)
    m = cfg.model
    horizons = _horizons(rollout_length)
    gen = Generator(m)
    gen.load_state_dict({k: v.detach().float().cpu() for k, v in g_params.items()})
    gen = gen.to(dev).eval().requires_grad_(False)

    batch = torch.export.Dim("batch", min=1)
    size = (m.image_size, m.image_size, m.image_channels)

    def export(horizon):
        t = (horizon,) if horizon else ()
        args = {"frame": torch.zeros((2, *size), device=dev),
                "action": torch.zeros((2, *t, m.action_dim), device=dev)}
        if m.state_dim:
            args["state"] = torch.zeros((2, *t, m.state_dim), device=dev)
        with torch.no_grad():
            program = torch.export.export(
                _Program(gen, horizon), (), kwargs=args, strict=False,
                dynamic_shapes={k: {0: batch} for k in args})
        buf = io.BytesIO()
        torch.export.save(program, buf)
        return buf.getvalue()

    members = {_PREDICT: export(0)}
    members.update({_ROLLOUT_T.format(t=t): export(t) for t in horizons})
    meta = {
        "format_version": FORMAT_VERSION,
        "model_config": dataclasses.asdict(m),
        "state_dim": m.state_dim,
        "rollout_lengths": horizons,
        "torch_version": torch.__version__,
    }
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.tmp-{os.getpid()}"
    # The programs are zip archives of their own; storing them is enough.
    with zipfile.ZipFile(tmp, "w", compression=zipfile.ZIP_STORED) as z:
        for name, data in members.items():
            z.writestr(name, data)
        z.writestr(_META, json.dumps(meta, indent=1))
    os.replace(tmp, path)
    return {**meta, "bytes": os.path.getsize(path)}


class AotPredictor:
    """Serve an :func:`export_aot` artifact without the model code.

    ``predict`` / ``rollout`` take the live ``infer.Predictor``'s arguments
    and give its outputs; any batch size works (with ``mesh``, any multiple
    of its length). The programs run on ``device`` (cuda unless another is
    given), or on each device of ``mesh``, wherever they were exported; a
    batch-norm model's batch whole on the mesh's first device.
    """

    def __init__(self, path: str, device=None, mesh: Optional[Sequence] = None):
        self.mesh = mesh_devices(mesh, device)
        self.device = self.mesh[0] if self.mesh else resolve_device(device)
        with zipfile.ZipFile(path) as z:
            self.meta = json.loads(z.read(_META).decode())
            if self.meta.get("format_version") != FORMAT_VERSION:
                raise ValueError(
                    f"unsupported artifact format {self.meta.get('format_version')!r} "
                    f"(this loader speaks {FORMAT_VERSION})"
                )
            self.cfg = Config(model=ModelConfig(**self.meta["model_config"]))
            # A batch served whole runs on the first device alone.
            devices = ([self.device] if serves_whole(self.cfg.model)
                       else list(dict.fromkeys(self.mesh or [self.device])))

            def load(name):
                """The program ``name`` on each device."""
                data = z.read(name)
                return {dev: torch.export.passes.move_to_device_pass(
                    torch.export.load(io.BytesIO(data)), dev).module() for dev in devices}

            self._predict = load(_PREDICT)
            self._rollouts = {int(t): load(_ROLLOUT_T.format(t=t))
                              for t in self.meta["rollout_lengths"]}
        self.state_dim = int(self.meta["state_dim"])
        self.rollout_lengths = sorted(self._rollouts)

    def _run(self, programs, args: dict) -> torch.Tensor:
        """The program on this predictor's device, or on each mesh device's
        share of the batch (the whole batch on the first where
        ``infer.serves_whole``)."""
        if self.mesh is None or serves_whole(self.cfg.model):
            return programs[self.device](**args)
        names = list(args)
        return run_sharded(lambda program, *a: program(**dict(zip(names, a))), programs,
                           self.mesh, tuple(args.values()))

    def _args(self, frame, action, state, time: bool):
        if self.state_dim and state is None:
            raise ValueError(f"artifact was exported with state_dim={self.state_dim}; pass `state`")
        if not self.state_dim and state is not None:
            raise ValueError("artifact was exported without a state input")
        args = model_inputs(self.cfg.model, self.device, frame, action, state, time)
        return {k: a.float() for k, a in zip(("frame", "action", "state"), args) if a is not None}

    def predict(self, frame, action, state=None) -> torch.Tensor:
        """One next-frame prediction, (B, H, W, C) in the compute dtype."""
        with torch.inference_mode():
            return self._run(self._predict, self._args(frame, action, state, time=False))

    def rollout(self, frame0, actions, states=None) -> torch.Tensor:
        """Autoregressive rollout, dispatched on T to an exported horizon."""
        if not self._rollouts:
            raise ValueError("artifact has no rollout program (export with rollout_length > 0)")
        t_len = actions.shape[1]
        if t_len not in self._rollouts:
            raise ValueError(
                f"artifact rollout horizons are {self.rollout_lengths}, got actions with T={t_len}"
            )
        if states is not None and states.shape[1] != t_len:
            raise ValueError(
                f"states horizon T={states.shape[1]} does not match the actions horizon T={t_len}"
            )
        with torch.inference_mode():
            return self._run(self._rollouts[t_len], self._args(frame0, actions, states,
                                                               time=True))
