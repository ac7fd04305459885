"""Inference API: port of the JAX package's ``infer.py``.

    from action_conditioned_gans_tpu_torch.infer import Predictor
    p = Predictor.from_npz("generator.npz")        # a JAX export_generator archive
    nxt = p.predict(frame, action)                 # (B,H,W,C) -> (B,H,W,C)
    clip = p.rollout(frame0, actions)              # (B,H,W,C),(B,T,A) -> (B,T,H,W,C)

    p = Predictor.from_checkpoint(cfg, "/path/workdir")   # what ``train`` wrote there

A Predictor runs on ``cuda`` unless it is given another ``device``; with no
CUDA device and no ``device`` it raises. Serving over a mesh is not ported
yet (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from action_conditioned_gans_tpu_torch.config import Config, ModelConfig, resolve_device
from action_conditioned_gans_tpu_torch.convert import flax_to_state_dict, flatten_flax, state_dict_to_flax

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
    Each prediction is fed back cast to the previous frame's dtype.
    """
    prev, preds = frame0, []
    for t in range(actions.shape[1]):
        pred = apply_fn(prev, actions[:, t], None if states is None else states[:, t])
        preds.append(pred)
        prev = pred.to(prev.dtype)
    return torch.stack(preds, dim=1)


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
    """

    def __init__(self, cfg: Config, params: Mapping[str, Any], device=None):
        # models/ is imported where a model is built: aot.AotPredictor imports
        # this module and serves without the model code.
        from action_conditioned_gans_tpu_torch.models import Generator

        self.cfg = cfg
        self.device = resolve_device(device)
        gen = Generator(cfg.model)
        gen.load_state_dict(flax_to_state_dict(params))
        self.generator = gen.to(self.device).eval().requires_grad_(False)

    @classmethod
    def from_checkpoint(cls, cfg: Config, workdir: Optional[str] = None,
                        step: Optional[int] = None, use_ema: bool = False,
                        device=None) -> "Predictor":
        """Restore G's parameters from ``<workdir>/checkpoints/<step>/state.pt``
        (the latest step when None; ``cfg.workdir`` when no ``workdir``), as
        ``train`` writes it. ``use_ema=True`` serves the EMA weights.

        The JAX package's EMA rules: the template's EMA tree follows the
        checkpoint, not the config, so a plain checkpoint restores under an
        EMA config and an EMA checkpoint under a plain one; ``use_ema=True``
        on a checkpoint without EMA weights raises ValueError; any other
        failure (no such step, a key, shape or dtype) raises the first
        restore attempt's own error. Whether EMA weights exist is read from
        the stored tree: no EMA tree is made up from the parameters."""
        from action_conditioned_gans_tpu_torch.models import Discriminator, Generator
        from action_conditioned_gans_tpu_torch.train.state import state_from_params, state_tree
        from action_conditioned_gans_tpu_torch.utils.checkpoint import CheckpointManager

        meta = torch.device("meta")
        with meta:
            g_sd, d_sd = Generator(cfg.model).state_dict(), Discriminator(cfg.model).state_dict()

        def template(ema: bool):
            c = dataclasses.replace(cfg, train=dataclasses.replace(
                cfg.train, ema_decay=0.999 if ema else 0.0))
            return state_tree(state_from_params(c, g_sd, d_sd, device=meta), cfg)

        dev = resolve_device(device)
        want_ema = use_ema or cfg.train.ema_decay > 0
        mgr = CheckpointManager(os.path.join(workdir or cfg.workdir, "checkpoints"))
        try:
            tree = mgr.restore(template(want_ema), step=step, device="cpu")
        except Exception as first:
            try:
                tree = mgr.restore(template(not want_ema), step=step, device="cpu")
            except Exception:
                raise first from None
            if use_ema:
                raise ValueError("use_ema=True but the checkpoint has no EMA weights "
                                 "(train with train.ema_decay > 0)") from first
        return cls(cfg, tree["g_ema"] if use_ema else tree["g_params"], device=dev)

    @classmethod
    def from_npz(cls, path, cfg: Optional[Config] = None, device=None) -> "Predictor":
        """Load a JAX ``export_generator`` archive (a path or a file object).

        The architecture comes from the archive. With ``cfg`` given, its
        runtime-only knobs (dtype, backend, engines) win over the archive's;
        with none, the archive's values are kept, engines included, as the
        JAX package keeps them.
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
        return cls(cfg, params, device=device)

    def predict(self, frame, action, state=None) -> torch.Tensor:
        """One next-frame prediction, (B, H, W, C) in the compute dtype."""
        with torch.inference_mode():
            return self.generator(*model_inputs(self.cfg.model, self.device, frame, action, state,
                                                time=False))

    def rollout(self, frame0, actions, states=None) -> torch.Tensor:
        """Autoregressive T-step prediction, (B, T, H, W, C)."""
        with torch.inference_mode():
            frame0, actions, states = model_inputs(self.cfg.model, self.device, frame0, actions,
                                                   states, time=True)
            return rollout_scan(self.generator, frame0, actions, states)
