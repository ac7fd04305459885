"""Inference API: port of the JAX package's ``infer.py``.

    from action_conditioned_gans_tpu_torch.infer import Predictor
    p = Predictor.from_npz("generator.npz")        # a JAX export_generator archive
    nxt = p.predict(frame, action)                 # (B,H,W,C) -> (B,H,W,C)
    clip = p.rollout(frame0, actions)              # (B,H,W,C),(B,T,A) -> (B,T,H,W,C)

A Predictor runs on ``cuda`` unless it is given another ``device``; with no
CUDA device and no ``device`` it raises. Restoring an orbax checkpoint
(``from_checkpoint``) and serving over a mesh are not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from action_conditioned_gans_tpu_torch.config import ENGINE_DEFAULTS, Config, ModelConfig, resolve_device
from action_conditioned_gans_tpu_torch.convert import flax_to_state_dict, flatten_flax, state_dict_to_flax
from action_conditioned_gans_tpu_torch.models import Generator

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


class Predictor:
    """Generator inference over given parameters.

    ``params`` is the Flax generator tree (nested, or flat ``"a/b"`` keys)
    with numpy leaves, as the JAX package's ``Predictor`` takes it.
    """

    def __init__(self, cfg: Config, params: Mapping[str, Any], device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        gen = Generator(cfg.model)
        gen.load_state_dict(flax_to_state_dict(params))
        self.generator = gen.to(self.device).eval().requires_grad_(False)

    @classmethod
    def from_npz(cls, path, cfg: Optional[Config] = None, device=None) -> "Predictor":
        """Load a JAX ``export_generator`` archive (a path or a file object).

        The architecture comes from the archive. With ``cfg`` given, its
        runtime-only knobs (dtype, backend, engines) win over the archive's;
        with none, engine knobs that only record how the weights were trained
        reset to the defaults the port runs.
        """
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z[_META_KEY]))
            params = {k: z[k] for k in z.files if k != _META_KEY}
        model = ModelConfig(**meta)
        if cfg is None:
            cfg = Config(model=dataclasses.replace(model, **ENGINE_DEFAULTS))
        else:
            arch = {
                f.name: getattr(model, f.name)
                for f in dataclasses.fields(ModelConfig)
                if f.name not in RUNTIME_ONLY
            }
            cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **arch))
        return cls(cfg, params, device=device)

    def _tensor(self, a, name: str, shape: tuple) -> torch.Tensor:
        t = torch.as_tensor(np.asarray(a) if not isinstance(a, torch.Tensor) else a)
        if t.dim() != len(shape) or any(want not in (None, got) for want, got in zip(shape, t.shape)):
            want = tuple("B" if s is None else s for s in shape)
            raise ValueError(f"{name} must have shape {want}, got {tuple(t.shape)}")
        return t.to(self.device).contiguous()

    def _inputs(self, frame, action, state, time: bool):
        m = self.cfg.model
        t = (None,) if time else ()
        frame = self._tensor(frame, "frame", (None, m.image_size, m.image_size, m.image_channels))
        action = self._tensor(action, "actions" if time else "action", (None, *t, m.action_dim))
        if m.state_dim and state is None:
            raise ValueError("model config has state_dim > 0 but no state was passed")
        if state is not None:
            if not m.state_dim:
                raise ValueError("model config has state_dim 0 but a state was passed")
            state = self._tensor(state, "states" if time else "state", (None, *t, m.state_dim))
        if action.shape[0] != frame.shape[0] or (state is not None and state.shape[0] != frame.shape[0]):
            raise ValueError("frame, action and state must share the batch size")
        if time and state is not None and state.shape[1] != action.shape[1]:
            raise ValueError("actions and states must share the horizon T")
        return frame, action, state

    def predict(self, frame, action, state=None) -> torch.Tensor:
        """One next-frame prediction, (B, H, W, C) in the compute dtype."""
        with torch.inference_mode():
            return self.generator(*self._inputs(frame, action, state, time=False))

    def rollout(self, frame0, actions, states=None) -> torch.Tensor:
        """Autoregressive T-step prediction, (B, T, H, W, C)."""
        with torch.inference_mode():
            frame0, actions, states = self._inputs(frame0, actions, states, time=True)
            return rollout_scan(self.generator, frame0, actions, states)
