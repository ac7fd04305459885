"""Carry weights between the JAX package's Flax trees and the port.

The Flax tree is ``{"enc_0": {"kernel": ..., "bias": ...}, ...}`` (or its
flat form with ``"enc_0/kernel"`` keys, as ``export_generator`` writes it);
the port's ``state_dict`` uses ``"enc_0.kernel"``. The discriminator's dense
logit sits at the top of its tree (``"logit_kernel"``), in both. Both keep
the layouts (HWIO kernels, (F, 1) dense), so the conversion only renames and
copies: a round trip is bit-exact. A JAX ``TrainState``'s ``g_params`` and
``d_params`` each cross with :func:`flax_to_state_dict` and back with
:func:`state_dict_to_flax`; a whole JAX ``TrainState``, Adam states
included, crosses with :func:`train_state_from_jax` (the per-tensor Adam
layout, or the flat one of ``train.flatten_optimizer``), and into one rank's
channel shards of it (``parallel/tp.py``) with
:func:`train_state_shard_from_jax`.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def flatten_flax(params: Mapping[str, Any]) -> Dict[str, np.ndarray]:
    """Nested or already-flat Flax params -> {"enc_0/kernel": ndarray}."""
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix, node):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(f"{prefix}/{k}" if prefix else str(k), v)
        else:
            flat[prefix] = np.asarray(node)

    walk("", params)
    return flat


def flax_to_state_dict(params: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flax generator params (numpy leaves) -> the port's ``state_dict``."""
    return {
        key.replace("/", "."): torch.from_numpy(np.array(value, dtype=np.float32))
        for key, value in flatten_flax(params).items()
    }


def state_dict_to_flax(state_dict: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """The port's ``state_dict`` -> nested Flax params with numpy leaves.
    A key without a layer (``"logit_kernel"``) stays at the top."""
    tree: Dict[str, Any] = {}
    for key, value in state_dict.items():
        layer, _, name = key.rpartition(".")
        leaf = value.detach().float().cpu().numpy()
        if layer:
            tree.setdefault(layer, {})[name] = leaf
        else:
            tree[name] = leaf
    return tree


def _tensor_keep_dtype(a) -> torch.Tensor:
    """A numpy array as a tensor of the same dtype; numpy's bfloat16 (an
    ml_dtypes extension type torch.from_numpy does not take) crosses as its
    16-bit pattern."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _find_adam(opt_state):
    """The one optax ``ScaleByAdamState`` (count, mu, nu) inside an optax
    chain's state, found by its fields (the port does not import optax)."""
    if all(hasattr(opt_state, f) for f in ("count", "mu", "nu")):
        return opt_state
    children = opt_state.values() if isinstance(opt_state, Mapping) else (
        opt_state if isinstance(opt_state, (tuple, list)) else ())
    found = [a for a in (_find_adam(c) for c in children) if a is not None]
    if len(found) > 1:
        raise ValueError("the optimizer state holds more than one Adam state")
    return found[0] if found else None


def train_state_from_jax(cfg, jax_state_np, device=None):
    """A JAX package ``TrainState`` with numpy leaves -> the port's
    ``TrainState`` on ``device`` (cuda unless another device is given):
    ``step``, both parameter trees (float32), both optax Adam states,
    ``count`` and ``mu`` / ``nu`` in their own dtype, and the EMA tree when
    the state has one. Everything the port's checkpoints hold crosses.

    A state trained with ``train.flatten_optimizer`` (optax.flatten: each
    Adam state's ``mu`` / ``nu`` one vector over the parameters in
    ``jax.tree.flatten`` order) crosses into the port's flat layout: the
    vectors as they are, their length checked against the parameter count,
    the parameters views of one buffer. The JAX state's layout must be the
    one ``cfg`` keeps (``train.state.flatten_optimizer``), else ValueError
    naming the knob."""
    from action_conditioned_gans_tpu_torch.config import resolve_device
    from action_conditioned_gans_tpu_torch.train.state import (
        AdamState,
        TrainState,
        flat_params,
        flatten_optimizer,
    )

    dev = resolve_device(device)
    want = cfg.train.adam_moment_dtype
    flat = flatten_optimizer(cfg)

    def check_dtype(tensors):
        bad = {str(v.dtype) for v in tensors} - {f"torch.{want}"}
        if bad:
            raise ValueError(f"Adam moments in {sorted(bad)}, the config's "
                             f"train.adam_moment_dtype is {want!r}")

    def adam(opt_state, params) -> AdamState:
        a = _find_adam(opt_state)
        if a is None:
            raise ValueError("no optax Adam state (count, mu, nu) found in the optimizer state")
        jax_flat = not isinstance(a.mu, Mapping)
        if jax_flat != flat:
            raise ValueError(
                f"the JAX state's Adam moments are {'flat' if jax_flat else 'per-tensor'}, and "
                f"this config keeps them {'flat' if flat else 'per-tensor'} "
                f"(train.flatten_optimizer={cfg.train.flatten_optimizer}, mesh.model="
                f"{cfg.mesh.model}: flat needs train.flatten_optimizer=true and mesh.model <= 1, "
                "as in the JAX package)")
        count = int(np.asarray(a.count))
        if jax_flat:
            n = sum(v.numel() for v in params.values())
            mu, nu = (_tensor_keep_dtype(v).to(dev) for v in (a.mu, a.nu))
            for v in (mu, nu):
                if tuple(v.shape) != (n,):
                    raise ValueError(f"flat Adam moments of shape {tuple(v.shape)}; the "
                                     f"parameters hold {n} values")
            check_dtype((mu, nu))
            return AdamState(count=count, mu=mu, nu=nu)
        moments = []
        for tree in (a.mu, a.nu):
            sd = {k.replace("/", "."): _tensor_keep_dtype(v).to(dev)
                  for k, v in flatten_flax(tree).items()}
            check_dtype(sd.values())
            moments.append(sd)
        return AdamState(count=count, mu=moments[0], nu=moments[1])

    def params(tree):
        sd = flax_to_state_dict(tree)
        return flat_params(sd, dev) if flat else {k: v.to(dev) for k, v in sd.items()}

    g_ema = getattr(jax_state_np, "g_ema", None)
    g_params, d_params = params(jax_state_np.g_params), params(jax_state_np.d_params)
    return TrainState(step=int(np.asarray(jax_state_np.step)), g_params=g_params,
                      d_params=d_params, g_opt=adam(jax_state_np.g_opt, g_params),
                      d_opt=adam(jax_state_np.d_opt, d_params),
                      g_ema=None if g_ema is None else
                      {k: v.to(dev) for k, v in flax_to_state_dict(g_ema).items()})


def train_state_shard_from_jax(cfg, jax_state_np, index: int, size: int, device=None):
    """Model index ``index`` of ``size``'s channel shards of a JAX package
    ``TrainState`` with numpy leaves (:func:`train_state_from_jax`, then
    ``parallel.tp.shard_state``): what that rank of a ``(data, model)`` mesh
    holds. ``parallel.tp.gather_state`` over the ranks' shards gives the
    converted state back, bit for bit. A flat JAX state, which the JAX
    package cannot make on a model axis either, is refused (its
    ``train_state_from_jax``)."""
    from action_conditioned_gans_tpu_torch.parallel.tp import shard_state

    return shard_state(train_state_from_jax(cfg, jax_state_np, device=device), index, size)
