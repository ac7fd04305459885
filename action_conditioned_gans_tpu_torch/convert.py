"""Carry weights between the JAX package's Flax trees and the port.

The Flax tree is ``{"enc_0": {"kernel": ..., "bias": ...}, ...}`` (or its
flat form with ``"enc_0/kernel"`` keys, as ``export_generator`` writes it);
the port's ``state_dict`` uses ``"enc_0.kernel"``. The discriminator's dense
logit sits at the top of its tree (``"logit_kernel"``), in both. Both keep
the layouts (HWIO kernels, (F, 1) dense), so the conversion only renames and
copies: a round trip is bit-exact. A JAX ``TrainState``'s ``g_params`` and
``d_params`` each cross with :func:`flax_to_state_dict` and back with
:func:`state_dict_to_flax`.
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
