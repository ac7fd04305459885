"""The data-parallel training step (port of the JAX package's
``parallel/dp.py``).

Every rank runs the whole fused G+D step on its share of the batch, with
the kernels the single-device step launches. The step reduces what the JAX
``shard_map`` step ``pmean``s: D's gradients before D's Adam, G's before
G's, the metrics, and, with ``norm="batch"``, each batch-norm layer's
moments (``ops.api.batch_stats_group``). The state stays replicated because
every rank applies the same averaged gradients. No
``DistributedDataParallel``: the step takes its gradients with
``torch.autograd.grad`` and updates D before G.
"""

from __future__ import annotations

from typing import Optional

from action_conditioned_gans_tpu_torch.config import Config
from action_conditioned_gans_tpu_torch.parallel.mesh import Mesh
from action_conditioned_gans_tpu_torch.train.step import make_multi_train_step


def make_dp_train_step(cfg: Config, mesh: Mesh, seed: Optional[int] = None):
    """``(state, local_batch, randoms=None) -> (state, metrics)`` on
    ``mesh.device``: :func:`make_multi_train_step` over ``mesh.group``.

    ``local_batch`` is this rank's share of the global batch
    (``parallel.mesh.batch_slice``): ``train.batch_size / mesh.data`` clips
    on the batch axis (axis 1 with ``steps_per_call`` > 1). The metrics are
    the group's means, the same on every rank."""
    if cfg.train.batch_size % mesh.data:
        raise ValueError(f"train.batch_size={cfg.train.batch_size} must be divisible by the "
                         f"data mesh axis ({mesh.data} ranks)")
    if mesh.model > 1:
        raise ValueError(f"make_dp_train_step got a mesh with model={mesh.model} > 1; channel "
                         "tensor parallelism is ROADMAP Queue 1 item 8")
    step = make_multi_train_step(cfg, mesh.device, seed, group=mesh.group)
    local, axis = cfg.train.batch_size // mesh.data, int(cfg.train.steps_per_call > 1)

    def dp_step(state, batch, randoms=None):
        got = batch["actions"].shape[axis]
        if got != local:
            raise ValueError(f"rank {mesh.rank} got a batch of {got} clips; its share of "
                             f"train.batch_size={cfg.train.batch_size} over {mesh.data} ranks "
                             f"is {local} (parallel.mesh.batch_slice)")
        return step(state, batch) if randoms is None else step(state, batch, randoms)

    return dp_step
