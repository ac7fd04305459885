"""The data-parallel training step (port of the JAX package's
``parallel/dp.py``), and the dp x tp step on a mesh with a model axis.

Every rank runs the whole fused G+D step on its share of the batch, with
the kernels the single-device step launches. The step reduces what the JAX
``shard_map`` step ``pmean``s: D's gradients before D's Adam, G's before
G's, the metrics, and, with ``norm="batch"``, each batch-norm layer's
moments (``ops.api.batch_stats_group``). The state stays replicated because
every rank applies the same averaged gradients. No
``DistributedDataParallel``: the step takes its gradients with
``torch.autograd.grad`` and updates D before G.

On a mesh with a model axis the same reductions run over the data group,
each rank holds its channel shard of the state and the step is the one of
``parallel/tp.py`` (the reference's GSPMD path).
"""

from __future__ import annotations

from typing import Optional

from action_conditioned_gans_tpu_torch.config import Config
from action_conditioned_gans_tpu_torch.parallel.mesh import Mesh
from action_conditioned_gans_tpu_torch.train.step import make_multi_train_step


def make_dp_train_step(cfg: Config, mesh: Mesh, seed: Optional[int] = None):
    """``(state, local_batch, randoms=None) -> (state, metrics)`` on
    ``mesh.device``: :func:`make_multi_train_step` over ``mesh.data_group``,
    and on a mesh with a model axis over this rank's channel shard
    (``parallel.tp.make_tp_train_step``).

    ``local_batch`` is the rows of the global batch that this rank's data
    index holds (``parallel.mesh.batch_slice``): ``train.batch_size /
    mesh.data`` clips on the batch axis (axis 1 with ``steps_per_call`` >
    1). ``randoms`` are this rank's draws, or with a model axis the global
    batch's. The metrics are the data group's means, the same on every
    rank."""
    if cfg.train.batch_size % mesh.data:
        raise ValueError(f"train.batch_size={cfg.train.batch_size} must be divisible by the "
                         f"data mesh axis ({mesh.data} ranks)")
    step = make_multi_train_step(cfg, mesh.device, seed, group=mesh.data_group,
                                 tp=mesh if mesh.model > 1 else None)
    local, axis = cfg.train.batch_size // mesh.data, int(cfg.train.steps_per_call > 1)

    def dp_step(state, batch, randoms=None):
        got = batch["actions"].shape[axis]
        if got != local:
            raise ValueError(f"rank {mesh.rank} got a batch of {got} clips; its share of "
                             f"train.batch_size={cfg.train.batch_size} over {mesh.data} data "
                             f"ranks is {local} (parallel.mesh.batch_slice)")
        return step(state, batch) if randoms is None else step(state, batch, randoms)

    return dp_step
