"""The mesh of a parallel run and its batch layout (port of the JAX
package's ``parallel/mesh.py``).

One process per device: rank r of a ``torch.distributed`` group of W ranks
runs on its own device. The mesh is ``(data, model)`` with ``model`` the
inner axis, as in the reference's layout: rank r sits at
``(r // model, r % model)``. The ranks of one data index form a model group
(they hold the same rows and split the conv channels: ``parallel/tp.py``);
the ranks of one model index form a data group (they hold the same shards
and average their gradients). Without an initialised process group the mesh
is one rank with no group, and nothing is reduced.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import torch
import torch.distributed as dist

from action_conditioned_gans_tpu_torch.config import MeshConfig, resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the run: ``rank`` of ``world`` ranks, the
    ``data`` and ``model`` axis sizes, the rank's ``device``, ``group`` (the
    whole run: barriers, the SIGTERM flag; None for a run of one process
    without a process group), ``data_group`` (the ranks that share this
    rank's model index: the gradient and metric means, batch statistics;
    ``group`` itself without a model axis, None on a data axis of one rank) and ``model_group`` (the ranks
    that share its data index: the channel collectives; None without a
    model axis)."""

    rank: int
    world: int
    data: int
    model: int
    device: torch.device
    group: Any = None
    data_group: Any = None
    model_group: Any = None

    @property
    def data_index(self) -> int:
        """The rank's place on the data axis: which rows of a batch it holds."""
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        """The rank's place on the model axis: which channel shard it holds."""
        return self.rank % self.model


def make_mesh(cfg: MeshConfig, group=None, device=None) -> Mesh:
    """The mesh of ``cfg`` over ``group`` (the default group when None and
    one is initialised), on ``device`` (cuda unless another is given).

    ``cfg.data == -1`` means the group's size over ``cfg.model``; otherwise
    ``data x model`` must fill the group. With a model axis every rank
    creates every data and model subgroup, in the same order (a rank that
    skipped one would hang the others)."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    world = dist.get_world_size(group) if group is not None else 1
    rank = dist.get_rank(group) if group is not None else 0
    model = max(cfg.model, 1)
    axes = f"mesh data={cfg.data}" + (f" x model={model}" if model > 1 else "")
    hint = (" (run one process per device, e.g. torchrun --nproc-per-node N ... --multihost, "
            "or set mesh.data=-1)")
    if cfg.data == -1 and world % model:
        raise ValueError(f"{axes} needs a multiple of {model} ranks; this process group has "
                         f"{world}{hint}")
    data = world // model if cfg.data == -1 else cfg.data
    if data * model != world:
        raise ValueError(f"{axes} needs a process group of {data * model} ranks; this one has "
                         f"{world}{hint}")
    data_group, model_group = group, None
    if model > 1:
        ranks = dist.get_process_group_ranks(group)
        for d in range(data):
            g = dist.new_group([ranks[d * model + j] for j in range(model)])
            if d == rank // model:
                model_group = g
        data_group = None  # a data axis of one rank reduces nothing
        for j in range(model if data > 1 else 0):
            g = dist.new_group([ranks[d * model + j] for d in range(data)])
            if j == rank % model:
                data_group = g
    return Mesh(rank=rank, world=world, data=data, model=model, device=resolve_device(device),
                group=group, data_group=data_group, model_group=model_group)


def shard_rows(n: int, rank: int, size: int) -> slice:
    """Rank ``rank`` of ``size``'s rows of a batch axis of ``n``: [r*n/size,
    (r+1)*n/size). Raises where ``size`` does not divide ``n``."""
    if n % size:
        raise ValueError(f"batch {n} is not divisible by the mesh data axis ({size} ranks)")
    per = n // size
    return slice(rank * per, (rank + 1) * per)


def batch_slice(batch: Mapping[str, Any], mesh: Mesh, stacked: bool = False) -> dict:
    """The rows of a global batch that ``mesh.data_index`` holds
    (:func:`shard_rows` of the batch axis; the ranks of one model group hold
    the same rows): axis 1 when ``stacked`` ((k, B, ...) batches of
    ``steps_per_call`` steps), axis 0 otherwise. With :func:`shard_rows`,
    the one source of the batch layout."""
    axis = 1 if stacked else 0
    return {key: value[(slice(None),) * axis + (shard_rows(value.shape[axis], mesh.data_index,
                                                            mesh.data),)]
            for key, value in batch.items()}
