"""The mesh of a data-parallel run and its batch layout (port of the JAX
package's ``parallel/mesh.py``).

One process per device: rank r of a ``torch.distributed`` group of W ranks
runs on its own device and holds the replicated state; the ``data`` axis is
the group, and the ``model`` axis (channel tensor parallelism) is not ported
(ROADMAP Queue 1 item 8). Without an initialised process group the mesh is
one rank with no group, and nothing is reduced.
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
    ``data`` and ``model`` axis sizes, the rank's ``device``, and ``group``
    (None for a run of one process without a process group)."""

    rank: int
    world: int
    data: int
    model: int
    device: torch.device
    group: Any = None


def make_mesh(cfg: MeshConfig, group=None, device=None) -> Mesh:
    """The mesh of ``cfg`` over ``group`` (the default group when None and
    one is initialised), on ``device`` (cuda unless another is given).

    ``cfg.data == -1`` means the group's size; an explicit ``data`` must
    equal it. ``cfg.model > 1`` raises NotImplementedError."""
    if cfg.model > 1:
        raise NotImplementedError(
            f"mesh model={cfg.model}: channel tensor parallelism is not ported yet "
            "(ROADMAP Queue 1 item 8)")
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    world = dist.get_world_size(group) if group is not None else 1
    rank = dist.get_rank(group) if group is not None else 0
    if cfg.data not in (-1, world):
        raise ValueError(
            f"mesh data={cfg.data} needs a process group of {cfg.data} ranks; this one has "
            f"{world} (run one process per device, e.g. torchrun --nproc-per-node "
            f"{cfg.data} ... --multihost, or set mesh.data=-1)")
    return Mesh(rank=rank, world=world, data=world, model=1, device=resolve_device(device),
                group=group)


def shard_rows(n: int, rank: int, size: int) -> slice:
    """Rank ``rank`` of ``size``'s rows of a batch axis of ``n``: [r*n/size,
    (r+1)*n/size). Raises where ``size`` does not divide ``n``."""
    if n % size:
        raise ValueError(f"batch {n} is not divisible by the mesh data axis ({size} ranks)")
    per = n // size
    return slice(rank * per, (rank + 1) * per)


def batch_slice(batch: Mapping[str, Any], mesh: Mesh, stacked: bool = False) -> dict:
    """Rank ``mesh.rank``'s rows of a global batch (:func:`shard_rows` of
    the batch axis): axis 1 when ``stacked`` ((k, B, ...) batches of
    ``steps_per_call`` steps), axis 0 otherwise. With :func:`shard_rows`,
    the one source of the batch layout."""
    axis = 1 if stacked else 0
    return {key: value[(slice(None),) * axis + (shard_rows(value.shape[axis], mesh.rank,
                                                            mesh.data),)]
            for key, value in batch.items()}
