"""Checkpoints of the training state on local disk, in PyTorch's own format
(the JAX package saves with orbax, which the port does not use).

Layout: ``directory/<step>/state.pt``, one ``torch.save`` of a nested dict
of tensors, ints and strings (``train.state.state_to_host``). A save writes
``directory/<step>.tmp-<pid>/`` first, flushes it to disk and renames it
into place, so a process killed mid-save leaves no half-written step; only
all-digit names count as steps. The newest ``keep`` steps are kept.

A step that is already on disk is never written again: :meth:`save` returns
False. The JAX package's loop can save the same step twice (SIGTERM on a
``checkpoint_every`` boundary), which orbax refuses with an error.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, List, Mapping, Optional

import torch

_FILE = "state.pt"


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _first_tensor(tree) -> Optional[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, Mapping):
        for v in tree.values():
            found = _first_tensor(v)
            if found is not None:
                return found
    return None


def _check_like(got, want, key: str = "") -> None:
    """Raise naming the first key, shape or dtype where ``got`` (from disk)
    differs from ``want`` (the template)."""
    where = key or "<root>"
    if isinstance(want, Mapping):
        if not isinstance(got, Mapping):
            raise ValueError(f"checkpoint: {where} is {type(got).__name__}, want a dict")
        for k in want:
            if k not in got:
                raise ValueError(f"checkpoint: key {key + '/' if key else ''}{k} is missing")
        for k in got:
            if k not in want:
                raise ValueError(f"checkpoint: key {key + '/' if key else ''}{k} is not in the template")
        for k in want:
            _check_like(got[k], want[k], f"{key}/{k}" if key else str(k))
    elif isinstance(want, torch.Tensor):
        if not isinstance(got, torch.Tensor):
            raise ValueError(f"checkpoint: {where} is {type(got).__name__}, want a tensor")
        if got.shape != want.shape:
            raise ValueError(f"checkpoint: {where} has shape {tuple(got.shape)}, "
                             f"the template {tuple(want.shape)}")
        if got.dtype != want.dtype:
            raise ValueError(f"checkpoint: {where} has dtype {got.dtype}, the template {want.dtype}")
    elif type(got) is not type(want):
        raise ValueError(f"checkpoint: {where} is {type(got).__name__}, want {type(want).__name__}")


class CheckpointManager:
    """Step-numbered checkpoints under ``directory``, the newest ``keep`` kept."""

    def __init__(self, directory: str, keep: int = 3):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> List[int]:
        return sorted(int(n) for n in os.listdir(self.directory) if n.isdigit())

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: Mapping[str, Any], force: bool = False) -> bool:
        """Write ``state`` (a nested dict of CPU tensors, ints and strings) as
        ``step``. Returns False, and writes nothing, when ``step`` is already
        on disk. ``force`` is kept for the JAX package's interface: every save
        here is synchronous and unconditional."""
        del force
        final = os.path.join(self.directory, str(step))
        if os.path.exists(final):
            return False
        tmp = os.path.join(self.directory, f"{step}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        with open(os.path.join(tmp, _FILE), "wb") as f:
            torch.save(dict(state), f)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(tmp)
        os.replace(tmp, final)
        _fsync_dir(self.directory)
        for old in self.all_steps()[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))
        return True

    def restore(self, template: Mapping[str, Any], step: Optional[int] = None,
                device=None) -> dict:
        """Load ``step`` (the latest when None) onto ``device``, or the device
        of the template's tensors when None (a template on the meta device
        then needs a ``device``). Raises naming the first key, shape or dtype
        that differs from ``template``; strings and ints are taken from disk."""
        if device is None:
            ref = _first_tensor(template)
            device = ref.device if ref is not None else torch.device("cpu")
        state = self.load(step, device)
        _check_like(state, template)
        return state

    def load(self, step: Optional[int] = None, device="cpu") -> dict:
        """The tree at ``step`` (the latest when None) on ``device``, as it is
        on disk (no template, no check)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint found in {self.directory}")
        return torch.load(os.path.join(self.directory, str(step), _FILE), map_location=device,
                          weights_only=True)

    def wait(self) -> None:
        """Saves are synchronous; kept for the JAX package's interface."""

    def close(self) -> None:
        """Nothing to release; kept for the JAX package's interface."""
