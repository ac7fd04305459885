"""The benchmark's own tests: ``python -m pytest benchmark/tests -q``.

Tests marked ``chip`` need a CUDA card and skip without one (the ``cuda``
fixture decides, inside the test); the rest run on the CPU at small sizes.
The repository's ``pytest tests/`` does not collect this directory.
"""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


TINY_MODEL = dict(image_size=16, g_levels=2, g_base_channels=8, d_levels=2, d_base_channels=8,
                  group_norm_groups=4)


def tiny(found: dict, batch: int = 4, horizon: int = 3, steps: int = 4) -> dict:
    """``found`` (``harness.find_cell``) with its configuration cut to a size
    the CPU runs in seconds: every width and depth small, the batch, the
    rollout and the steps a call few."""
    found = copy.deepcopy(found)
    cfg = found["config"]["config"]
    cfg["model"].update(TINY_MODEL)
    cfg["train"].update(batch_size=batch, rollout_length=min(cfg["train"]["rollout_length"],
                                                             horizon),
                        steps_per_call=steps)
    return found
