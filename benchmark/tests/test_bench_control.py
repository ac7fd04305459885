"""The output check's control and planted faults, which have to come out as
not correct: the reference itself in the program's place, computed in
float8 (e4m3, one scale a tensor) where the configuration states bfloat16,
and the faults each cell can have (``benchmark/calibrate.py``). Each has
to read over the cell's limit in at least one number the cell compares.

On the CPU at the cells' widths and depths on smaller frames with a small
batch (``smaller``); marked ``chip``, at the cells' own sizes on three seeds (run on the
card: ``python -m pytest benchmark/tests/test_bench_control.py -m chip``).
"""

import copy

import pytest
import torch

from benchmark import calibrate, harness

torch.set_num_threads(4)
CELLS = ["config5.train", "config5.serve", "config1.serve"]


def failed(found: dict, readings: dict) -> list:
    """The compared numbers that ``readings`` read over the cell's limits."""
    return [k for k, limit in found["limits"].items() if not readings[k] <= limit]


def controls(found: dict, seed: int, device) -> dict:
    fn = (calibrate.train_controls if found["traffic"]["kind"] == "train_steps"
          else calibrate.serve_controls)
    out = fn(found, seed, device)
    out.pop("float32_reference", None)
    return out


def smaller(found: dict) -> dict:
    """The cell at its widths and depths on smaller frames, a smaller batch
    and a shorter rollout: 128x128 and 4 clips for training, where the
    float8 control's loss stands as far from float32 as at the cell's size
    (on 64x64 frames and 2 clips it reads half as far); 64x64 for serving."""
    found = copy.deepcopy(found)
    cfg = found["config"]["config"]
    train = found["traffic"]["kind"] == "train_steps"
    cfg["model"]["image_size"] = 128 if train else 64
    cfg["train"].update(batch_size=4 if train else 2,
                        rollout_length=min(cfg["train"]["rollout_length"], 2))
    found["traffic"] = dict(found["traffic"], candidates=4, horizon=6)
    return found


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_and_the_faults_are_not_correct(cell):
    found = smaller(harness.find_cell(cell))
    for side, readings in controls(found, 1, torch.device("cpu")).items():
        assert failed(found, readings), (side, readings, found["limits"])


@pytest.mark.chip
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_and_the_faults_are_not_correct_at_the_cells_size(cell, cuda):
    found = harness.find_cell(cell)
    for seed in (7, 2**31 + 11, 2**33 + 5):
        for side, readings in controls(found, seed, cuda).items():
            assert failed(found, readings), (seed, side, readings, found["limits"])
