"""The per-layer metrics read from the program's own spans and counters
(``benchmark/program_spans.py``): a traced run of each cell at tiny widths
on the CPU prints each of them as a float; the conv blocks a request
dispatches are the tiny generator's blocks times the mix's horizon, and
each span metric reads above 0 (a reader that found no record would read
0.0)."""

import time

import pytest
import torch

from benchmark import harness

from conftest import tiny

torch.set_num_threads(2)
SPANS = {"config5.train": ["g_rollout_device_ms.train", "d_update_device_ms.train",
                           "g_grad_device_ms.train", "adam_device_ms.train"],
         "config5.serve": ["rollout_inputs_ms.serve", "rollout_step_host_ms.serve"],
         "config1.serve": ["rollout_inputs_ms.serve", "rollout_step_host_ms.serve"]}
COUNTERS = {"config5.train": ["allocator_calls.train"],
            "config5.serve": ["host_dispatches.serve"],
            "config1.serve": ["host_dispatches.serve"]}


def generator_blocks(model: dict) -> int:
    from action_conditioned_gans_tpu_torch.config import config_from_dict
    from action_conditioned_gans_tpu_torch.models import Generator
    from action_conditioned_gans_tpu_torch.models.common import ConvBlock

    with torch.device("meta"):
        gen = Generator(config_from_dict({"model": model}).model)
    return sum(isinstance(m, ConvBlock) for m in gen.modules())


@pytest.mark.parametrize("cell", sorted(SPANS))
def test_a_traced_run_prints_the_programs_own_metrics(cell):
    from action_conditioned_gans_tpu_torch.utils import profiling

    found = tiny(harness.find_cell(cell))
    cfg = found["config"]["config"]
    profiling.reset()  # this process's earlier runs
    line = harness.run_cell(cell, 2**33 + 5, 0.3, True, time.perf_counter(), device="cpu",
                            config=cfg)
    metrics = {k: v["value"] for k, v in line["metrics"].items()}
    for name in SPANS[cell] + COUNTERS[cell]:
        assert isinstance(metrics.get(name), float), name
    for name in SPANS[cell]:
        assert metrics[name] > 0, name
    if cell.endswith(".serve"):
        want = generator_blocks(cfg["model"]) * found["traffic"]["horizon"]
        assert want > 0 and metrics["host_dispatches.serve"] == want
    else:
        assert metrics["allocator_calls.train"] == 0.0  # no caching allocator on the CPU
