"""``benchmark/flops.py``'s closed forms against the program's own counter,
``bench.step_flop_counts`` (``torch.utils.flop_counter`` on meta tensors,
remat off), and against a meta-tensor count of the generator's forward."""

import dataclasses
import json
import os

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import flops

from conftest import ROOT


def config(name: str) -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs", f"{name}.json")) as f:
        return json.load(f)["config"]


def test_pinned_counts():
    """The counts the per-layer mfus divide by, as the program's counter
    gave them when the benchmark was written."""
    assert flops.step_flops(config("config5")) == 94_839_798_497_280
    assert flops.step_flops(config("config1")) == 358_831_095_808
    assert flops.generator_forward_flops(config("config5")["model"], 32) == 256_699_793_408
    # config5.serve's request: 8 candidates, 30 steps.
    assert flops.generator_forward_flops(config("config5")["model"], 8) == 64_174_948_352
    assert flops.generator_forward_flops(config("config5")["model"], 8) * 30 == pytest.approx(
        1.92525e12, rel=1e-5)


def port_config(cfg: dict, remat: bool = False):
    from action_conditioned_gans_tpu_torch.config import config_from_dict

    c = config_from_dict(cfg)
    return c.replace(train=dataclasses.replace(c.train, remat_rollout=remat))


@pytest.mark.parametrize("name,batch", [("config5", None), ("config1", None), ("config1", 1024),
                                        ("config2", None), ("config3", None), ("config4", None)])
def test_step_flops_match_the_programs_counter(name, batch):
    from action_conditioned_gans_tpu_torch.bench import step_flop_counts
    from action_conditioned_gans_tpu_torch.config import PRESETS

    if name in ("config5", "config1"):
        cfg = config(name)
    else:
        cfg = json.loads(json.dumps(dataclasses.asdict(PRESETS[name])))
    if batch:
        cfg["train"]["batch_size"] = batch
    assert flops.step_flops(cfg) == sum(step_flop_counts(port_config(cfg)).values())


def test_remat_recompute_is_left_out():
    """The program's counter counts the forward that remat recomputes; the
    yardstick does not: the two differ by one generator forward over B*T."""
    from action_conditioned_gans_tpu_torch.bench import step_flop_counts

    cfg = config("config5")
    with_remat = sum(step_flop_counts(port_config(cfg, remat=True)).values())
    g = flops.generator_forward_flops(cfg["model"], 32 * 30)
    assert with_remat == flops.step_flops(cfg) + g
    assert with_remat / 1e12 == pytest.approx(102.54, abs=0.01)


@pytest.mark.parametrize("name,batch", [("config5", 32), ("config5", 8), ("config1", 128)])
def test_generator_forward_matches_a_meta_count(name, batch):
    from action_conditioned_gans_tpu_torch.models import Generator

    cfg = port_config(config(name))
    m = cfg.model
    with torch.device("meta"):
        gen = Generator(m)
        frame = torch.zeros(batch, m.image_size, m.image_size, m.image_channels)
        action = torch.zeros(batch, m.action_dim)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        gen(frame, action)
    assert flops.generator_forward_flops(config(name)["model"], batch) == counter.get_total_flops()


def test_kernel_costs():
    """Kernels 1-4's bounds: operations or bytes, whichever is longer."""
    # A bf16 3x3 conv, 256 -> 256 channels over 32 x 32 x 32: compute-bound.
    flops_ = 2 * 32 * 32 * 32 * 9 * 256 * 256
    assert flops.conv_cost(32, 32, 32, 256, 3, 256, 1, False, 2) == pytest.approx(
        flops_ / flops.PEAK_BF16_FLOPS)
    # A conv-transpose counts its input's pixels; its output is twice as wide.
    nbytes = (2 * 8 * 8 * 16 + 16 * 16 * 3 + 2 * 16 * 16 * 3) * 2 + 2 * 3 * 4
    assert flops.conv_cost(2, 8, 8, 16, 4, 3, 2, True, 2) == pytest.approx(
        max(2 * 2 * 8 * 8 * 16 * 16 * 3 / flops.PEAK_BF16_FLOPS, nbytes / flops.PEAK_BYTES))
    n = 32 * 128 * 128 * 64
    assert flops.gn_cost(32, 128, 128, 64, 2) == pytest.approx((2 * n * 2 + 8 * 64) / flops.PEAK_BYTES)
    assert flops.gn_bwd_cost(32, 128, 128, 64, 2, 4) == pytest.approx(
        (n * (4 + 3 * 2) + 12 * 64) / flops.PEAK_BYTES)
