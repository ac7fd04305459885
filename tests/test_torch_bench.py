"""The port's ``bench`` (``bench.py``, the ``bench`` subcommand) on the CPU:
its JSON keys, and its analytic FLOP count against the JAX package's
``utils/profiling.analytic_matmul_cost`` on the XLA-backend step at the same
shapes (the count the JAX bench reports)."""

import dataclasses
import json
import math
import types
from collections import defaultdict

import jax
import pytest
import torch

from action_conditioned_gans_tpu.train import init_state as jax_init_state
from action_conditioned_gans_tpu.train.step import make_train_step as jax_make_train_step
from action_conditioned_gans_tpu.utils import profiling
from action_conditioned_gans_tpu_torch import cli
from action_conditioned_gans_tpu_torch.bench import run_bench, step_flop_counts
from tests.test_torch_train import port_config
from tests.test_train_step import make_batch, tiny_config

torch.set_num_threads(1)
KEYS = ("config", "image_size", "batch_size", "rollout_length", "steps_per_call", "num_chips",
        "p50_step_latency_ms", "p90_step_latency_ms", "frames_per_sec_per_chip", "device",
        "first_step_s", "step_tflops_analytic", "achieved_tflops_per_chip_analytic",
        "roofline_utilization_analytic", "analytic_flops_count_remat_recompute",
        "peak_memory_gb")


def test_run_bench_returns_every_key_finite():
    cfg = port_config(tiny_config(steps_per_call=2, adam_moment_dtype="bfloat16"))
    out = run_bench(cfg, steps=3, warmup=2, device="cpu")
    assert sorted(out) == sorted(KEYS)
    assert (out["config"], out["device"], out["num_chips"], out["steps_per_call"]) == (
        "tiny", "cpu", 1, 2)
    assert out["analytic_flops_count_remat_recompute"] is False
    assert out["peak_memory_gb"] is None  # a device metric: the CPU has none
    for k, v in out.items():
        if k not in ("config", "device", "analytic_flops_count_remat_recompute",
                     "peak_memory_gb"):
            assert isinstance(v, (int, float)) and math.isfinite(v) and v > 0, k
    assert out["p90_step_latency_ms"] >= out["p50_step_latency_ms"]
    assert out["frames_per_sec_per_chip"] == pytest.approx(
        2 / out["p50_step_latency_ms"] * 1e3)


def jax_flops_by_primitive(closed):
    """JAX's analytic FLOPs of a closed jaxpr split by primitive: each conv
    or dot equation priced by the package's own counter, scan bodies times
    their length."""
    out = defaultdict(float)

    def walk(jaxpr, mult):
        for eqn in jaxpr.eqns:
            name = eqn.primitive.name
            if name in ("conv_general_dilated", "dot_general"):
                flops, _ = profiling._jaxpr_matmul_cost(types.SimpleNamespace(eqns=[eqn]), mult,
                                                        1.0, 1.0)
                out[name] += flops
                continue
            sub_mult = mult * (eqn.params.get("length", 1) if name == "scan" else 1)
            for sub in profiling._iter_subjaxprs(eqn):
                walk(sub.jaxpr if hasattr(sub, "jaxpr") else sub, sub_mult)

    walk(closed.jaxpr, 1.0)
    return dict(out)


FLOP_CASES = {
    "f32_T1": (dict(), dict()),
    "bf16_T2_state_skips_extra_d": (dict(rollout_length=2, batch_size=3),
                                    dict(compute_dtype="bfloat16", state_dim=3,
                                         skip_connections=True, d_extra_layers=1)),
}


@pytest.mark.parametrize("name", sorted(FLOP_CASES))
def test_step_flops_match_jax_analytic_count(name):
    """Within 2% of the JAX count, for convolutions and for matrix products
    apart (a failure names which of the two differs), and in total."""
    train_kw, model_kw = FLOP_CASES[name]
    jc = tiny_config(**train_kw)
    jc = dataclasses.replace(jc, model=dataclasses.replace(jc.model, backend="xla", **model_kw))
    # Shapes are all the count reads: the state and the batch stay abstract.
    args = (jax.eval_shape(lambda: jax_init_state(jc, jax.random.PRNGKey(0))),
            jax.eval_shape(lambda: make_batch(jc)), jax.random.PRNGKey(0))
    # analytic_matmul_cost(fn, *args) is _jaxpr_matmul_cost of fn's jaxpr;
    # the step is traced once for both counts.
    closed = jax.make_jaxpr(jax_make_train_step(jc))(*args)
    total, _ = profiling._jaxpr_matmul_cost(closed.jaxpr, 1.0, 1.0, 1.0)
    theirs = jax_flops_by_primitive(closed)
    assert sum(theirs.values()) == pytest.approx(total)
    counts = step_flop_counts(port_config(jc))
    ops = {"conv_general_dilated": ("aten.convolution", "aten.convolution_backward"),
           "dot_general": ("aten.mm", "aten.addmm", "aten.bmm")}
    assert set(counts) <= {op for group in ops.values() for op in group}, counts
    for primitive, aten_ops in ops.items():
        mine = sum(counts.get(op, 0) for op in aten_ops)
        assert mine == pytest.approx(theirs.get(primitive, 0.0), rel=0.02), (
            f"{primitive}: the port counts {mine} FLOPs in {aten_ops}, JAX "
            f"{theirs.get(primitive, 0.0)}")
    assert sum(counts.values()) == pytest.approx(total, rel=0.02)


def test_remat_flops_count_the_recomputed_forward():
    """With remat_rollout the backward runs G's forward again: the step's
    count grows by exactly one generator forward over the B*T transitions,
    in aten.convolution; the time chunks change nothing."""
    from torch.utils.flop_counter import FlopCounterMode

    from action_conditioned_gans_tpu_torch.models import Generator

    def counts(**kw):
        return step_flop_counts(port_config(tiny_config(rollout_length=4, batch_size=3, **kw)))

    plain, chunked = counts(), counts(rollout_time_chunk=2)
    remat = counts(rollout_time_chunk=2, remat_rollout=True)
    assert chunked == plain
    m = port_config(tiny_config()).model
    with torch.device("meta"):
        gen = Generator(m)
        frame, action = torch.empty(12, 16, 16, 3), torch.empty(12, 4)
    counter = FlopCounterMode(display=False)
    with counter, torch.no_grad():
        gen(frame, action)
    forward = counter.get_total_flops()
    assert remat["aten.convolution"] - plain["aten.convolution"] == forward > 0
    assert {k: v for k, v in remat.items() if k != "aten.convolution"} == {
        k: v for k, v in plain.items() if k != "aten.convolution"}


def test_bench_subcommand_prints_one_json_line(capsys):
    argv = ["bench", "--device", "cpu", "--steps", "2", "--set", "model.image_size=16",
            "--set", "model.g_levels=2", "--set", "model.g_base_channels=8",
            "--set", "model.d_levels=2", "--set", "model.d_base_channels=8",
            "--set", "model.group_norm_groups=4", "--set", "train.batch_size=2",
            "--set", "train.steps_per_call=1"]
    assert cli.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    out = json.loads(lines[-1])
    assert sorted(out) == sorted(KEYS) and out["config"] == "config1"
