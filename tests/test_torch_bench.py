"""The port's ``bench`` (``bench.py``, the ``bench`` subcommand) on the CPU:
its JSON keys, and its analytic FLOP count against the JAX package's
``utils/profiling.analytic_matmul_cost`` on the XLA-backend step at the same
shapes (the count the JAX bench reports). The serving half
(``run_infer_bench``, ``run_serving_bench``, ``bench --mode infer|serving``)
at the reference's tiny smoke config (tests/test_bench.py), its line's keys
against the JAX function's line at the same config."""

import dataclasses
import json
import math
import types
from collections import defaultdict

import jax
import pytest
import torch

from action_conditioned_gans_tpu import bench as jax_bench
from action_conditioned_gans_tpu import config as jcfg
from action_conditioned_gans_tpu.train import init_state as jax_init_state
from action_conditioned_gans_tpu.train.step import make_train_step as jax_make_train_step
from action_conditioned_gans_tpu.utils import profiling
from action_conditioned_gans_tpu_torch import cli
from action_conditioned_gans_tpu_torch.bench import (
    run_bench,
    run_infer_bench,
    run_serving_bench,
    step_flop_counts,
)
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


# -- the serving half: run_infer_bench, run_serving_bench, bench --mode infer|serving -------


def serving_config():
    """tests/test_bench.py's smoke config of the JAX serving benches."""
    return jcfg.Config(
        name="tiny",
        model=jcfg.ModelConfig(image_size=16, g_levels=2, g_base_channels=8, d_levels=2,
                               d_base_channels=8, group_norm_groups=4, compute_dtype="float32",
                               state_dim=3),
        data=jcfg.DataConfig(seq_len=3),
        train=jcfg.TrainConfig(batch_size=2, rollout_length=2),
    )


def check_serving_line(out, ref_keys, numbers):
    """The JAX line's keys plus ``peak_memory_gb`` (None on the CPU); the
    header; every time and rate finite and positive."""
    assert sorted(out) == sorted([*ref_keys, "peak_memory_gb"])
    assert (out["config"], out["device"], out["image_size"]) == ("tiny", "cpu", 16)
    assert (out["batch_size"], out["rollout_length"], out["peak_memory_gb"]) == (2, 2, None)
    for k in numbers:
        assert isinstance(out[k], (int, float)) and math.isfinite(out[k]) and out[k] > 0, k


INFER_NUMBERS = ("infer_step_latency_ms", "infer_fps_per_chip", "rollout_latency_ms",
                 "rollout_fps_per_chip", "barrier_round_trip_ms")
SERVING_NUMBERS = ("serving_live_ms", "serving_live_fps", "artifact_bytes", "serving_aot_ms",
                   "serving_aot_fps")


def test_run_infer_bench_has_the_reference_line():
    """The generator-only bench at the reference's smoke config: k=3, one
    window of two calls, on the CPU; the JAX function's keys."""
    jc = serving_config()
    ref = jax_bench.run_infer_bench(jc, k=3, windows=1, calls_per_window=2)
    out = run_infer_bench(port_config(jc), k=3, windows=1, calls_per_window=2, device="cpu")
    check_serving_line(out, ref, INFER_NUMBERS)
    assert out["infer_fps_per_chip"] == pytest.approx(2 * 3 / (out["infer_step_latency_ms"] * 3e-3))
    assert out["rollout_fps_per_chip"] == pytest.approx(2 * 2 / (out["rollout_latency_ms"] * 1e-3))


def test_run_serving_bench_has_the_reference_line():
    """The whole-request bench (live Predictor against the AOT artifact) at
    the reference's smoke config; the JAX function's keys; the artifact's
    bytes on disk; the overhead is the two times' ratio."""
    jc = serving_config()
    ref = jax_bench.run_serving_bench(jc, windows=1, calls_per_window=2)
    out = run_serving_bench(port_config(jc), windows=1, calls_per_window=2, device="cpu")
    check_serving_line(out, ref, SERVING_NUMBERS)
    assert isinstance(out["artifact_bytes"], int)
    assert out["aot_overhead_pct"] == pytest.approx(
        (out["serving_aot_ms"] / out["serving_live_ms"] - 1) * 100)
    assert out["serving_live_fps"] == pytest.approx(2 * 2 / (out["serving_live_ms"] * 1e-3))


TINY_ARGS = ["--device", "cpu", "--set", "model.image_size=16", "--set", "model.g_levels=2",
             "--set", "model.g_base_channels=8", "--set", "model.d_levels=2",
             "--set", "model.d_base_channels=8", "--set", "model.group_norm_groups=4",
             "--set", "model.compute_dtype=float32", "--set", "train.batch_size=2"]


@pytest.mark.parametrize("mode", ["infer", "serving"])
def test_bench_mode_prints_one_json_line(capsys, monkeypatch, mode):
    """``bench --mode infer|serving`` prints exactly one line, the function's:
    the batch from ``train.batch_size``, T from the one ``--rollout-length``,
    the bank from ``--bank``; the function gets the CLI's device."""
    from action_conditioned_gans_tpu_torch import bench

    seen = {}
    real = getattr(bench, f"run_{mode}_bench")

    def spy(cfg, **kw):
        seen.update(kw)
        extra = dict(windows=1, calls_per_window=1)
        return real(cfg, **kw, **extra)

    monkeypatch.setattr(bench, f"run_{mode}_bench", spy)
    argv = ["bench", "--mode", mode, *TINY_ARGS, "--rollout-length", "3", "--bank", "2"]
    assert cli.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert (out["config"], out["batch_size"], out["rollout_length"]) == ("config1", 2, 3)
    assert seen["device"] == "cpu" and seen["rollout"] == 3
    assert seen.get("k") == (2 if mode == "infer" else None)
    numbers = INFER_NUMBERS if mode == "infer" else SERVING_NUMBERS
    assert all(math.isfinite(out[k]) and out[k] > 0 for k in numbers)


@pytest.mark.parametrize("argv", [["--multihost", "--mode", "infer"],
                                  ["--multihost", "--mode", "serving"],
                                  ["--mode", "infer", "--rollout-length", "2,3"]],
                         ids=["multihost_infer", "multihost_serving", "two_horizons"])
def test_bench_mode_refuses_a_group_and_two_horizons(capsys, argv):
    """The serving benches run on one device with one T: ``--multihost``, or
    two horizons, is the parser's error (exit 2) before anything runs."""
    with pytest.raises(SystemExit) as e:
        cli.main(["bench", *argv, *TINY_ARGS])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert ("drop --multihost" if "--multihost" in argv else "one --rollout-length") in err
