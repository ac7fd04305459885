"""Training-step and serving benchmarks (port of the JAX package's
``bench.run_bench``, ``run_infer_bench`` and ``run_serving_bench``).

    python -m action_conditioned_gans_tpu_torch bench --preset config1 \
        --set train.batch_size=128 --set train.adam_moment_dtype=bfloat16
    python -m action_conditioned_gans_tpu_torch bench --mode infer --preset config1 \
        --set train.batch_size=128
    python -m action_conditioned_gans_tpu_torch bench --mode serving --preset config1 \
        --set train.batch_size=128 --rollout-length 10

``--mode infer`` (:func:`run_infer_bench`) times the generator alone on
inputs already on the device; ``--mode serving`` (:func:`run_serving_bench`)
times a whole rollout request from host arrays to host frames, the live
``Predictor`` against the AOT program. Each prints one JSON line.

The training line (``--mode train``, the default): the p50 / p90 per-step
latency of ``make_multi_train_step`` over three timed windows on stacked
synthetic batches made on the device, frames per second, the time to the
first finished step (kernel build and load included; it stands in for the
JAX package's ``compile_s``), the analytic FLOPs of one step against the
H100's dense bf16 peak, and the peak memory the run allocated on the card.

Each window ends in a host read of one metric and ``torch.cuda.synchronize``,
so it measures finished steps, not launches. The FLOPs are those of the conv
and matmul operators of one step of the plain path at the same shapes,
counted by ``torch.utils.flop_counter`` on meta tensors: the Hopper kernels
are invisible to the counter, and the arithmetic is the same. The JAX bench
counts its XLA-backend step the same way (``analytic_matmul_cost``). With
``remat_rollout`` the count includes the generator forward that the backward
recomputes (``analytic_flops_count_remat_recompute`` in the line). The
engine knobs (``wgrad``, ``deconv``, ``conv0``) compute the same function, so
the count is the default engines' under every value: the subpixel rewrite's
extra border row and column of its inner conv are not work the function
needs, and the im2col weight gradient has the wgrad conv's arithmetic.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from action_conditioned_gans_tpu_torch.config import Config, resolve_device
from action_conditioned_gans_tpu_torch.data import make_dataset
from action_conditioned_gans_tpu_torch.parallel.dp import make_dp_train_step
from action_conditioned_gans_tpu_torch.parallel.mesh import make_mesh
from action_conditioned_gans_tpu_torch.parallel.tp import place_state
from action_conditioned_gans_tpu_torch.train.loop import sync_device
from action_conditioned_gans_tpu_torch.train.state import init_state, state_from_params
from action_conditioned_gans_tpu_torch.train.step import make_train_step

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)


class _GlobalOnly:
    """FlopCounterMode's module tracker, reduced to the one "Global" total:
    the tracker's backward hooks do not support ``torch.autograd.grad``,
    which the step differentiates with."""

    parents = {"Global"}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def step_flop_counts(cfg: Config) -> Dict[str, int]:
    """FLOPs of one fused G+D step of ``cfg`` (forward and backward) by
    operator (``aten.convolution``, ``aten.convolution_backward``,
    ``aten.mm``, ...), counted on meta tensors: no memory, no compute. The
    same number under every engine knob: the step is counted with the
    default engines."""
    return counted_step_flops(cfg.replace(model=dataclasses.replace(
        cfg.model, wgrad="xla", deconv="xla", conv0="xla")))


def counted_step_flops(cfg: Config) -> Dict[str, int]:
    """The operators' FLOPs of one step of ``cfg`` as it runs, its engines
    included, on meta tensors."""
    from action_conditioned_gans_tpu_torch.models import Discriminator, Generator

    m, t = cfg.model, cfg.train
    meta = torch.device("meta")
    with meta:
        gen, disc = Generator(m), Discriminator(m)
    state = state_from_params(cfg, gen.state_dict(), disc.state_dict(), device=meta)
    b, horizon, size = t.batch_size, max(t.rollout_length, 1), m.image_size
    batch = {"frames": torch.zeros((b, horizon + 1, size, size, m.image_channels), device=meta),
             "actions": torch.zeros((b, horizon, m.action_dim), device=meta)}
    if m.state_dim:
        batch["states"] = torch.zeros((b, horizon, m.state_dim), device=meta)
    counter = FlopCounterMode(display=False)
    counter.mod_tracker = _GlobalOnly()
    with counter:
        make_train_step(cfg, device=meta)(state, batch)
    return {str(op): n for op, n in counter.get_flop_counts()["Global"].items()}


def run_bench(cfg: Config, steps: int = 30, warmup: int = 5, device=None) -> Dict[str, object]:
    """Benchmark ``cfg``'s training step on ``device`` (cuda unless another
    device is given). ``warmup`` calls, one more window, then three timed
    windows of ``max(steps // 3, 2)`` calls of ``steps_per_call`` steps.
    Under a process group every rank runs the data-parallel step on its
    share of the batch (``parallel/``), on its channel shard of the state
    with a model axis; the line counts the global batch's frames per device
    (``num_chips`` is the group's size)."""
    mesh = make_mesh(cfg.mesh, device=device)
    dev = mesh.device
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    spc = max(cfg.train.steps_per_call, 1)
    state = place_state(init_state(cfg, torch.Generator().manual_seed(cfg.train.seed),
                                   device=dev), mesh)
    step_fn = make_dp_train_step(cfg, mesh)
    dataset = make_dataset(cfg, stack=spc, device=dev, host_id=mesh.data_index,
                           num_hosts=mesh.data)

    batch = dataset.batch_at(0)
    sync_device(dev)
    t0 = time.perf_counter()
    state, metrics = step_fn(state, batch)
    float(metrics["d_loss"])
    sync_device(dev)
    first_step_s = time.perf_counter() - t0

    for i in range(1, warmup):
        state, metrics = step_fn(state, dataset.batch_at(i))
    k = min(4, steps)
    cached = [dataset.batch_at(warmup + i) for i in range(k)]
    sync_device(dev)

    def window(n_calls: int) -> float:
        """Seconds per step over ``n_calls`` calls, ending in a metric read."""
        nonlocal state
        t0 = time.perf_counter()
        m = None
        for i in range(n_calls):
            state, m = step_fn(state, cached[i % k])
        float(m["d_loss"])
        sync_device(dev)
        return (time.perf_counter() - t0) / (n_calls * spc)

    window(max(2, steps // 4))
    lat = np.array([window(max(steps // 3, 2)) for _ in range(3)])
    p50 = float(np.percentile(lat, 50))
    frames_per_step = cfg.train.batch_size * max(cfg.train.rollout_length, 1)
    per_step = sum(step_flop_counts(cfg).values())
    achieved = per_step / p50
    return {
        "config": cfg.name,
        "image_size": cfg.model.image_size,
        "batch_size": cfg.train.batch_size,
        "rollout_length": cfg.train.rollout_length,
        "steps_per_call": spc,
        "num_chips": mesh.world,
        "p50_step_latency_ms": p50 * 1e3,
        "p90_step_latency_ms": float(np.percentile(lat, 90)) * 1e3,
        "frames_per_sec_per_chip": frames_per_step / p50 / mesh.world,
        "first_step_s": first_step_s,
        "device": _device_name(dev),
        "step_tflops_analytic": per_step / 1e12,
        "achieved_tflops_per_chip_analytic": achieved / mesh.world / 1e12,
        "roofline_utilization_analytic": achieved / mesh.world / PEAK_BF16_FLOPS,
        "analytic_flops_count_remat_recompute": bool(cfg.train.remat_rollout),
        "peak_memory_gb": _peak_memory_gb(dev),
    }


def _device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)


def _peak_memory_gb(dev: torch.device):
    """The most memory the run held on the card (None on the CPU)."""
    return torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda" else None


def _header(cfg: Config, batch: int, horizon: int, dev: torch.device) -> Dict[str, object]:
    """The keys that open a serving line."""
    return {"config": cfg.name, "image_size": cfg.model.image_size, "batch_size": batch,
            "rollout_length": horizon, "device": _device_name(dev)}


def _round_trip_s(dev: torch.device) -> float:
    """The least of five empty round trips: a scalar add on ``dev``, its host
    read and a synchronize, the barrier every infer window ends in."""
    zero = torch.zeros((), device=dev)

    def once() -> float:
        t0 = time.perf_counter()
        float(zero + 1.0)
        sync_device(dev)
        return time.perf_counter() - t0

    once()
    return min(once() for _ in range(5))


def run_infer_bench(cfg: Config, batch=None, rollout=None, k: int = 32, windows: int = 3,
                    calls_per_window: int = 8, device=None) -> Dict[str, object]:
    """The generator alone (no discriminator, no optimizer) on ``device``
    (cuda unless another is given), seeded weights, in inference mode.

    ``infer_*``: one timed call is ``k`` generator applications over a bank
    of ``k`` distinct inputs made on the device (``tanh(normal)`` frames,
    normal actions and states), so no two applications share an input,
    summing each output's float32 mean. ``rollout_*``: ``infer.rollout_scan``
    over ``rollout`` steps (default ``max(train.rollout_length, 1)``),
    reduced to one scalar. One warm call, one warm window, then the p50 of
    ``windows`` windows of ``calls_per_window`` calls; each window ends in a
    host read of the last scalar and a synchronize, and its host-clock time
    less one measured empty round trip (``barrier_round_trip_ms``), at least
    half of it, counts."""
    from action_conditioned_gans_tpu_torch.infer import rollout_scan
    from action_conditioned_gans_tpu_torch.models import Generator

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    m = cfg.model
    b, t = batch or cfg.train.batch_size, rollout or max(cfg.train.rollout_length, 1)
    gen = Generator(m, generator=torch.Generator().manual_seed(cfg.train.seed))
    gen = gen.to(dev).eval().requires_grad_(False)
    draws = torch.Generator(dev).manual_seed(cfg.train.seed + 1)

    def normal(*shape):
        return torch.randn(shape, generator=draws, device=dev)

    size = (m.image_size, m.image_size, m.image_channels)
    frames, actions = torch.tanh(normal(k, b, *size)), normal(k, b, m.action_dim)
    states = normal(k, b, m.state_dim) if m.state_dim else None
    frame0, roll_actions = torch.tanh(normal(b, *size)), normal(b, t, m.action_dim)
    roll_states = normal(b, t, m.state_dim) if m.state_dim else None

    def bank() -> torch.Tensor:
        acc = torch.zeros((), device=dev)
        for i in range(k):
            y = gen(frames[i], actions[i], None if states is None else states[i])
            acc = acc + y.float().mean()
        return acc

    def roll() -> torch.Tensor:
        clip = rollout_scan(gen, frame0, roll_actions, roll_states)
        return clip.float().mean(dim=(0, 2, 3, 4)).sum()

    rt = None

    def timeit(fn) -> float:
        """Seconds per call: the p50 window, as the docstring says."""
        nonlocal rt
        float(fn())
        sync_device(dev)
        if rt is None:
            rt = _round_trip_s(dev)

        def window() -> float:
            t0 = time.perf_counter()
            for _ in range(calls_per_window):
                r = fn()
            float(r)
            sync_device(dev)
            el = time.perf_counter() - t0
            return max(el - rt, el * 0.5) / calls_per_window

        window()
        return float(np.percentile([window() for _ in range(windows)], 50))

    with torch.inference_mode():
        per_call, per_roll = timeit(bank), timeit(roll)
    return {
        **_header(cfg, b, t, dev),
        "infer_step_latency_ms": per_call / k * 1e3,
        "infer_fps_per_chip": b * k / per_call,
        "rollout_latency_ms": per_roll * 1e3,
        "rollout_fps_per_chip": b * t / per_roll,
        "barrier_round_trip_ms": rt * 1e3,
        "peak_memory_gb": _peak_memory_gb(dev),
    }


def run_serving_bench(cfg: Config, batch=None, rollout=None, windows: int = 3,
                      calls_per_window: int = 4, device=None) -> Dict[str, object]:
    """A whole rollout request on ``device`` (cuda unless another is given):
    numpy inputs on the host, placed on the device by each call, and the
    predicted frames fetched whole to numpy (``serve.to_host``, the
    barrier). The live ``Predictor.rollout`` against ``AotPredictor.rollout``
    on an artifact that ``aot.export_aot`` writes into a temporary directory
    (``artifact_bytes``), both over the same seeded weights: one warm call
    and one warm window each, then ``windows`` windows of
    ``calls_per_window`` calls each, the two taking turns (live first in
    even windows, AOT in odd ones, so that a drift of the host falls on
    both), and each one's p50 window. ``aot_overhead_pct`` is the AOT
    program's time over the live path's, less one, in percent."""
    import os
    import tempfile

    from action_conditioned_gans_tpu_torch.aot import AotPredictor, export_aot
    from action_conditioned_gans_tpu_torch.infer import Predictor
    from action_conditioned_gans_tpu_torch.models import Generator
    from action_conditioned_gans_tpu_torch.serve import to_host

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    m = cfg.model
    b, t = batch or cfg.train.batch_size, rollout or max(cfg.train.rollout_length, 1)
    rng = np.random.default_rng(cfg.train.seed)
    frame0 = np.tanh(rng.standard_normal((b, m.image_size, m.image_size, m.image_channels)))
    frame0 = frame0.astype(np.float32)
    actions = rng.standard_normal((b, t, m.action_dim)).astype(np.float32)
    states = (rng.standard_normal((b, t, m.state_dim)).astype(np.float32) if m.state_dim
              else None)
    params = Generator(m, generator=torch.Generator().manual_seed(cfg.train.seed)).state_dict()

    def request(predictor) -> None:
        to_host(predictor.rollout(frame0, actions, states))

    def window(predictor) -> float:
        """Seconds per request over one window."""
        t0 = time.perf_counter()
        for _ in range(calls_per_window):
            request(predictor)
        return (time.perf_counter() - t0) / calls_per_window

    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "gen.aot")
        meta = export_aot(cfg, params, path, rollout_length=t, device=dev)
        served = {"live": Predictor(cfg, params, device=dev),
                  "aot": AotPredictor(path, device=dev)}
        for predictor in served.values():
            request(predictor)
            window(predictor)
        times = {name: [] for name in served}
        for i in range(windows):
            for name in ("live", "aot") if i % 2 == 0 else ("aot", "live"):
                times[name].append(window(served[name]))
    live_s, aot_s = (float(np.percentile(times[name], 50)) for name in ("live", "aot"))
    return {
        **_header(cfg, b, t, dev),
        "serving_live_ms": live_s * 1e3,
        "serving_live_fps": b * t / live_s,
        "artifact_bytes": meta["bytes"],
        "serving_aot_ms": aot_s * 1e3,
        "serving_aot_fps": b * t / aot_s,
        "aot_overhead_pct": (aot_s / live_s - 1.0) * 100.0,
        "peak_memory_gb": _peak_memory_gb(dev),
    }
