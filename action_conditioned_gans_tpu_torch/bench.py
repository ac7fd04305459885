"""Training-step benchmark (port of the JAX package's ``bench.run_bench``).

    python -m action_conditioned_gans_tpu_torch bench --preset config1 \
        --set train.batch_size=128 --set train.adam_moment_dtype=bfloat16

One JSON line: the p50 / p90 per-step latency of ``make_multi_train_step``
over three timed windows on stacked synthetic batches made on the device,
frames per second, the time to the first finished step (kernel build and
load included; it stands in for the JAX package's ``compile_s``), the
analytic FLOPs of one step against the H100's dense bf16 peak, and the peak
memory the run allocated on the card.

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

from action_conditioned_gans_tpu_torch.config import Config
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
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        "step_tflops_analytic": per_step / 1e12,
        "achieved_tflops_per_chip_analytic": achieved / mesh.world / 1e12,
        "roofline_utilization_analytic": achieved / mesh.world / PEAK_BF16_FLOPS,
        "analytic_flops_count_remat_recompute": bool(cfg.train.remat_rollout),
        # The most memory the run held on the card (None on the CPU).
        "peak_memory_gb": (torch.cuda.max_memory_allocated(dev) / 1e9
                           if dev.type == "cuda" else None),
    }
