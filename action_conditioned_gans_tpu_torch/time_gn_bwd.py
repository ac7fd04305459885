"""Time kernel 4 (the GroupNorm + activation backward) of one or more checkouts on one GPU.

    python action_conditioned_gans_tpu_torch/time_gn_bwd.py [CHECKOUT ...] [--rounds N]

The calls are those of one training step, as ``chip_smoke.py`` runs them:
the config1 step at B=128 (bench.py's geometry: G at 128, D at 256 in its
update and 128 in the G head; 11 calls) and the config3 step at its B=32 (G
at 32, D at 64 and 32; 25 calls), in bfloat16, each GroupNorm layer with its
activation, a fused layer's y in float32 and a split layer's in bfloat16.
The shapes come from the models of this checkout run on the meta device.
Each call is timed on seeded inputs as device time: 20 calls captured in a
CUDA graph and replayed. A checkout is the root of a tree that holds
``action_conditioned_gans_tpu_torch`` (default: the one this file is in);
every run is a process of its own that imports the package from its
checkout, and with two checkouts A and B each round runs A B B A. One JSON
line per run, then a ``summary`` line with each checkout's median per-step
sum over its runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# preset: the step's batch (None: the preset's own)
STEPS = {"config1": 128, "config3": None}


def step_calls(preset: str, batch=None) -> list:
    """(shape, groups, act, leak, y dtype) of every kernel-4 call of one
    bfloat16 training step of ``preset`` at ``batch`` (default: its own), in
    the order G, D update (2B), G head (B)."""
    import torch

    from action_conditioned_gans_tpu_torch.config import get_preset
    from action_conditioned_gans_tpu_torch.models import Discriminator, Generator
    from action_conditioned_gans_tpu_torch.ops import envelope

    cfg = get_preset(preset)
    b = batch or cfg.train.batch_size
    m = dataclasses.replace(cfg.model, compute_dtype="bfloat16")
    with torch.device("meta"):
        models = {"G": Generator(m), "D": Discriminator(m)}
    s = m.image_size
    frame = torch.empty(1, s, s, m.image_channels, device="meta")
    action = torch.empty(1, m.action_dim, device="meta")
    seen = {"G": [], "D": []}
    for prefix, model in models.items():
        hooks = [block.register_forward_hook(
            lambda mod, args, out, p=prefix: seen[p].append((mod, tuple(args[0].shape), out.shape)))
            for block in model.children()]
        with torch.no_grad():
            model(frame, action, None) if prefix == "G" else model(frame, frame, action, None)
        for hk in hooks:
            hk.remove()
    calls = []
    for prefix, n in (("G", b), ("D", 2 * b), ("D", b)):
        for block, x, y in seen[prefix]:
            if block.norm != "group":
                continue
            split = envelope.route(x, tuple(block.kernel.shape), block.stride, block.transpose,
                                   block.norm, block.groups, torch.bfloat16) == "split"
            calls.append(((n, *y[1:]), block.groups, block.act, block.leak,
                          "bfloat16" if split else "float32"))
    return calls


def worker(checkout: str, calls: dict) -> dict:
    """One run, with the package imported from ``checkout``: ms per call."""
    sys.path[0] = os.path.abspath(checkout)
    import torch

    from action_conditioned_gans_tpu_torch.ops import reference
    from action_conditioned_gans_tpu_torch.ops.common import resolve_groups
    from action_conditioned_gans_tpu_torch.ops.kernels import build, gn_bwd

    build.build_all(["gn_act_bwd"])
    out = {"checkout": checkout, "device": torch.cuda.get_device_name(0)}
    for preset, rows in calls.items():
        times = []
        for i, (shape, groups, act, leak, y_dtype) in enumerate(rows):
            gen = torch.Generator(device="cuda").manual_seed(500 + i)
            c = shape[-1]
            gr = resolve_groups(c, groups)
            y = (1.5 * torch.randn(shape, generator=gen, device="cuda") + 0.3).to(getattr(torch, y_dtype))
            scale = 1 + 0.2 * torch.randn(c, generator=gen, device="cuda")
            bias = 0.1 * torch.randn(c, generator=gen, device="cuda")
            o = reference.norm_act(y.float(), scale, bias, groups=groups, act=act).to(torch.bfloat16)
            g = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
            yg = y.double().reshape(shape[0], -1, gr, c // gr)
            mean = yg.mean(dim=(1, 3)).float().contiguous()
            rstd = torch.rsqrt(yg.var(dim=(1, 3), unbiased=False) + 1e-5).float().contiguous()
            kw = dict(groups=groups, act=act, leak=leak)
            times.append(_device_time_ms(lambda: gn_bwd.gn_act_bwd(y, scale, o, g, mean, rstd, **kw)))
        out[preset] = {"calls_ms": times, "step_ms": sum(times)}
    return out


def _device_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("checkouts", nargs="*", default=[HERE])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--calls", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker, json.loads(args.calls))), flush=True)
        return 0
    sys.path.insert(0, HERE)
    calls = {p: step_calls(p, b) for p, b in STEPS.items()}
    order = args.checkouts if len(args.checkouts) == 1 else [*args.checkouts, *args.checkouts[::-1]]
    runs = {c: [] for c in args.checkouts}
    for _ in range(args.rounds):
        for checkout in order:
            res = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", checkout,
                                  "--calls", json.dumps(calls)], capture_output=True, text=True,
                                 check=True, timeout=600)
            row = json.loads(res.stdout.strip().splitlines()[-1])
            print("run " + json.dumps(row), flush=True)
            runs[checkout].append(row)
    summary = {c: {p: {"median_step_ms": statistics.median(r[p]["step_ms"] for r in rs),
                       "calls": len(calls[p]),
                       "median_calls_ms": [statistics.median(r[p]["calls_ms"][i] for r in rs)
                                           for i in range(len(calls[p]))]}
                   for p in calls} for c, rs in runs.items()}
    print("summary " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
