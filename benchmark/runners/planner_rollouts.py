"""One closed-loop planner client: each request is
``infer.Predictor.rollout`` over a numpy ``frame0`` and ``actions`` from a
bank of distinct requests, then each candidate's mean squared distance to
the request's goal frame on the device, read back to the host; the next
request goes once the costs are there. The frames of a sample of requests
drawn from the seed, and of the window's last, are kept for the reference,
which predicts each step from the frame the program fed back.
"""

from __future__ import annotations

import math
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark import flops, inputs
from benchmark.runners import Context, Run, free, memory_peak, sync, traced, weights


def run(ctx: Context) -> Run:
    from torch.profiler import record_function

    from action_conditioned_gans_tpu_torch.config import config_from_dict
    from action_conditioned_gans_tpu_torch.infer import Predictor

    dev, tr = ctx.device, ctx.traffic
    cfg = config_from_dict(ctx.cfg)
    b, horizon = tr["candidates"], tr["horizon"]
    ctx.phase("set-up: the program's modules imported")
    g_w = weights(ctx, cfg, "g")
    predictor = Predictor(cfg, {k: v.cpu() for k, v in g_w.items()}, device=dev)
    bank = inputs.requests(ctx.cfg, tr["bank_requests"], b, horizon, ctx.seed, dev)
    ctx.phase("set-up: inputs, weights and predictor built")
    rng = np.random.default_rng(inputs.sub_seed(ctx.seed, "sample"))
    sample = set(rng.choice(tr["check_from_first"], tr["check_requests"], replace=False).tolist())

    def request(i: int, spans=None):
        """One request; its frames and whether its costs are finite. The
        spans are named for a trace too (a span costs about a microsecond
        when no profiler runs)."""
        r = bank[i % len(bank)]
        t0 = time.perf_counter()
        with record_function("bench:request"):
            with record_function("bench:rollout"):
                frames = predictor.rollout(r["frame0"], r["actions"])
            t1 = time.perf_counter()
            with record_function("bench:cost"):
                cost = (frames.float() - r["goal"]).square().mean(dim=(1, 2, 3, 4)).cpu()
        t2 = time.perf_counter()
        if spans is not None:
            spans["rollout"].append(t1 - t0)
            spans["request"].append(t2 - t0)
        return frames, bool(torch.isfinite(cost).all())

    for i in range(tr["warm_requests"]):
        request(i)
    sync(dev)
    ctx.phase("set-up: warm requests")
    setup_s = time.perf_counter() - ctx.started

    spans: Dict[str, List[float]] = {"rollout": [], "request": []}
    kept, failed, i = {}, 0, 0
    start = time.perf_counter()
    deadline = start + ctx.seconds
    while True:
        frames, ok = request(i, spans)
        failed += not ok
        if i in sample:
            kept[i] = frames
        last = (i, frames)
        i += 1
        if time.perf_counter() >= deadline:
            break
    window_s = time.perf_counter() - start
    kept[last[0]] = last[1]
    del frames, last

    run = Run(kind="planner_rollouts", setup_s=setup_s, window_s=window_s, units=i,
              attempted=i, failed=failed, frames_per_unit=b * horizon,
              flops_per_unit=float(flops.generator_forward_flops(ctx.cfg["model"], b) * horizon),
              end_to_end={}, spans=spans, memory_peak_bytes=0, readings={})
    run.end_to_end["serve_frames_per_s"] = run.frames_per_unit * i / window_s
    run.end_to_end["serve_p95_ms"] = float(np.percentile(spans["request"], 95)) * 1e3
    q = np.percentile(np.array(spans["request"]) * 1e3, [5, 25, 50, 75, 95, 100])
    run.notes.append("request ms p5/p25/p50/p75/p95/max: " + " ".join(f"{v:.3f}" for v in q))

    if ctx.trace:
        def issue() -> int:
            nonlocal failed
            failed += not request(0)[1]
            run.attempted += 1
            return 1

        traced(ctx, run, issue, tr["trace_min_requests"], tr["trace_seconds"])
        run.failed = failed
    run.memory_peak_bytes = memory_peak(dev)
    del predictor
    free(dev)
    ctx.phase("the window closed, the program's state freed")

    worst = 0.0
    for j, frames in sorted(kept.items()):
        r = bank[j % len(bank)]
        gaps = ctx.reference.rollout_gaps(
            ctx.cfg["model"], g_w, torch.from_numpy(r["frame0"]).to(dev),
            torch.from_numpy(r["actions"]).to(dev), frames)
        worst = max(worst, float(gaps.max()) if torch.isfinite(gaps).all() else math.inf)
    run.readings = {"frame_gap": worst}
    run.notes.append(f"checked requests {sorted(kept)} of {i}")
    ctx.phase("the check")
    return run
