"""Time serving of the port on one GPU, for one or more checkouts.

    python action_conditioned_gans_tpu_torch/time_serving.py [CHECKOUT ...] [--preset P] [--rounds N]

Each run is chip_smoke.py's serving phase for one preset: seeded bfloat16
weights, ``Predictor.predict`` and ``Predictor.rollout`` with inputs already
on the card, timed with CUDA events over windows that end in a synchronize.
config1 (the default): predict at B=128, rollout at T=10, B=16; config5
(256x256 frames, seven GroupNorm layers on the standalone kernel): predict at
B=32, rollout at T=30, B=8. A checkout is the root of a tree that holds
``action_conditioned_gans_tpu_torch`` (default: the one this file is in).
Every run is a process of its own that imports the package from its
checkout; with two checkouts A and B each round runs A B B A, so a drift in
the card's clock or the host's load falls on both. One JSON line per run,
then a ``summary`` line with each checkout's median, lowest and highest
window of each metric, and whether every run of every checkout returned the
same predict output, bit for bit (the SHA-256 of its bytes).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _window_ms(fn, iters: int) -> float:
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# preset: (image size, predict batch, rollout horizon, rollout batch)
GEOMETRY = {"config1": (64, 128, 10, 16), "config5": (256, 32, 30, 8)}


def worker(checkout: str, windows: int, preset: str) -> dict:
    """One run, with the package imported from ``checkout``."""
    sys.path[0] = os.path.abspath(checkout)
    import numpy as np
    import torch

    from action_conditioned_gans_tpu_torch.config import get_preset
    from action_conditioned_gans_tpu_torch.convert import state_dict_to_flax
    from action_conditioned_gans_tpu_torch.infer import Predictor
    from action_conditioned_gans_tpu_torch.models import Generator
    from action_conditioned_gans_tpu_torch.ops.kernels import build

    build.build_all()
    size, batch, horizon, roll_batch = GEOMETRY[preset]
    cfg = get_preset(preset)
    gen = Generator(cfg.model, generator=torch.Generator().manual_seed(0))
    predictor = Predictor(cfg, state_dict_to_flax(gen.state_dict()), device="cuda")
    rng = np.random.default_rng(0)
    frame = torch.from_numpy(np.tanh(rng.standard_normal((batch, size, size, 3))).astype(np.float32)).cuda()
    action = torch.from_numpy(rng.standard_normal((batch, 4)).astype(np.float32)).cuda()
    actions = torch.from_numpy(rng.standard_normal((roll_batch, horizon, 4)).astype(np.float32)).cuda()
    predict = lambda: predictor.predict(frame, action)  # noqa: E731
    rollout = lambda: predictor.rollout(frame[:roll_batch], actions)  # noqa: E731
    for _ in range(5):
        predict()
        rollout()
    out = predict().float().cpu().numpy()
    return {
        "checkout": os.path.abspath(checkout),
        "preset": preset,
        "predict_sha256": hashlib.sha256(out.tobytes()).hexdigest(),
        f"predict_b{batch}_ms": [_window_ms(predict, 20) for _ in range(windows)],
        f"rollout_t{horizon}_b{roll_batch}_ms": [_window_ms(rollout, 5) for _ in range(windows)],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkouts", nargs="*", default=[HERE])
    ap.add_argument("--preset", choices=sorted(GEOMETRY), default="config1")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--windows", type=int, default=5, help="timed windows per run")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.checkouts[0], args.windows, args.preset)), flush=True)
        return 0
    order = []
    for _ in range(args.rounds):
        order += args.checkouts + args.checkouts[::-1]
    runs = {c: [] for c in args.checkouts}
    for c in order:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", "--windows", str(args.windows),
             "--preset", args.preset, c],
            capture_output=True, text=True, timeout=600,
        )
        if out.returncode:
            sys.stderr.write(out.stderr)
            raise SystemExit(f"time_serving: the run of {c} failed with exit code {out.returncode}")
        run = json.loads(out.stdout.strip().splitlines()[-1])
        print(json.dumps(run), flush=True)
        runs[c].append(run)
    metrics = [k for k in runs[args.checkouts[0]][0] if k.endswith("_ms")]
    summary = {"preset": args.preset}
    for c, rs in runs.items():
        summary[c] = {}
        for key in metrics:
            v = [w for r in rs for w in r[key]]
            summary[c][key] = dict(median=statistics.median(v), min=min(v), max=max(v))
    summary["same_predict_bits"] = len({r["predict_sha256"] for rs in runs.values() for r in rs}) == 1
    print("summary " + json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
