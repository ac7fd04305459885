"""CLI: ``python -m action_conditioned_gans_tpu_torch configs|serve|train|bench``.

``serve --artifact g.npz`` serves a generator exported by the JAX package's
``export`` (or the port's ``infer.export_generator``). ``train`` trains a
preset on synthetic clips made on the device, with JSON metric lines,
checkpoints under ``--workdir`` and resume; ``bench`` prints one JSON line
for the preset's training step. Each runs on the GPU, or on the CPU with
``--device cpu``. The JAX package's ``sample``, ``eval``, ``export``,
``make-data``, ``profile-report`` and ``doctor`` are not ported yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import List

from action_conditioned_gans_tpu_torch.config import PRESETS, Config, get_preset


def _coerce(old, raw: str):
    if isinstance(old, bool):
        return raw.lower() in ("1", "true", "yes")
    if isinstance(old, int):
        return int(raw)
    if isinstance(old, float):
        return float(raw)
    return raw


def apply_overrides(cfg: Config, overrides: List[str]) -> Config:
    """--set model.compute_dtype=float32 ..."""
    for ov in overrides:
        key, _, raw = ov.partition("=")
        if not raw:
            raise ValueError(f"override {ov!r} must be section.field=value")
        parts = key.split(".")
        if len(parts) != 2:
            raise ValueError(f"override key {key!r} must be section.field")
        section, field = parts
        sub = getattr(cfg, section)
        new_sub = dataclasses.replace(sub, **{field: _coerce(getattr(sub, field), raw)})
        cfg = dataclasses.replace(cfg, **{section: new_sub})
    return cfg


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="acgan-torch", description=__doc__)
    p.add_argument("command", choices=["configs", "serve", "train", "bench"])
    p.add_argument("--preset", default="config1", help="preset name")
    p.add_argument("--workdir", default=None, help="train: checkpoints, TensorBoard, profile")
    p.add_argument("--steps", type=int, default=None,
                   help="train: total steps; bench: steps behind the timed windows")
    p.add_argument("--no-resume", action="store_true", help="train: ignore checkpoints")
    p.add_argument("--profile-steps", type=int, default=0,
                   help="train: a torch.profiler trace of N steps into <workdir>/profile")
    p.add_argument(
        "--set", dest="overrides", action="append", default=[], metavar="SEC.FIELD=VAL",
        help="config override, repeatable",
    )
    p.add_argument("--artifact", default=None, help="serve: a generator .npz archive")
    p.add_argument("--device", default=None, help="torch device (default cuda)")
    p.add_argument("--host", default="127.0.0.1", help="serve: bind address")
    p.add_argument("--port", type=int, default=8700, help="serve: TCP port (0 = any free)")
    return p


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command == "configs":
        for name, c in PRESETS.items():
            print(
                f"{name}: {c.model.image_size}px T={c.train.rollout_length} "
                f"batch={c.train.batch_size} state_dim={c.model.state_dim} "
                f"ss={c.train.scheduled_sampling}"
            )
        return 0
    cfg = get_preset(args.preset)
    if args.workdir:
        cfg = dataclasses.replace(cfg, workdir=args.workdir)
    cfg = apply_overrides(cfg, args.overrides)
    if args.command == "train":
        from action_conditioned_gans_tpu_torch.train.loop import train

        train(cfg, max_steps=args.steps, resume=not args.no_resume,
              profile_steps=args.profile_steps, device=args.device)
        return 0
    if args.command == "bench":
        from action_conditioned_gans_tpu_torch.bench import run_bench

        print(json.dumps(run_bench(cfg, steps=args.steps or 30, device=args.device)), flush=True)
        return 0
    if not args.artifact:
        parser.error("serve needs --artifact <file>.npz")
    from action_conditioned_gans_tpu_torch.serve import build_predictor, serve_forever

    serve_forever(build_predictor(args, cfg), args.host, args.port)
    return 0


if __name__ == "__main__":
    sys.exit(main())
