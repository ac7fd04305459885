"""CLI: ``python -m action_conditioned_gans_tpu_torch
configs|serve|train|bench|export|sample|eval|make-data|doctor|profile-report``.

``train`` trains a preset on synthetic clips made on the device, or on
TFRecord clips (``--set data.source=tfrecord_native --set
data.data_dir=DIR``), with JSON metric lines, checkpoints under ``--workdir``
and resume; ``bench`` prints one JSON line for the preset's training step,
or with ``--mode infer`` / ``--mode serving`` for its generator alone or a
whole rollout request (live against the AOT program; ``bench.py``).
``make-data`` writes seeded synthetic clips as BAIR-schema TFRecords.
``export`` writes what a checkpoint holds as a generator ``.npz`` archive or,
with ``--format pt2``, as an AOT artifact (``aot.py``); ``sample`` writes
rollout PNGs and GIFs and prints their metrics, ``eval`` prints held-out
metrics. ``serve`` answers HTTP requests from an ``.npz`` archive (the
port's or the JAX package's ``export``), an AOT artifact, or
``--workdir``'s latest checkpoint. ``doctor`` checks the device, compilers,
builds, data and checkpoints (exit 1 if one fails); ``profile-report``
summarises a ``train --profile-steps`` trace. Each runs on the GPU, or on
the CPU with ``--device cpu``.

``--multihost`` makes the process one rank of a data-parallel run started
by ``torchrun`` (one process per device):

    torchrun --nproc-per-node N -m action_conditioned_gans_tpu_torch --multihost train ...

With ``--set mesh.model=M`` the N ranks form a ``(N / M, M)`` mesh: each
group of M consecutive ranks shares its rows and splits the conv channels
(``parallel/tp.py``), and the groups run data-parallel.

It initialises the process group from torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT``): NCCL on
``cuda:LOCAL_RANK`` (or ``--device``), gloo with ``--device cpu``; the group
is destroyed on exit. ``train`` and ``bench`` then run data-parallel (dp x
tp with a model axis).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import datetime
import json
import os
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


def _rollout_lengths(raw: str) -> List[int]:
    """--rollout-length value: 'T' or 'T1,T2,...' -> list of horizons."""
    try:
        out = [int(x) for x in raw.split(",") if x.strip()]
    except ValueError:
        raise argparse.ArgumentTypeError(f"{raw!r} is not an int or comma-list of ints")
    if any(t < 0 for t in out):
        raise argparse.ArgumentTypeError(f"negative horizon in {raw!r}")
    return [t for t in out if t > 0]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="acgan-torch", description=__doc__)
    p.add_argument("command",
                   choices=["configs", "serve", "train", "bench", "export", "sample", "eval",
                            "make-data", "doctor", "profile-report"])
    p.add_argument("--preset", default="config1", help="preset name")
    p.add_argument("--workdir", default=None,
                   help="train: checkpoints, TensorBoard, profile; serve / export / sample / "
                   "eval: the checkpoints to read")
    p.add_argument("--steps", type=int, default=None,
                   help="train: total steps; bench: steps behind the timed windows")
    p.add_argument("--mode", choices=["train", "infer", "serving"], default="train",
                   help="bench: the training step (default); the generator alone over an "
                   "input bank and a rollout (infer); a whole rollout request, live against "
                   "the AOT program (serving). The batch is train.batch_size, T the one "
                   "--rollout-length or max(train.rollout_length, 1)")
    p.add_argument("--bank", type=int, default=32, metavar="K",
                   help="bench --mode infer: generator applications a timed call, each on "
                   "its own input")
    p.add_argument("--no-resume", action="store_true", help="train: ignore checkpoints")
    p.add_argument("--profile-steps", type=int, default=0,
                   help="train: a torch.profiler trace of N steps into <workdir>/profile")
    p.add_argument(
        "--set", dest="overrides", action="append", default=[], metavar="SEC.FIELD=VAL",
        help="config override, repeatable",
    )
    p.add_argument("--out", default=None,
                   help="export: the artifact's path; sample: the image directory; make-data: "
                   "the TFRecord file (default <workdir>/data/clips.tfrecord); profile-report: "
                   "the trace file or directory to read (default <workdir>/profile)")
    p.add_argument("--num-clips", type=int, default=8,
                   help="sample: held-out clips rolled out; make-data: clips written")
    p.add_argument("--ema", action="store_true",
                   help="serve / export / sample / eval with the EMA generator weights (needs a "
                   "checkpoint trained with train.ema_decay > 0)")
    p.add_argument("--format", choices=["npz", "pt2", "stablehlo"], default="npz",
                   help="export: 'npz' = weights + config archive (Predictor.from_npz); 'pt2' = "
                   "the AOT program through torch.export (aot.AotPredictor)")
    p.add_argument("--rollout-length", type=_rollout_lengths, default=[], metavar="T[,T...]",
                   help="export --format pt2: also export T-step rollout programs, one per "
                   "horizon; bench --mode infer / serving: the rollout's T")
    p.add_argument("--artifact", default=None,
                   help="serve: a generator .npz archive or an AOT artifact; omitted = restore "
                   "the latest checkpoint from --workdir")
    p.add_argument("--device", default=None,
                   help="torch device (default cuda); doctor: the probe's target")
    p.add_argument("--top", type=int, default=30, help="profile-report: rows to print")
    p.add_argument("--json", default=None,
                   help="profile-report: also write the whole summary as JSON to this path")
    p.add_argument("--probe-timeout", type=int, default=120,
                   help="doctor: seconds before the device probe is declared hung")
    p.add_argument("--host", default="127.0.0.1", help="serve: bind address")
    p.add_argument("--port", type=int, default=8700, help="serve: TCP port (0 = any free)")
    p.add_argument("--multihost", action="store_true",
                   help="one rank of a data-parallel run under torchrun: the process group "
                   "from RANK / WORLD_SIZE / LOCAL_RANK / MASTER_ADDR / MASTER_PORT (NCCL on "
                   "cuda:LOCAL_RANK, gloo with --device cpu)")
    return p


@contextlib.contextmanager
def process_group(args):
    """With ``--multihost``, this process as one rank of torchrun's group on
    its device (``args.device`` is set to it), destroyed on exit; without it,
    nothing. A CUDA rank on a machine without CUDA raises: no CPU fallback."""
    if not args.multihost:
        yield
        return
    import torch
    import torch.distributed as dist

    missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"--multihost needs torchrun's environment; {missing} unset "
                           "(torchrun --nproc-per-node N -m action_conditioned_gans_tpu_torch "
                           "--multihost ...)")
    dev = torch.device(args.device or f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--multihost on {dev}: no CUDA device is available; pass "
                               "--device cpu for a gloo group on the CPU")
        torch.cuda.set_device(dev)
    args.device = str(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo", init_method="env://",
                            rank=int(os.environ["RANK"]),
                            world_size=int(os.environ["WORLD_SIZE"]),
                            timeout=datetime.timedelta(minutes=30))
    try:
        yield
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    from action_conditioned_gans_tpu_torch.utils.compile_cache import maybe_enable_compile_cache

    maybe_enable_compile_cache()  # before any build
    if args.command == "profile-report":
        return _profile_report(parser, args)
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
    if args.command == "bench" and args.mode != "train":
        if args.multihost:
            parser.error(f"bench --mode {args.mode} runs on one device: drop --multihost")
        if len(args.rollout_length) > 1:
            parser.error(f"bench --mode {args.mode} takes one --rollout-length")
    with process_group(args):
        return _run(parser, args, cfg)


def _run(parser, args, cfg: Config) -> int:
    if args.command == "train":
        from action_conditioned_gans_tpu_torch.train.loop import train

        train(cfg, max_steps=args.steps, resume=not args.no_resume,
              profile_steps=args.profile_steps, device=args.device)
        return 0
    if args.command == "bench":
        from action_conditioned_gans_tpu_torch import bench

        horizon = args.rollout_length[0] if args.rollout_length else None
        if args.mode == "infer":
            line = bench.run_infer_bench(cfg, rollout=horizon, k=args.bank, device=args.device)
        elif args.mode == "serving":
            line = bench.run_serving_bench(cfg, rollout=horizon, device=args.device)
        else:
            line = bench.run_bench(cfg, steps=args.steps or 30, device=args.device)
        if not args.multihost or int(os.environ["RANK"]) == 0:
            print(json.dumps(line), flush=True)
        return 0
    if args.command == "make-data":
        return _make_data(args, cfg)
    if args.command == "doctor":
        # Every check in a process of its own, with a timeout.
        from action_conditioned_gans_tpu_torch.utils.doctor import run_doctor

        report = run_doctor(cfg, probe_timeout=args.probe_timeout, device=args.device)
        print(json.dumps(report, indent=1), flush=True)
        return 0 if report["ok"] else 1
    if args.command == "serve":
        # An explicit source: cfg.workdir has a default, and a server standing
        # up on whatever a past run left there is never what was meant.
        if not args.artifact and not args.workdir:
            parser.error("serve needs --artifact or an explicit --workdir")
        from action_conditioned_gans_tpu_torch.serve import build_predictor, serve_forever

        serve_forever(build_predictor(args, cfg), args.host, args.port)
        return 0
    return _from_checkpoint(parser, args, cfg)


def _profile_report(parser, args) -> int:
    """Summarise a ``train --profile-steps`` trace (``utils/trace_report``);
    exit 1 when it holds no device event (a CPU run's trace)."""
    from action_conditioned_gans_tpu_torch.utils.trace_report import (
        load_trace,
        print_summary,
        summarize,
    )

    path = args.out or (f"{args.workdir}/profile" if args.workdir else None)
    if not path:
        parser.error("profile-report needs --out <trace file or dir> or --workdir")
    try:
        trace = load_trace(path)
    except FileNotFoundError as e:
        parser.error(f"{e}; capture one with `train --profile-steps N --workdir <dir>`")
    summary = summarize(trace)
    if not summary.rows:
        print(f"no device kernel in {trace['source']}: capture the trace on the GPU "
              "(`train --profile-steps N`)", flush=True)
        return 1
    print_summary(summary, args.top)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(dataclasses.asdict(summary), steps=summary.steps), f, indent=1)
        print(f"[acgan] wrote {args.json}", flush=True)
    return 0


def _make_data(args, cfg: Config) -> int:
    """Seeded synthetic clips of the preset (``clip_len`` frames at
    ``image_size``) as BAIR-schema TFRecords, made on ``--device`` and
    written by the TF-free writer; actions and states are padded to
    ``clip_len`` with a row of zeros (the schema holds one set a frame)."""
    import numpy as np
    import torch

    from action_conditioned_gans_tpu_torch.config import resolve_device
    from action_conditioned_gans_tpu_torch.data.native_tfrecord import write_clips_tfrecord_native
    from action_conditioned_gans_tpu_torch.data.synthetic import draw_clip_randoms, render_clips

    out = args.out or f"{cfg.workdir}/data/clips.tfrecord"
    n, d, m = args.num_clips, cfg.data, cfg.model
    generator = torch.Generator(resolve_device(args.device)).manual_seed(cfg.train.seed)
    randoms = draw_clip_randoms(generator, n, d.clip_len, m.action_dim)
    parts = {"frames": [], "actions": [], "states": []}
    for lo in range(0, n, 64):  # render in chunks: a clip's render is its own
        clips = render_clips({k: v[lo:lo + 64] for k, v in randoms.items()}, d.clip_len,
                             m.image_size, m.action_dim)
        u8 = ((clips["frames"].clamp(-1, 1) + 1) * 127.5).round().to(torch.uint8)
        parts["frames"].append(u8.cpu().numpy())
        for key in ("actions", "states"):
            x = clips[key]
            parts[key].append(torch.cat([x, torch.zeros_like(x[:, :1])], dim=1).cpu().numpy())
    write_clips_tfrecord_native(out, *(np.concatenate(parts[k]) for k in
                                       ("frames", "actions", "states")))
    print(json.dumps({"written": out, "clips": n, "clip_len": d.clip_len}), flush=True)
    return 0


def _from_checkpoint(parser, args, cfg: Config) -> int:
    """``export``, ``sample`` and ``eval`` over the latest checkpoint in
    ``<workdir>/checkpoints`` (or the init weights, with a warning, for
    ``sample`` / ``eval`` when there is none)."""
    if args.format == "stablehlo":
        parser.error("--format stablehlo is the JAX package's artifact; the port exports "
                     "its AOT program with --format pt2")
    if args.command == "export" and args.rollout_length and args.format != "pt2":
        # Refused before the restore: an npz holds weights, not programs.
        parser.error("--rollout-length requires --format pt2 "
                     "(the npz archive holds weights, not programs)")
    import torch

    from action_conditioned_gans_tpu_torch.config import resolve_device
    from action_conditioned_gans_tpu_torch.train.state import (
        init_state,
        refuse_other_layout,
        restore_state,
        state_to_device,
        state_tree,
    )
    from action_conditioned_gans_tpu_torch.utils.checkpoint import CheckpointManager

    dev = resolve_device(args.device)
    if args.ema and cfg.train.ema_decay <= 0:
        # The template must hold a g_ema tree to receive the checkpoint's.
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, ema_decay=0.999))
    state = init_state(cfg, torch.Generator().manual_seed(cfg.train.seed), device=dev)
    ckpt = CheckpointManager(f"{cfg.workdir}/checkpoints")
    step = ckpt.latest_step()
    if step is not None:
        if args.ema:
            # Strict: the checkpoint must hold EMA weights of its own.
            try:
                state = state_to_device(ckpt.restore(state_tree(state, cfg)), dev)
            except (ValueError, RuntimeError, OSError) as e:  # a tree, file or load error
                refuse_other_layout(cfg, ckpt, step)
                parser.error("--ema needs a checkpoint trained with train.ema_decay > 0 "
                             f"(restore failed: {e})")
        else:
            state = restore_state(cfg, ckpt, template=state)
        print(f"[acgan] loaded checkpoint step {step}", flush=True)
    elif args.ema or args.command == "export":
        # Exporting or EMA-sampling the init weights is never what was meant.
        parser.error(f"{'--ema' if args.ema else 'export'} needs a checkpoint under "
                     f"{cfg.workdir}/checkpoints (none found)")
    else:
        print("[acgan] WARNING: no checkpoint found; sampling from init", flush=True)
    if args.ema:
        state.g_params = state.g_ema
    if args.command == "export":
        if args.format == "pt2":
            from action_conditioned_gans_tpu_torch.aot import export_aot

            out = args.out or f"{cfg.workdir}/generator.aot"
            meta = export_aot(cfg, state.g_params, out, rollout_length=args.rollout_length,
                              device=dev)
            # An artifact serves on any device (AotPredictor moves it at load).
            print(json.dumps({"exported": out, "ema": bool(args.ema), "format": "pt2",
                              "platforms": ["cpu", "cuda"],
                              "rollout_lengths": meta["rollout_lengths"],
                              "bytes": meta["bytes"]}), flush=True)
            return 0
        from action_conditioned_gans_tpu_torch.infer import export_generator

        out = args.out or f"{cfg.workdir}/generator.npz"
        export_generator(cfg, state.g_params, out)
        print(json.dumps({"exported": out, "ema": bool(args.ema)}), flush=True)
        return 0
    from action_conditioned_gans_tpu_torch.train.sample import evaluate, sample

    if args.command == "sample":
        metrics = sample(cfg, state, args.out or f"{cfg.workdir}/samples",
                         num_clips=args.num_clips)
    else:
        metrics = evaluate(cfg, state)
    print(json.dumps(metrics), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
