"""The readings the output check's limits are set from, at a cell's own size:

    python3 benchmark/calibrate.py --workload config5.train --seeds 11-22 \
        --control-seeds 31-33

For each of ``--seeds``, one run of the program as the cell runs it (its
set-up, a window of ``--seconds``, the check) and the numbers compared: the
lower readings. For each of ``--control-seeds``, the reference itself put
in the program's place, in float8 (e4m3, one scale a tensor) where the
configuration states bfloat16 (the control, which has to come out as not
correct), and the faults the cell can have, planted in that reference: a
training call over half of each batch (the mean over the rest), a rollout
that feeds ``frame0`` to every step (its state left unchanged), and one
candidate's frame altered where it is produced. A training call that
returns its state unchanged reads 1 on ``update_gap`` and ``warm_update_gap``
(and on ``grad_gap`` from the seed) by their definition and needs no run. One JSON line per reading, then the
largest program reading and the smallest control and fault readings of
each number. All in one process: the set-up's imports and kernel loads are
paid once.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

sys.path[:] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))] + [
    p for p in sys.path if os.path.abspath(p or ".") != os.path.dirname(os.path.abspath(__file__))]


def seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        if "-" in part:
            lo, hi = part.split("-")
            out.extend(range(int(lo), int(hi) + 1))
        elif part:
            out.append(int(part))
    return out


def harness_reference(found: dict):
    from benchmark import harness

    return harness.reference_module(found["config"])


def train_controls(found: dict, seed: int, device) -> dict:
    """Readings of the float8 reference and of the half-batch fault in the
    program's place, against the float32 reference, on the two calls a run
    checks: the first from the seed, and a warm one, from the float32
    reference's state after the first (the program's own state there in a
    run), over the bank's first batch, as a run's window call is."""
    from benchmark import inputs
    from benchmark.runners import train_steps

    cfg = found["config"]["config"]
    mod = harness_reference(found)
    g_spec, d_spec = mod.param_spec(cfg["model"])
    g = inputs.make_params(g_spec, seed, "g", device)
    d = inputs.make_params(d_spec, seed, "d", device)
    batch = inputs.train_bank(cfg, 1, seed, device)[0]
    frames, actions = batch["frames"], batch["actions"]
    if cfg["train"]["steps_per_call"] <= 1:
        frames, actions = frames[None], actions[None]
    seed_start = {"g": g, "d": d}
    ref_first = train_steps.reference_call(mod, cfg, seed_start, frames, actions)
    warm_start = {key: ref_first[key] for key in ("g", "d", "g_mu", "g_nu", "g_count", "d_mu",
                                                  "d_nu", "d_count")}
    ref_warm = train_steps.reference_call(mod, cfg, warm_start, frames, actions)
    out = {}
    for name, kw in (("control_fp8", {"rnd": mod.fp8_round}),
                     ("fault_half_batch", {"keep": cfg["train"]["batch_size"] // 2})):
        readings, looks = {}, {}
        for prefix, before, ref in (("", seed_start, ref_first), ("warm_", warm_start, ref_warm)):
            side = train_steps.reference_call(mod, cfg, before, frames, actions, **kw)
            r, looks[prefix or "first"] = train_steps.call_readings(
                mod, cfg, before, side, side["losses"][-1], ref)
            readings.update({f"{prefix}{n}": v for n, v in r.items()})
            del side
        out[name] = readings
        print(json.dumps({"seed": seed, "side": name, "look": looks}), flush=True)
    return out


def serve_controls(found: dict, seed: int, device) -> dict:
    """Readings of the float8 reference, of a rollout that feeds frame0 to
    every step and of one altered candidate frame, in the program's place,
    checked as a run checks the program's frames, on the seed's sampled
    request."""
    import torch

    from benchmark import inputs

    cfg, tr = found["config"]["config"], found["traffic"]
    mod = harness_reference(found)
    m = cfg["model"]
    g = inputs.make_params(mod.param_spec(m)[0], seed, "g", device)
    r = inputs.requests(cfg, 1, tr["candidates"], tr["horizon"], seed, device)[0]
    frame0 = torch.from_numpy(r["frame0"]).to(device)
    actions = torch.from_numpy(r["actions"]).to(device)

    def roll(rnd, feed_frame0=False):
        prev, frames = frame0, []
        with torch.no_grad(), mod.float32_math():
            for t in range(actions.shape[1]):
                pred = mod.generator(m, g, frame0 if feed_frame0 else prev, actions[:, t], rnd)
                frames.append(pred.to(torch.bfloat16))
                prev = frames[-1].float()
        return torch.stack(frames, dim=1)

    def reading(frames):
        return float(mod.rollout_gaps(m, g, frame0, actions, frames).max())

    altered = roll(None)
    altered[0, actions.shape[1] // 2] += 0.25
    return {"control_fp8": {"frame_gap": reading(roll(mod.fp8_round))},
            "fault_state_unchanged": {"frame_gap": reading(roll(None, feed_frame0=True))},
            "fault_altered_frame": {"frame_gap": reading(altered)},
            "float32_reference": {"frame_gap": reading(roll(None))}}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", default="")
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--seconds", type=float, default=0.0)
    args = parser.parse_args()

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    found = harness.find_cell(args.workload)
    lower, upper = {}, {}
    print(f"calibrate: card {harness.card_line()}", flush=True)
    for seed in seeds(args.seeds):
        torch.cuda.reset_peak_memory_stats(dev)
        with tempfile.TemporaryDirectory(prefix="bench-") as tmpdir:
            ctx = harness.context(found, seed, args.seconds, False, time.perf_counter(), dev,
                                  tmpdir)
            run = harness.runner(found["traffic"]["kind"])(ctx)
        print(json.dumps({"seed": seed, "side": "program", "readings": run.readings,
                          "setup_s": run.setup_s, "end_to_end": run.end_to_end,
                          "memory_peak_bytes": run.memory_peak_bytes, "notes": run.notes}),
              flush=True)
        for k, v in run.readings.items():
            lower[k] = max(lower.get(k, 0.0), v)
        torch.cuda.empty_cache()
    controls = train_controls if found["traffic"]["kind"] == "train_steps" else serve_controls
    for seed in seeds(args.control_seeds):
        for side, readings in controls(found, seed, dev).items():
            print(json.dumps({"seed": seed, "side": side, "readings": readings}), flush=True)
            for k, v in readings.items():
                upper.setdefault(side, {})
                upper[side][k] = min(upper[side].get(k, float("inf")), v)
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "lower": lower, "upper": upper,
                      "seconds": time.perf_counter() - STARTED}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
