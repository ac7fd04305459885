"""Runs one cell once and builds its result line, all of it found by name.

``BENCHMARK.json`` at the root of the checkout names the cell; its
configuration's file (``configs[].file``) holds the configuration as it is
run and names its plain reference (``benchmark/reference/<reference>.py``);
the cell's traffic mix is ``benchmark/traffic/<traffic>.json``, run by
``run(ctx)`` of ``benchmark/runners/<kind>.py``, ``kind`` being the mix's
own key; the limits of the numbers its check compares are
``benchmark/limits/<cell>.json``; each per-layer metric is read by
``read(run)`` of ``benchmark/metrics/<metric>.py``, or where there is no
such file, of the reader named by the metric's name up to its first dot
(``device_idle_pct.py`` serves ``device_idle_pct.train`` and
``device_idle_pct.serve``), which returns None where it finds nothing to
read. A later change adds a configuration, a mix, a kind of traffic, a
metric or a cell as new files and entries, editing none of these.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional

import torch

from benchmark import runners

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "action_conditioned_gans_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``FORBIDDEN``, compared whole: the port's own name begins with the JAX
    package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(name: str, root: str = ROOT) -> dict:
    """The cell ``name`` of ``BENCHMARK.json`` with everything it names:
    ``cell``, ``config`` (the configuration file), ``traffic``, ``limits``
    and the ``end_to_end`` and ``per_layer`` metrics it reports."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(cells)}")
    cell = cells[name]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def reports(metric):
        return name in metric.get("workloads", [name])

    return {
        "cell": cell,
        "config": load_json(os.path.join(root, config["file"])),
        "traffic": load_json(os.path.join(root, "benchmark", "traffic", f"{cell['traffic']}.json")),
        "limits": load_json(os.path.join(root, "benchmark", "limits", f"{name}.json")),
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
    }


def runner(kind: str):
    """``run`` of ``benchmark/runners/<kind>.py``."""
    return importlib.import_module(f"benchmark.runners.{kind}").run


def reader(metric: str, root: str = ROOT):
    """``read`` of ``benchmark/metrics/<metric>.py``, or where there is none,
    of ``benchmark/metrics/<metric up to its first dot>.py``."""
    path = os.path.join(root, "benchmark", "metrics", f"{metric}.py")
    if not os.path.exists(path):
        path = os.path.join(root, "benchmark", "metrics", f"{metric.split('.')[0]}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def reference_module(config: dict):
    return importlib.import_module(f"benchmark.reference.{config['reference']}")


def context(found: dict, seed: int, seconds: float, trace: bool, started: float,
            device: torch.device, tmpdir: str, config: Optional[dict] = None,
            log=sys.stderr) -> runners.Context:
    """The runner's context for a cell that :func:`find_cell` found."""
    return runners.Context(
        cfg=config if config is not None else found["config"]["config"],
        traffic=found["traffic"], seed=seed, seconds=seconds, trace=trace, device=device,
        started=started, tmpdir=tmpdir, reference=reference_module(found["config"]), log=log)


def card_line() -> Optional[str]:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=False)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip() or None


def run_cell(name: str, seed: int, seconds: float, trace: bool, started: float,
             device: str = "cuda", config: Optional[dict] = None, root: str = ROOT,
             log=sys.stderr) -> dict:
    """One run of cell ``name``: its result line as a dict, whose last key,
    ``check``, holds each number compared beside its limit. ``config``
    replaces the configuration file's ``config`` (a smaller model for a
    test on the CPU)."""
    found = find_cell(name, root)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.zeros((), device=dev)
        torch.cuda.reset_peak_memory_stats(dev)
        print(f"bench: set-up: torch and the card at {time.perf_counter() - started:.3f} s",
              file=log, flush=True)
    run_one = runner(found["traffic"]["kind"])
    with tempfile.TemporaryDirectory(prefix="bench-") as tmpdir:
        ctx = context(found, seed, seconds, trace, started, dev, tmpdir, config, log)
        run = run_one(ctx)

    if trace:
        metrics = {}
        for m in found["per_layer"]:
            value = reader(m["name"], root)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(run.end_to_end, setup_s=run.setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in found["end_to_end"]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": found["cell"]["chips"],
        "memory_peak_bytes": run.memory_peak_bytes,
    }
    line = {"correct": None, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics, "device": device_info}
    if run.trace is not None:
        s = run.trace
        device_info["busy_s"] = s.busy_s
        device_info["window_s"] = s.window_s
        top = sorted(s.group_s.items(), key=lambda kv: -kv[1])
        line["breakdown"] = {"device_ops": [[g, v] for g, v in top if v > 0][:10],
                             "idle_gaps": [[n, v] for n, v in s.idle_gaps][:10]}
        matched = ", ".join(f"{k} {v['matched']}/{v['launches']}"
                            for k, v in s.kernels.items() if v["launches"])
        print(f"bench: kernels' launches matched to shapes: {matched or 'none launched'}",
              file=log)
    for note in run.notes:
        print(f"bench: {note}", file=log)

    # The cell's limits name the numbers it compares; the others are a look.
    check = {key: {"value": run.readings[key], "limit": limit}
             for key, limit in found["limits"].items()}
    print(f"bench: readings: {json.dumps(run.readings)}", file=log)
    line["correct"] = bool(check) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in check.values())
    line["check"] = check
    return line


def print_check(line: dict, log=sys.stderr) -> None:
    """Each number compared beside its limit, as the last lines on ``log``."""
    for key, c in line["check"].items():
        verdict = "ok" if math.isfinite(c["value"]) and c["value"] <= c["limit"] else "OVER"
        print(f"check {key} {c['value']!r} limit {c['limit']!r} {verdict}", file=log)
