"""Environment checks: ``python -m action_conditioned_gans_tpu_torch doctor``
(port of the JAX package's ``utils/doctor.py``).

One command that says which layer is broken: the device, the compilers and
the builds (``nvcc`` for the Hopper kernels, ``g++`` for the TFRecord
library), the optional packages, the data directories, or the checkpoints.
Every check runs in a process of its own with a timeout, all at once, so a
hung device or a broken install costs one timeout and cannot take the
report down with it. A check is this module run as
``python -m action_conditioned_gans_tpu_torch.utils.doctor <check> <json>``;
it prints one JSON object.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import subprocess
import sys
import time
from typing import Dict, Optional

# What the probe computes: sum(ones(128, 128) @ ones(128, 128)).
_PROBE_WANT = 128.0 ** 3


def _probe(args) -> Dict[str, object]:
    """A matmul on the target device and a read of its value."""
    t0 = time.time()
    import torch

    dev = torch.device(args["device"])
    x = torch.ones((128, 128), device=dev)
    value = float((x @ x).sum())
    out: Dict[str, object] = {"platform": dev.type, "seconds": round(time.time() - t0, 2)}
    if dev.type == "cuda":
        out.update(name=torch.cuda.get_device_name(dev), devices=torch.cuda.device_count())
    out["ok"] = value == _PROBE_WANT
    if not out["ok"]:
        out["error"] = (f"the device computed a wrong probe value ({value}, expected "
                        f"{_PROBE_WANT}): a fault that corrupts numerics")
    return out


def _versions(args) -> Dict[str, object]:
    import importlib.metadata as md

    out: Dict[str, object] = {"ok": True, "python": sys.version.split()[0]}
    for dist in ("torch", "numpy", "tensorflow", "pillow", "triton"):
        try:
            out[dist] = md.version(dist)
        except md.PackageNotFoundError:
            out[dist] = "absent"
    return out


def _tool_version(cmd, line: int) -> Dict[str, object]:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return {"ok": False, "error": f"{type(e).__name__}: {e}"}
    if proc.returncode != 0:
        return {"ok": False, "error": f"{cmd[0]} exited {proc.returncode}"}
    return {"ok": True, "path": cmd[0], "version": proc.stdout.strip().splitlines()[line]}


def _nvcc(args) -> Dict[str, object]:
    from action_conditioned_gans_tpu_torch.ops.kernels import build

    try:
        nvcc = build.nvcc_path()
    except RuntimeError as e:
        return {"ok": False, "error": str(e)}
    return _tool_version([nvcc, "--version"], -1)


def _gxx(args) -> Dict[str, object]:
    return _tool_version([os.environ.get("CXX", "g++"), "--version"], 0)


def _kernels(args) -> Dict[str, object]:
    """The Hopper kernels' libraries for the current sources: built now, or
    already there."""
    from action_conditioned_gans_tpu_torch.ops.kernels import build

    present = sorted(n for n in build.KERNELS if os.path.exists(build.library_path(n)))
    build.build_all()
    return {"ok": True, "dir": build.BUILD_DIR, "hash": build._sources_hash(),
            "already_built": present, "built_now": sorted(set(build.KERNELS) - set(present))}


def _native_lib(args) -> Dict[str, object]:
    from action_conditioned_gans_tpu_torch.data import native_tfrecord as nt

    path = nt.library_path()
    already = os.path.exists(path)
    lib = nt.load_library()
    return {"ok": True, "path": path, "already_built": already, "abi_version": nt._lib_abi(lib)}


def _tensorflow(args) -> Dict[str, object]:
    import tensorflow as tf

    return {"ok": True, "version": tf.__version__}


def _data_dir(args) -> Dict[str, object]:
    """The files of a data directory and its first record, parsed as the
    native reader parses it."""
    from action_conditioned_gans_tpu_torch.data import native_tfrecord as nt

    d = args["data"]
    pattern = nt.tfrecord_file_pattern(args["dir"])
    files = sorted(glob.glob(pattern))
    if not files:
        return {"ok": False, "error": f"no TFRecord files match {pattern}"}
    out: Dict[str, object] = {"ok": True, "files": len(files),
                              "bytes": sum(os.path.getsize(f) for f in files)}
    try:
        frames, actions, states = next(nt.read_clips(
            files[0], d["clip_len"], d["raw_image_size"], d["raw_image_size"],
            args["action_dim"], args["state_dim"], d["tfrecord_image_key"],
            encoding=d["tfrecord_encoding"]))
        out["first_clip"] = {"frames": list(frames.shape), "actions": list(actions.shape),
                             "states": list(states.shape)}
    except StopIteration:
        out.update(ok=False, error=f"{files[0]} contains no records")
    except (OSError, ValueError, ImportError) as e:
        out.update(ok=False, error=f"first record unreadable: {type(e).__name__}: {e}")
    return out


def _checkpoints(args) -> Dict[str, object]:
    ckpt_dir = os.path.join(args["workdir"], "checkpoints")
    if not os.path.isdir(ckpt_dir):
        return {"ok": True, "skipped": f"no checkpoint dir at {ckpt_dir}"}
    entries = sorted(os.listdir(ckpt_dir))
    steps = sorted(int(e) for e in entries if e.isdigit())
    if steps:
        return {"ok": True, "steps": steps[-5:], "latest": steps[-1]}
    if not entries:
        # The loop makes the directory at start: a fresh run's normal state.
        return {"ok": True, "note": f"{ckpt_dir} exists but is empty (fresh run or before the "
                                    "first checkpoint_every boundary); a resume would start over"}
    if all(".tmp-" in e for e in entries):
        return {"ok": True, "note": "a save in progress (temporary directories only)"}
    return {"ok": False, "error": f"{ckpt_dir} is non-empty ({entries[:5]}) but holds no "
                                  "numeric step directory: nothing to restore; a resume would "
                                  "start over"}


_CHECKS = {"device": _probe, "versions": _versions, "nvcc": _nvcc, "gxx": _gxx,
           "kernels": _kernels, "native_lib": _native_lib, "tensorflow": _tensorflow,
           "data_dir": _data_dir, "eval_data_dir": _data_dir, "checkpoints": _checkpoints}


def _start(name: str, args) -> subprocess.Popen:
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    return subprocess.Popen([sys.executable, "-m", __name__, name, json.dumps(args)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _collect(name: str, proc: subprocess.Popen, timeout: float) -> Dict[str, object]:
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.terminate()  # SIGTERM first, so that a device context is released cleanly
        try:
            proc.wait(timeout=15)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        return {"ok": False, "error": f"the {name} check hung past {timeout:.0f}s and was stopped"}
    if proc.returncode != 0:
        return {"ok": False, "error": f"the {name} check exited {proc.returncode}",
                "stderr_tail": err.strip().splitlines()[-3:]}
    try:
        return json.loads(out.strip().splitlines()[-1])
    except (ValueError, IndexError):
        return {"ok": False, "error": f"the {name} check printed no JSON",
                "stdout_tail": out.strip().splitlines()[-3:]}


def run_doctor(cfg, probe_timeout: int = 120, device: Optional[str] = None) -> Dict[str, object]:
    """Every check, at once; ``ok`` is the AND of the device, the native
    library, the data directories and the checkpoints, and, when the target
    device is CUDA, of ``nvcc`` and the kernels' build. ``device`` is the
    probe's target (cuda unless another is given); TensorFlow and the
    versions are informational."""
    device = device or "cuda"
    on_cuda = device.startswith("cuda")
    data = dataclasses.asdict(cfg.data)
    reads_files = cfg.data.source in ("tfrecord", "tfrecord_native")
    common = dict(data=data, action_dim=cfg.model.action_dim,
                  state_dim=cfg.model.state_dim or 3, workdir=cfg.workdir, device=device)
    plan = {name: (timeout, common) for name, timeout in (
        ("device", probe_timeout), ("versions", 60), ("nvcc", 60), ("gxx", 60),
        ("native_lib", 300), ("tensorflow", 120), ("checkpoints", 60))}
    skipped = {}
    if on_cuda:
        plan["kernels"] = (600, common)
    else:
        skipped["kernels"] = {"ok": True, "skipped": f"device={device} runs the plain versions"}
    for key, path in (("data_dir", cfg.data.data_dir), ("eval_data_dir", cfg.data.eval_data_dir)):
        if not reads_files:
            skipped[key] = {"ok": True, "skipped": f"source={cfg.data.source!r} reads no files"}
        elif path:
            plan[key] = (120, dict(common, dir=path))
        elif key == "eval_data_dir":
            skipped[key] = {"ok": True, "skipped": "eval_data_dir unset: evaluate and sample "
                            "read the training data_dir (set data.eval_data_dir to a held-out "
                            "split for an honest eval)"}
        else:
            skipped[key] = {"ok": False,
                            "error": f"source={cfg.data.source!r} but data.data_dir is unset"}
    procs = {name: (_start(name, args), timeout) for name, (timeout, args) in plan.items()}
    report: Dict[str, object] = {name: _collect(name, proc, timeout)
                                 for name, (proc, timeout) in procs.items()}
    report.update(skipped)
    report["toolchain"] = {"nvcc": report.pop("nvcc"), "gxx": report.pop("gxx")}
    gates = ["device", "native_lib", "data_dir", "eval_data_dir", "checkpoints"]
    ok = all(bool(report[k].get("ok")) for k in gates)
    if on_cuda:
        ok = ok and bool(report["toolchain"]["nvcc"].get("ok")) and bool(report["kernels"].get("ok"))
    report["ok"] = ok
    return report


if __name__ == "__main__":
    from action_conditioned_gans_tpu_torch.utils.compile_cache import maybe_enable_compile_cache

    maybe_enable_compile_cache()  # the builds the checks look at
    print(json.dumps(_CHECKS[sys.argv[1]](json.loads(sys.argv[2]))), flush=True)
