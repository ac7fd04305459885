"""One rank of a ``gloo`` process group on the CPU, for the port's
data-parallel tests (tests/test_torch_parallel.py, test_torch_multihost.py).

    python -m tests.torch_dist_worker RANK WORLD INIT_FILE JOB.json

``JOB.json`` names a ``mode`` and its inputs:

* ``steps``: for each scenario, the state from ``<dir>/<name>.npz`` (the
  port's state_dicts under ``g/`` and ``d/``), the global batches of each
  step (``batch<i>/<key>``) and this rank's draws (``rank<r>/step<i>/<key>``),
  run through ``make_dp_train_step`` on the rank's rows; writes the
  parameters, moments, metrics and the all-reduce sizes issued by each step
  to ``<dir>/<name>.rank<r>.npz``.
* ``train``: for each of ``runs``, ``train.loop.train`` of its ``config``
  (a port config as a dict) to ``steps`` in ``workdir``, rank
  ``sigterm_rank`` (if given) sending itself SIGTERM after its
  ``sigterm_after_ticks``-th call; writes the final step and parameters to
  ``<out>.rank<r>.npz``.

The helper :func:`run_ranks` starts the ranks and joins them with a
deadline; a collective that never completes fails the test instead of
hanging it.
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(job: dict, tmp_path, world: int = 2, timeout: float = 120.0) -> list:
    """Run ``job`` on ``world`` ranks (one process each, a ``file://`` init
    under ``tmp_path``); returns each rank's output. Every rank is joined
    by the deadline and killed after it; a rank that fails raises with its
    output."""
    path = os.path.join(str(tmp_path), f"job-{time.monotonic_ns()}.json")
    with open(path, "w") as f:
        json.dump(job, f)
    init = os.path.join(str(tmp_path), f"init-{time.monotonic_ns()}")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    logs = [open(f"{path}.rank{r}.log", "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_dist_worker", str(r),
                               str(world), init, path], cwd=REPO, env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{outs[r][-4000:]}"
    return outs


def _steps(job: dict, rank: int) -> None:
    import numpy as np
    import torch
    import torch.distributed as dist

    from action_conditioned_gans_tpu_torch.config import config_from_dict
    from action_conditioned_gans_tpu_torch.parallel.dp import make_dp_train_step
    from action_conditioned_gans_tpu_torch.parallel.mesh import batch_slice, make_mesh
    from action_conditioned_gans_tpu_torch.train.state import state_from_params
    from action_conditioned_gans_tpu_torch.train.step import StepRandoms

    sizes = []
    real_all_reduce = dist.all_reduce

    def counted(tensor, *args, **kwargs):
        sizes.append(tensor.numel())
        return real_all_reduce(tensor, *args, **kwargs)

    dist.all_reduce = counted
    for name, cfg_dict in job["scenarios"].items():
        cfg = config_from_dict(cfg_dict)
        with np.load(os.path.join(job["dir"], f"{name}.npz")) as z:
            arrays = {k: z[k] for k in z.files}
        tensors = {k: torch.from_numpy(v) for k, v in arrays.items()}
        state = state_from_params(
            cfg, {k[2:]: v for k, v in tensors.items() if k.startswith("g/")},
            {k[2:]: v for k, v in tensors.items() if k.startswith("d/")}, device="cpu")
        mesh = make_mesh(cfg.mesh, device="cpu")
        step = make_dp_train_step(cfg, mesh, seed=job["seed"])
        out, n_steps = {}, int(arrays["n_steps"])
        for i in range(n_steps):
            batch = {k.split("/")[1]: v for k, v in tensors.items() if k.startswith(f"batch{i}/")}
            prefix = f"rank{rank}/step{i}/"
            randoms = StepRandoms(**{k[len(prefix):]: v for k, v in tensors.items()
                                     if k.startswith(prefix)})
            before = len(sizes)
            state, metrics = step(state, batch_slice(batch, mesh), randoms)
            out[f"all_reduce_sizes/step{i}"] = np.array(sizes[before:], np.int64)
            out.update({f"metrics/step{i}/{k}": v.numpy() for k, v in metrics.items()})
        for tree in ("g_params", "d_params"):
            out.update({f"{tree}/{k}": v.numpy() for k, v in getattr(state, tree).items()})
        for tree in ("g_opt", "d_opt"):
            out.update({f"{tree}/mu/{k}": v.float().numpy()
                        for k, v in getattr(state, tree).mu.items()})
        np.savez(os.path.join(job["dir"], f"{name}.rank{rank}.npz"), **out)


def _train(job: dict, rank: int) -> None:
    import signal

    import numpy as np

    from action_conditioned_gans_tpu_torch.config import config_from_dict
    from action_conditioned_gans_tpu_torch.train.loop import train
    from action_conditioned_gans_tpu_torch.utils.metrics import MetricWriter

    real_tick = MetricWriter.tick
    for run in job["runs"]:
        ticks = {"n": 0}

        def tick(self, run=run):
            real_tick(self)
            ticks["n"] += 1
            if run.get("sigterm_rank") == rank and ticks["n"] == run["sigterm_after_ticks"]:
                os.kill(os.getpid(), signal.SIGTERM)

        MetricWriter.tick = tick
        print(f"== run {run['out']}", flush=True)
        state = train(config_from_dict(run["config"]), max_steps=run["steps"],
                      workdir=run["workdir"], device="cpu")
        np.savez(f"{run['out']}.rank{rank}.npz", step=state.step,
                 **{f"{tree}/{k}": v.numpy() for tree in ("g_params", "d_params")
                    for k, v in getattr(state, tree).items()})


def main(argv) -> int:
    rank, world, init, path = int(argv[0]), int(argv[1]), argv[2], argv[3]
    sys.modules["torch.utils.tensorboard"] = None  # no TensorBoard: its import takes seconds
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(path) as f:
        job = json.load(f)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=90))
    try:
        {"steps": _steps, "train": _train}[job["mode"]](job, rank)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
