"""One rank of a ``gloo`` process group on the CPU, for the port's
data- and tensor-parallel tests (tests/test_torch_parallel.py,
test_torch_multihost.py, test_torch_tp.py).

    python -m tests.torch_dist_worker RANK WORLD INIT_FILE JOB.json

``JOB.json`` names a ``mode`` and its inputs (or holds ``jobs``, a list of
such, run in turn):

* ``steps``: for each scenario, the state from ``<dir>/<name>.npz`` (the
  port's state_dicts under ``g/`` and ``d/``), the global batches of each
  step (``batch<i>/<key>``) and this rank's draws (``rank<r>/step<i>/<key>``),
  run through ``make_dp_train_step`` on the rank's rows; writes the
  parameters, moments, metrics and the all-reduce sizes issued by each step
  to ``<dir>/<name>.rank<r>.npz``.
* ``tp_steps``: as ``steps`` on a ``(data, model)`` mesh (``mesh.model`` of
  the scenario's config): the full state sharded (``parallel.tp``), the
  global batch's draws (``step<i>/<key>``) given whole; writes the gathered
  parameters, this rank's shards of the parameters and first moments, and
  the metrics to ``<dir>/<name>.w<world>.rank<r>.npz``.
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
            mu = getattr(state, tree).mu
            if isinstance(mu, torch.Tensor):  # train.flatten_optimizer's one vector
                out[f"{tree}/mu"] = mu.float().numpy()
            else:
                out.update({f"{tree}/mu/{k}": v.float().numpy() for k, v in mu.items()})
        np.savez(os.path.join(job["dir"], f"{name}.rank{rank}.npz"), **out)


def leaves(state):
    """Every tensor of a TrainState, in a fixed order."""
    for tree in ("g_params", "d_params", "g_ema"):
        yield from (getattr(state, tree) or {}).values()
    for tree in ("g_opt", "d_opt"):
        yield from getattr(state, tree).mu.values()
        yield from getattr(state, tree).nu.values()


def _tp_steps(job: dict, rank: int) -> None:
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist

    from action_conditioned_gans_tpu_torch.config import config_from_dict
    from action_conditioned_gans_tpu_torch.parallel.dp import make_dp_train_step
    from action_conditioned_gans_tpu_torch.parallel.mesh import batch_slice, make_mesh
    from action_conditioned_gans_tpu_torch.parallel.tp import gather_state, shard_state
    from action_conditioned_gans_tpu_torch.train.state import state_from_params
    from action_conditioned_gans_tpu_torch.train.step import StepRandoms

    world = dist.get_world_size()
    for name, cfg_dict in job["scenarios"].items():
        cfg = config_from_dict(cfg_dict)
        with np.load(os.path.join(job["dir"], f"{name}.npz")) as z:
            tensors = {k: torch.from_numpy(z[k]) for k in z.files}
        mesh = make_mesh(cfg.mesh, device="cpu")
        state = shard_state(state_from_params(
            cfg, {k[2:]: v for k, v in tensors.items() if k.startswith("g/")},
            {k[2:]: v for k, v in tensors.items() if k.startswith("d/")}, device="cpu"),
            mesh.model_index, mesh.model)
        step = make_dp_train_step(cfg, mesh, seed=job["seed"])
        out = {}
        for i in range(int(tensors["n_steps"])):
            batch = {k.split("/")[1]: v for k, v in tensors.items() if k.startswith(f"batch{i}/")}
            prefix = f"step{i}/"
            randoms = StepRandoms(**{k[len(prefix):]: v for k, v in tensors.items()
                                     if k.startswith(prefix)})
            state, metrics = step(state, batch_slice(batch, mesh), randoms)
            out.update({f"metrics/step{i}/{k}": v.numpy() for k, v in metrics.items()})
        for tree in ("g_params", "d_params"):
            out.update({f"shard/{tree}/{k}": v.numpy() for k, v in getattr(state, tree).items()})
        for tree in ("g_opt", "d_opt"):
            out.update({f"shard/{tree}/mu/{k}": v.float().numpy()
                        for k, v in getattr(state, tree).mu.items()})
        full = gather_state(state, cfg, mesh.model_group)
        for tree in ("g_params", "d_params"):
            out.update({f"{tree}/{k}": v.numpy() for k, v in getattr(full, tree).items()})
        # Round trips: gathered and sharded again, the state comes back bit
        # for bit, also with bfloat16 moments.
        bf16 = dataclasses.replace(state, **{
            t: dataclasses.replace(getattr(state, t), **{
                m: {k: v.to(torch.bfloat16) for k, v in getattr(getattr(state, t), m).items()}
                for m in ("mu", "nu")}) for t in ("g_opt", "d_opt")})
        for label, st in (("float32", state), ("bfloat16", bf16)):
            back = shard_state(gather_state(st, cfg, mesh.model_group), mesh.model_index,
                               mesh.model)
            out[f"round_trip/{label}"] = np.array(all(
                a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(leaves(back), leaves(st))))
        np.savez(os.path.join(job["dir"], f"{name}.w{world}.rank{rank}.npz"), **out)


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
        for part in job.get("jobs", [job]):  # a list of jobs runs in turn
            {"steps": _steps, "tp_steps": _tp_steps, "train": _train}[part["mode"]](part, rank)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
