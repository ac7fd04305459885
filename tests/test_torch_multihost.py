"""``train`` over a process group on the CPU: two ``gloo`` ranks
(tests/torch_dist_worker.py, one spawn for all the runs below) and the
``--multihost`` CLI under ``torchrun`` (one more).

* On synthetic clips the two ranks end with one state, bit for bit, equal
  to the one-rank run on the whole batch within the reference's DP bars
  (tests/test_parallel.py: 5e-5 on the parameters);
* rank 0 alone prints, writes metrics and samples and checkpoints;
* on clip files each rank reads its file shard; a run checkpointed at step
  4 and resumed to 8 ends where the uninterrupted run ends, bit for bit;
* SIGTERM delivered to one rank stops both at the same step with one
  checkpoint (the flag is max-reduced before each save decision).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from action_conditioned_gans_tpu_torch import cli
from action_conditioned_gans_tpu_torch.train.loop import train
from tests.test_torch_loop import loop_config, metric_lines, steps_on_disk
from tests.test_torch_native_tfrecord import write_files
from tests.test_torch_resume_data import file_config
from tests.torch_dist_worker import REPO, run_ranks

torch.set_num_threads(1)
WORLD = 2


def dp(cfg, **train_kw):
    """``cfg`` on a data axis of every rank, with ``train_kw``."""
    return cfg.replace(mesh=dataclasses.replace(cfg.mesh, data=-1),
                       train=dataclasses.replace(cfg.train, **train_kw))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One spawn of two ranks, five ``train`` runs in turn: synthetic 8
    steps; files 8 steps; files 4 steps, then resumed to 8; synthetic with
    rank 1 sent SIGTERM after its second call."""
    root = tmp_path_factory.mktemp("multihost")
    write_files(root, n=24, files=2)
    syn = dp(loop_config(root / "syn"), batch_size=4, steps_per_call=2, log_every=2,
             checkpoint_every=4, sample_every=4)
    files = dp(file_config(root, "tfrecord_native"), batch_size=4, log_every=2,
               checkpoint_every=4, sample_every=0)
    sig = dp(loop_config(root / "sig"), batch_size=4, steps_per_call=2)
    plan = {"syn": (syn, 8, "syn", {}), "file_whole": (files, 8, "whole", {}),
            "file_first": (files, 4, "resumed", {}), "file_resumed": (files, 8, "resumed", {}),
            "sigterm": (sig, 100, "sig", dict(sigterm_rank=1, sigterm_after_ticks=2))}
    job = {"mode": "train", "runs": [
        dict(config=dataclasses.asdict(cfg), steps=steps, workdir=str(root / workdir),
             out=str(root / name), **extra) for name, (cfg, steps, workdir, extra) in plan.items()]}
    logs = run_ranks(job, root, world=WORLD, timeout=300)
    out = {"root": root, "cfg": {name: p[0] for name, p in plan.items()}}
    for name in plan:
        out[name] = []
        for r in range(WORLD):
            with np.load(str(root / f"{name}.rank{r}.npz")) as z:
                out[name].append({k: z[k] for k in z.files})
    out["logs"] = [{chunk.split("\n", 1)[0]: chunk for chunk in log.split("== run ")[1:]}
                   for log in logs]
    return out


def params(out):
    return {k: v for k, v in out.items() if k != "step"}


def assert_one_state(outs):
    a, b = outs
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_two_ranks_train_as_one_on_the_whole_batch(runs, tmp_path):
    """Both ranks hold one state after 8 steps (4 calls of k=2), equal to
    the run without a group on the whole batch within 5e-5: each rank's
    synthetic clips are its rows of the one-rank batch."""
    assert_one_state(runs["syn"])
    assert int(runs["syn"][0]["step"]) == 8
    one = train(runs["cfg"]["syn"], max_steps=8, workdir=str(tmp_path), device="cpu")
    mine = params(runs["syn"][0])
    for tree in ("g_params", "d_params"):
        for k, v in getattr(one, tree).items():
            np.testing.assert_allclose(mine[f"{tree}/{k}"], v.numpy(), atol=5e-5, err_msg=k)


def test_rank_zero_alone_prints_writes_and_checkpoints(runs):
    """Rank 0 prints the run's lines and the metric lines (steps 2-8 and the
    held-out rollouts at 4 and 8, over the global batch); rank 1 prints
    nothing. The checkpoints on disk (4, 8) hold the ranks' final state."""
    name = str(runs["root"] / "syn")
    lead, other = runs["logs"][0][name], runs["logs"][1][name]
    lines = metric_lines(lead)
    assert [r["step"] for r in lines] == [2, 4, 4, 6, 8, 8]
    assert sum("eval_l2" in r for r in lines) == 2
    assert "[acgan] tiny-preempt: G params" in lead and "mesh data=2" in lead
    assert "[acgan]" not in other and not metric_lines(other)
    workdir = str(runs["root"] / "syn")
    assert steps_on_disk(workdir) == [4, 8]
    tree = torch.load(os.path.join(workdir, "checkpoints", "8", "state.pt"))
    mine = params(runs["syn"][0])
    for k, v in tree["g_params"].items():
        np.testing.assert_array_equal(v.numpy(), mine[f"g_params/{k}"], err_msg=k)


def test_two_ranks_resume_on_files_exactly(runs):
    """On clip files (each rank its file, 2 clips a step), the run
    checkpointed at step 4 and resumed to 8 ends with the uninterrupted
    run's state, bit for bit, on both ranks."""
    assert_one_state(runs["file_whole"])
    assert int(runs["file_first"][0]["step"]) == 4
    name = str(runs["root"] / "file_resumed")
    assert "resumed from checkpoint at step 4" in runs["logs"][0][name]
    for r in range(WORLD):
        whole, resumed = runs["file_whole"][r], runs["file_resumed"][r]
        assert int(resumed["step"]) == 8
        for k in whole:
            np.testing.assert_array_equal(resumed[k], whole[k], err_msg=k)
    assert steps_on_disk(str(runs["root"] / "resumed")) == [4, 8]


def test_sigterm_on_one_rank_stops_both_at_one_step(runs):
    """Rank 1 alone got SIGTERM after its second call: both ranks stop after
    that call, at step 4, with one checkpoint of it, and no rank waits in a
    collective the other skipped."""
    assert [int(o["step"]) for o in runs["sigterm"]] == [4, 4]
    assert_one_state(runs["sigterm"])
    assert steps_on_disk(str(runs["root"] / "sig")) == [4]
    name = str(runs["root"] / "sigterm")
    assert "SIGTERM received: checkpointing at step 4" in runs["logs"][0][name]


def test_multihost_needs_torchrun_and_refuses_a_missing_card(tmp_path, monkeypatch):
    """``--multihost`` outside torchrun names what is missing; a CUDA rank
    without CUDA raises instead of running on the CPU."""
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    argv = ["--multihost", "train", "--workdir", str(tmp_path), "--steps", "1"]
    with pytest.raises(RuntimeError, match="torchrun's environment"):
        cli.main(argv)
    if torch.cuda.is_available():
        return
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    monkeypatch.setenv("MASTER_PORT", "0")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        cli.main(argv)
    assert not os.path.exists(tmp_path / "checkpoints")


def test_cli_multihost_trains_under_torchrun(tmp_path):
    """``torchrun --standalone --nproc-per-node 2 -m action_conditioned_gans_tpu_torch
    --multihost --device cpu train``: the metric lines once, from rank 0,
    and the checkpoints of the run."""
    sets = ["model.image_size=16", "model.g_levels=2", "model.g_base_channels=8",
            "model.d_levels=2", "model.d_base_channels=8", "model.group_norm_groups=4",
            "train.batch_size=4", "train.steps_per_call=2", "train.log_every=2",
            "train.checkpoint_every=4", "train.sample_every=0"]
    argv = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            f"--nproc-per-node={WORLD}", "-m", "action_conditioned_gans_tpu_torch",
            "--multihost", "--device", "cpu", "train", "--preset", "config1",
            "--workdir", str(tmp_path), "--steps", "4"]
    for s in sets:
        argv += ["--set", s]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    proc = subprocess.run(argv, cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    lines = [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]
    assert [r["step"] for r in lines] == [2, 4]
    assert all(np.isfinite(v) for r in lines for v in r.values())
    assert proc.stdout.count("G params") == 1 and "mesh data=2" in proc.stdout
    assert steps_on_disk(str(tmp_path)) == [4]
