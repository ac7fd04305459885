"""The training loop (port of the JAX package's ``train/loop.py``).

Each iteration takes one stacked batch and runs ``steps_per_call`` fused G+D
steps on it; metrics are read back only at log boundaries. Synthetic batches
are made on the device; file batches are read on the host by a background
thread and copied to the device (``data/pipeline.py``). Checkpoints every
``checkpoint_every`` steps (the newest ``checkpoint_keep`` kept), held-out
rollouts every ``sample_every``, and on SIGTERM a checkpoint and a clean
exit. A run resumes from the latest checkpoint at the batch an uninterrupted
run would have seen next: synthetic batch i is a pure function of (seed, i),
and the loop asks for batch ``start // k``; the file readers skip the
``start // k`` calls' batches already consumed.

Under an initialised ``torch.distributed`` process group the loop is one
rank of a data-parallel run (``parallel/``): every rank builds the same
state, restores on resume, reads its share of each batch (its rows of the
synthetic batch, its file shard) and runs the data-parallel step on its own
device, ``cuda`` unless another is given. Rank 0 alone prints, writes
metrics and samples and saves checkpoints; every save is followed by a
barrier, and the SIGTERM flag is max-reduced over the ranks before each
save decision, so that no rank waits in a collective another skipped.
Without a group the run is one rank.

With ``mesh.model`` > 1 the ranks form a ``(data, model)`` mesh
(``parallel/tp.py``): every rank builds the whole state from the seed and
keeps its channel shard; the ranks of one data index read the same rows
(the data pipeline's host is the data index, of ``mesh.data`` hosts); every
save and every held-out rollout gathers the shards over each model group
first, so that rank 0 writes the one-rank checkpoint format, which a
one-rank run, ``serve --workdir`` and ``Predictor.from_checkpoint`` read
unchanged; a resume reads the whole state on every rank and keeps the
shard. The SIGTERM max-reduce and the barriers run over the whole world.
The reference forces ``backend=xla`` on a model axis (GSPMD cannot
partition ``pallas_call``); the port routes each shard through
``ops/api.py`` like any layer, so kernels 1-4 run on the shards.
"""

from __future__ import annotations

import math
import os
import signal
from typing import Optional

import torch

from action_conditioned_gans_tpu_torch.config import Config
from action_conditioned_gans_tpu_torch.data import make_dataset
from action_conditioned_gans_tpu_torch.parallel import comm
from action_conditioned_gans_tpu_torch.parallel.dp import make_dp_train_step
from action_conditioned_gans_tpu_torch.parallel.mesh import make_mesh
from action_conditioned_gans_tpu_torch.parallel.tp import place_state, whole_generator, whole_state
from action_conditioned_gans_tpu_torch.train.state import (
    TrainState,
    init_state,
    lr_value,
    param_count,
    restore_state,
    state_to_host,
)
from action_conditioned_gans_tpu_torch.utils.checkpoint import CheckpointManager
from action_conditioned_gans_tpu_torch.utils.metrics import MetricWriter


def crossed(before: int, after: int, every: int) -> bool:
    """Whether a call that took the step count from ``before`` to ``after``
    passed a multiple of ``every``."""
    return every > 0 and (after // every) > (before // every)


def sync_device(device: torch.device) -> None:
    """Wait for ``device``'s queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(
    cfg: Config,
    max_steps: Optional[int] = None,
    resume: bool = True,
    workdir: Optional[str] = None,
    profile_steps: int = 0,
    device=None,
) -> TrainState:
    """Train ``cfg`` to ``max_steps`` (``train.total_steps`` when None) in
    ``workdir`` (``cfg.workdir`` when None), resuming from its latest
    checkpoint unless ``resume`` is False. ``profile_steps`` > 0 writes a
    ``torch.profiler`` chrome trace of that many steps, after a warm-up, to
    ``<workdir>/profile`` (rank 0's). Returns the final state (this rank's
    shard of it on a mesh with a model axis)."""
    mesh = make_mesh(cfg.mesh, device=device)
    dev, lead = mesh.device, mesh.rank == 0
    workdir = workdir or cfg.workdir
    os.makedirs(workdir, exist_ok=True)
    t = cfg.train
    total = max_steps if max_steps is not None else t.total_steps

    def say(msg: str) -> None:
        if lead:
            print(msg, flush=True)

    whole = init_state(cfg, torch.Generator().manual_seed(t.seed), device=dev)
    # The step's draws come from seed + 1 and the step number: the key the
    # JAX loop passes (PRNGKey(seed + 1), folded with the step).
    step_fn = make_dp_train_step(cfg, mesh, seed=t.seed + 1)
    g_n, d_n = param_count(whole)
    say(f"[acgan] {cfg.name}: G params {g_n:,} | D params {d_n:,} | device {dev} | "
        f"mesh data={mesh.data}" + (f" model={mesh.model}" if mesh.model > 1 else ""))
    if mesh.model > 1:
        say(f"[acgan] model-parallel mesh: conv channels sharded over model={mesh.model}; each "
            "shard keeps its kernel route (the reference forces backend=xla here: GSPMD cannot "
            "partition pallas_call)")

    ckpt = CheckpointManager(os.path.join(workdir, "checkpoints"), keep=t.checkpoint_keep)
    start = 0
    if resume and ckpt.latest_step() is not None:
        whole = restore_state(cfg, ckpt, template=whole)
        start = whole.step
        say(f"[acgan] resumed from checkpoint at step {start}")
    state = place_state(whole, mesh)
    del whole

    def save(step: int) -> None:
        """Rank 0 writes ``step`` (the state gathered over each model group,
        every rank taking part); every rank then waits for the write."""
        full = whole_state(state, cfg, mesh)
        if lead:
            ckpt.save(step, state_to_host(full, cfg))
        if mesh.group is not None:
            comm.barrier(mesh.group, dev)

    k = max(t.steps_per_call, 1)
    dataset = make_dataset(cfg, stack=k, start_call=start // k, device=dev,
                           host_id=mesh.data_index, num_hosts=mesh.data)
    writer = MetricWriter(os.path.join(workdir, "tb") if lead else None, echo=lead)

    # SIGTERM (preemption) only sets a flag; the loop checkpoints and exits
    # after the call in flight.
    preempted = {"flag": False}

    def _on_sigterm(signum, frame):
        preempted["flag"] = True

    prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)

    # One fixed held-out batch, seeded apart from the training stream, so the
    # eval scalars move only with the model.
    sample_fn = held_out = None

    def write_samples(step_idx: int, g_params, g_ema) -> None:
        nonlocal sample_fn, held_out
        from action_conditioned_gans_tpu_torch.train.sample import (
            eval_metrics,
            held_out_batches,
            make_rollout_fn,
        )

        if sample_fn is None:
            sample_fn = make_rollout_fn(cfg, dev)
            # One batch is kept; the stream is closed at once, which stops a
            # file reader's fill thread.
            stream = held_out_batches(cfg, min(8, t.batch_size), max(t.rollout_length, 1),
                                      t.seed + 7919, device=dev)
            try:
                held_out = next(stream)
            finally:
                stream.close()
        preds = sample_fn(g_params, held_out)
        em = eval_metrics(preds, held_out["frames"][:, 1:])
        if g_ema is not None:
            # The EMA weights too: the set a served model would use.
            ema_preds = sample_fn(g_ema, held_out)
            em.update({f"{k}_ema": v
                       for k, v in eval_metrics(ema_preds, held_out["frames"][:, 1:]).items()})
            writer.write_images(step_idx, "pred_final_frame_ema",
                                ema_preds[:, -1].float().cpu().numpy())
        writer.write(step_idx, em)
        writer.write_images(step_idx, "pred_final_frame", preds[:, -1].float().cpu().numpy())
        writer.write_images(step_idx, "gt_final_frame",
                            held_out["frames"][:, -1].float().cpu().numpy())

    # The trace window opens and closes at call boundaries, after a warm-up of
    # three calls, clamped so that a short run still traces one call.
    profile_start = -1
    if profile_steps > 0 and total > start and lead:
        last_call_top = start + ((total - start - 1) // k) * k
        warmup = 3 * k
        if start + warmup > last_call_top:
            warmup = last_call_top - start
            say(f"[acgan] profile warmup clamped to {warmup} step(s): the run is too short "
                f"for the 3x{k}-step warmup; expect warm-up noise in the trace (raise "
                "--steps or lower train.steps_per_call for a clean window)")
        profile_start = start + warmup
    profile_stop = -1
    profiler = None
    tracedir = os.path.join(workdir, "profile")

    def stop_trace(note: str = "") -> None:
        nonlocal profiler
        sync_device(dev)
        profiler.stop()
        path = os.path.join(tracedir, f"trace_step{done}.json")
        profiler.export_chrome_trace(path)
        profiler = None
        print(f"[acgan] trace captured{note} -> {path}", flush=True)

    schedule_on = not (t.warmup_steps == 0 and t.lr_schedule == "constant")

    def lr_metrics(step_done: int) -> dict:
        """The learning rates of the call's last step, when a schedule is on."""
        if not schedule_on:
            return {}
        return {"g_lr": lr_value(t, t.g_lr, step_done - 1),
                "d_lr": lr_value(t, t.d_lr, step_done - 1)}

    call = start // k
    done = start
    try:
        while done < total:
            if profile_start >= 0 and done >= profile_start:
                os.makedirs(tracedir, exist_ok=True)
                print(f"[acgan] capturing {profile_steps}-step trace -> {tracedir}", flush=True)
                sync_device(dev)
                activities = [torch.profiler.ProfilerActivity.CPU]
                if dev.type == "cuda":
                    activities.append(torch.profiler.ProfilerActivity.CUDA)
                # Shapes too: profile-report reckons the kernels' rooflines from them.
                profiler = torch.profiler.profile(activities=activities, record_shapes=True)
                profiler.start()
                profile_start, profile_stop = -1, done + profile_steps
            if profile_stop >= 0 and done >= profile_stop:
                stop_trace()
                profile_stop = -1
            batch = dataset.batch_at(call)
            # The step's own spans name the call and its steps in the trace.
            state, metrics = step_fn(state, batch)
            before, done = done, done + k
            call += 1
            if crossed(before, done, t.log_every) or before == start:
                # The metrics are the ranks' means: every rank checks them.
                values = {k_: float(v) for k_, v in metrics.items()}
                if t.debug_nans and not all(math.isfinite(v) for v in values.values()):
                    raise FloatingPointError(f"non-finite metrics at step {done}: {values}")
                writer.write(done, {**values, **lr_metrics(done)})
            writer.tick()
            if crossed(before, done, t.checkpoint_every):
                save(done)
            if crossed(before, done, t.sample_every):
                # G whole (gathered over each model group on a model axis).
                g_params = whole_generator(state.g_params, cfg, mesh)
                g_ema = (None if state.g_ema is None
                         else whole_generator(state.g_ema, cfg, mesh))
                if lead:
                    write_samples(done, g_params, g_ema)
            stop = preempted["flag"]
            if mesh.group is not None:  # every rank takes the same branch
                stop = comm.any_rank(stop, mesh.group, dev)
            if stop:
                say(f"[acgan] SIGTERM received: checkpointing at step {done} and exiting")
                # A step just saved on a checkpoint_every boundary is not saved
                # again: the save returns False.
                save(done)
                break
        total = done
    finally:
        signal.signal(signal.SIGTERM, prev_handler)
        writer.close()
        close = getattr(dataset, "close", None)
        if close is not None:  # a file source's fill thread
            close()
        if profiler is not None:
            # The window can still be open at exit (profile_stop past the end,
            # SIGTERM, an error): flush it rather than drop it.
            stop_trace(" (flushed at loop exit)")

    # Every save so far was followed by a barrier: the ranks see one disk.
    if total > start and ckpt.latest_step() != total:
        save(total)
    ckpt.wait()
    p50 = writer.p50_latency()
    if p50:
        # The global batch's frames, per device.
        fps = writer.frames_per_sec(t.batch_size * max(t.rollout_length, 1) * k,
                                    num_chips=mesh.world)
        # Ticks follow the host's calls, which return before the device is
        # done: a dispatch cadence, not a device step time.
        say(f"[acgan] p50 dispatch cadence {p50 * 1e3:.2f} ms ({k} step(s)/call) | "
            f"~{fps:.1f} frames/sec/chip (dispatch-cadence estimate; use `bench` for "
            "timed windows that end in a synchronize)")
    stats = getattr(dataset, "stats", None)
    if stats and stats["batches"]:
        n, filled = stats["batches"], max(stats["filled"], 1)
        # The file source's host side, per call: the fill thread's time in
        # the reader (parse, stack, cast, pin, copy) and the loop's wait on
        # the queue.
        say(f"[acgan] file data per call: fill {stats['fill_s'] * 1e3 / filled:.2f} ms | wait "
            f"{stats['wait_s'] * 1e3 / n:.2f} ms | {n} calls")
    return state
