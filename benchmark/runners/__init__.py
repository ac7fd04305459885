"""What every runner of the benchmark's traffic shares. A traffic mix is a
data file, ``benchmark/traffic/<name>.json``, whose ``kind`` names the
runner module ``benchmark/runners/<kind>.py`` and whose other keys are that
runner's parameters; a cell pairs the mix with a configuration. A runner
module exposes ``run(ctx: Context) -> Run``; a new kind of traffic is a new
module here, found by its name.

Every runner makes its inputs and weights from the seed on the device, sets
the program up and warms every shape the window uses (that is ``setup_s``,
from the process's start), runs the window for the run's seconds, closes it
on a synchronize, traces a short stretch after it when asked, reads the
peak memory, frees the program's state, and only then runs the reference
over what the timed path produced. The host spans it records are its own,
around each call into the program.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Callable, Dict, List, Optional

import torch

from benchmark import inputs, trace_groups


@dataclasses.dataclass
class Context:
    """What a runner is given: the configuration (the file's ``config``),
    the traffic parameters, the run's arguments, the reference module, the
    process's start on the host clock and a directory for the trace."""

    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    started: float
    tmpdir: str
    reference: object
    log: object = None

    def phase(self, what: str) -> None:
        """Print how far into the run ``what`` ended, on the log."""
        if self.log is not None:
            print(f"bench: {what} at {time.perf_counter() - self.started:.3f} s",
                  file=self.log, flush=True)


@dataclasses.dataclass
class Run:
    """What a runner measured, for the result line and the per-layer readers.
    ``units`` are the steps or requests the untraced window completed in
    ``window_s``; ``spans`` the window's host spans by name (seconds each);
    ``stretch_*`` and ``trace`` the traced stretch after the window."""

    kind: str
    setup_s: float
    window_s: float
    units: int
    attempted: int
    failed: int
    frames_per_unit: int
    flops_per_unit: float
    end_to_end: Dict[str, float]
    spans: Dict[str, List[float]]
    memory_peak_bytes: int
    readings: Dict[str, float]
    stretch_units: int = 0
    stretch_s: float = 0.0
    trace: Optional[trace_groups.Summary] = None
    notes: List[str] = dataclasses.field(default_factory=list)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device: torch.device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def free(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.empty_cache()


def traced(ctx: Context, run: Run, issue: Callable[[], int], min_units: int,
           min_seconds: float) -> None:
    """Profile ``issue`` (one call or request, returning its units) twice.
    First over a stretch of at least ``min_units`` units and
    ``min_seconds``, closed by a synchronize, with the device's activity
    alone, so that the profiler adds little host work to a path the host
    may bound: the device's busy time and the device time by group
    (``run.trace``), and the stretch's host-clock seconds, which the
    profiler lengthens (rates are the untraced window's). Then over one
    unit with the host's ops and their shapes too, inside a
    ``bench:stretch`` span: the bounds of kernels 1-4's launches (whose
    device time the profiler does not change) and the idle gaps named by
    the host span they fell in (there the profiler's host work lengthens
    them). Each chrome trace goes to ``ctx.tmpdir`` and is deleted once
    read."""
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = ctx.device.type == "cuda"

    def profiled(shapes: bool, units_at_least: int, seconds_at_least: float):
        acts = ([ProfilerActivity.CPU] if shapes or not cuda else []) + (
            [ProfilerActivity.CUDA] if cuda else [])
        units = 0
        sync(ctx.device)
        with profile(activities=acts, record_shapes=shapes) as prof:
            with record_function("bench:stretch"):
                t0 = time.perf_counter()
                while units < units_at_least or time.perf_counter() - t0 < seconds_at_least:
                    units += issue()
                sync(ctx.device)
                seconds = time.perf_counter() - t0
        path = os.path.join(ctx.tmpdir, f"bench-trace-{os.getpid()}.json")
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                summary = trace_groups.summarize(json.load(f), "bench:stretch" if shapes else None)
        finally:
            if os.path.exists(path):
                os.remove(path)
        if not shapes:
            summary.window_s = seconds
        return units, seconds, summary

    # The profiler has been seen to lose a trace's device events on this
    # card: a stretch that holds none, or no launch of kernels 1-4 where the
    # stretch saw some, is taken again, up to twice.
    for _ in range(3):
        run.stretch_units, run.stretch_s, run.trace = profiled(False, min_units, min_seconds)
        if run.trace.busy_s > 0:
            break
    launched = sum(run.trace.kernels[k]["launches"] for k in trace_groups.ROOFLINE_KERNELS)
    for _ in range(3):
        units, seconds, shaped = profiled(True, 1, 0.0)
        if not launched or any(shaped.kernels[k]["launches"]
                               for k in trace_groups.ROOFLINE_KERNELS):
            break
    run.trace.kernels, run.trace.idle_gaps = shaped.kernels, shaped.idle_gaps
    run.notes.append(f"traced with shapes: {units} units in {seconds:.4f} s")
    if run.window_s and run.stretch_s:
        slower = (run.units / run.window_s) / (run.stretch_units / run.stretch_s) - 1
        run.notes.append(f"profiler overhead: {run.stretch_units} units in {run.stretch_s:.4f} s "
                         f"traced (device activity) against {run.units} in {run.window_s:.4f} s "
                         f"untraced: {100 * slower:.2f}% slower")


def program_spec(cfg):
    """G's and D's parameter names and shapes as the program's models have them."""
    from action_conditioned_gans_tpu_torch.models import Discriminator, Generator

    with torch.device("meta"):
        return ({k: tuple(v.shape) for k, v in Generator(cfg.model).state_dict().items()},
                {k: tuple(v.shape) for k, v in Discriminator(cfg.model).state_dict().items()})


def weights(ctx: Context, cfg, which: str):
    """The seed's weights of G (``which`` "g") or of G and D, after checking
    that the reference's parameters are the program's, name for name."""
    g_spec, d_spec = ctx.reference.param_spec(ctx.cfg["model"])
    prog_g, prog_d = program_spec(cfg)
    for spec, prog in ((g_spec, prog_g), (d_spec, prog_d)):
        if {k: v[0] for k, v in spec.items()} != prog:
            raise RuntimeError("the reference's parameters are not the program's: "
                               f"{sorted(set(spec) ^ set(prog)) or 'shapes differ'}")
    g = inputs.make_params(g_spec, ctx.seed, "g", ctx.device)
    if which == "g":
        return g
    return g, inputs.make_params(d_spec, ctx.seed, "d", ctx.device)
