"""Profiling hooks (port of the JAX package's ``utils/profiling.py``).

``trace`` wraps steps in a ``torch.profiler`` trace written as a chrome
trace into a log directory (``utils/trace_report.py`` reads it, as
``train --profile-steps`` writes it); ``annotate`` names a host region in
that trace; ``StepTimer`` times blocks that end in a device synchronise.
The JAX package's ``analytic_matmul_cost`` (FLOPs from a jaxpr) has its
counterpart in ``bench.step_flop_counts``, which counts a step's conv and
matmul FLOPs with ``torch.utils.flop_counter`` on meta tensors.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, List, Optional

import torch

from action_conditioned_gans_tpu_torch.config import resolve_device


@contextlib.contextmanager
def trace(logdir: str, device=None) -> Iterator[None]:
    """A device trace of the enclosed steps, as ``<logdir>/trace.json``:

        with profiling.trace("/tmp/trace"):
            for _ in range(10):
                state, m = step(state, batch)

    ``device`` (cuda unless another is given) is synchronised before the
    trace closes. View it in Perfetto or ``chrome://tracing``, or summarise
    it with ``profile-report``."""
    os.makedirs(logdir, exist_ok=True)
    dev = resolve_device(device)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """A named host region, a span in the trace's timeline
    (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock times of blocks, each ended by a synchronise of ``device``
    (a CUDA device runs ahead of the host) for measurements outside
    ``bench``."""

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else None
        self.samples: List[float] = []

    @contextlib.contextmanager
    def measure(self) -> Iterator[None]:
        t0 = time.perf_counter()
        yield
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.samples.append(time.perf_counter() - t0)

    def p50(self) -> Optional[float]:
        if not self.samples:
            return None
        xs = sorted(self.samples)
        return xs[len(xs) // 2]
