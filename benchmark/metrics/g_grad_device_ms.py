"""Device milliseconds a training step spends in G's gradient: G's head on the
frozen D, then the backward through the rollout, remat's recompute included
(``step.g_grad``), by the phase's CUDA events in the program's ``step``
span, the median over the steps it timed (``benchmark/program_spans.py``)."""

from benchmark import program_spans as ps


def read(run):
    return ps.median_per_unit(run, ps.timed("step"),
                              lambda root, unit: ps.device_ms(unit, "step.g_grad"))
