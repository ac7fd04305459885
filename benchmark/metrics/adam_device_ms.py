"""Device milliseconds a training step spends in its optimizers: the
phases ``step.d_adam`` (D's Adam) and ``step.g_adam`` (G's Adam and the EMA)
of the program's ``step`` span, by their CUDA events, the median over the
steps it timed (``benchmark/program_spans.py``)."""

from benchmark import program_spans as ps


def read(run):
    return ps.median_per_unit(run, ps.timed("step"),
                              lambda root, unit: ps.device_ms(unit, "step.d_adam", "step.g_adam"))
