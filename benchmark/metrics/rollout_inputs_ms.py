"""Host milliseconds a request spends placing its numpy inputs on the
device (the program's ``rollout.inputs`` span, ``infer.model_inputs``), the
median over requests (``benchmark/program_spans.py``)."""

from benchmark import program_spans as ps


def read(run):
    return ps.median_per_unit(run, ps.named("rollout"),
                              lambda root, unit: ps.host_ms(unit, "rollout.inputs"))
