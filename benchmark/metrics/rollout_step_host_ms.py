"""Host milliseconds a rollout step takes to dispatch: the program's
``rollout.steps`` span (``infer.rollout_scan``'s T generator calls and the
feedback casts) over the request's T, the median over requests
(``benchmark/program_spans.py``)."""

from benchmark import program_spans as ps


def read(run):
    return ps.median_per_unit(
        run, ps.named("rollout"),
        lambda root, unit: ps.host_ms(unit, "rollout.steps") / max(root.attrs.get("T", 1), 1))
