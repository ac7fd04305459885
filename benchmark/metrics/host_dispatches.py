"""Conv blocks the host dispatches a request: the ``dispatches`` of the
program's ``rollout`` span, the change of ``ops.common.conv_blocks()`` (the
sum of ``ROUTES``' "fused", "split" and "plain" counts) over the request,
the median over requests (``benchmark/program_spans.py``)."""

from benchmark import program_spans as ps


def read(run):
    return ps.median_per_unit(run, ps.named("rollout"),
                              lambda root, unit: float(root.attrs.get("dispatches", 0)))
