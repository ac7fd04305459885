"""Kernels 1-4's share of their roofline over the traced stretch: the sum of
their launches' bounds (``flops.conv_cost``, ``gn_cost``, ``gn_bwd_cost``)
over the sum of their device time, over the kernels whose every launch was
matched to its shapes (``trace_groups.Summary.roofline_share``). Serves
``acgan_kernels_roofline.<suffix>`` for every suffix."""


def read(run):
    if run.trace is None:
        return None
    share = run.trace.roofline_share()
    return None if share is None else 100 * share
