"""The whole unit's share of the card's dense bf16 peak over the untraced
window: the model FLOPs of a unit (a training step, ``flops.step_flops``
with the remat recompute left out; a request, the generator's forward at
its batch times its horizon) times the units completed, over the window's
seconds. Serves ``mfu.<suffix>`` for every suffix."""

from benchmark import flops


def read(run):
    if not run.window_s or not run.units:
        return None
    return 100 * run.flops_per_unit * run.units / run.window_s / flops.PEAK_BF16_FLOPS
