"""The share of the untraced window in which no kernel, copy or memset ran
on the device: one less the device's busy time a unit (a step or a
request) in the traced stretch, where the profiler leaves device time as it
is, over the window's host seconds a unit, where no profiler lengthens the
host's work. Serves ``device_idle_pct.<suffix>`` for every suffix."""


def read(run):
    if run.trace is None or not run.stretch_units or not run.units or not run.window_s:
        return None
    busy = run.trace.busy_s / run.stretch_units
    return 100 * (1 - busy / (run.window_s / run.units))
