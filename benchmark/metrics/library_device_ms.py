"""Device milliseconds a unit (a step or a request) of cuDNN's, cuBLAS's and
torch's kernels, copies and memsets: everything on the device but the
port's own kernels, over the traced stretch. Serves
``library_device_ms.<suffix>`` for every suffix."""


def read(run):
    if run.trace is None or not run.stretch_units:
        return None
    return 1e3 * run.trace.library_s / run.stretch_units
