"""Device ops (kernels, copies, sets) in the traced window per call."""


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return len(run.trace.device) / run.calls
