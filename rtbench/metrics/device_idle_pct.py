"""Share of the traced window in which no device op runs (the union of the
ops' intervals), %."""
from rtbench import trace


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    return 100 * (1 - trace.busy_s(run.trace) / run.trace.window_s)
