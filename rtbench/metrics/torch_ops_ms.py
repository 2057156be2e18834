"""Device ms per call of PyTorch's own ops (``trace.is_torch_op``): the
wrapper's key, sort, gathers and unsort, and the re-intersection."""
from rtbench import trace


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    s = trace.device_s(run.trace, torch_ops=True)
    return s / run.calls * 1e3 if s > 0 else None
