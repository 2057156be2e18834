"""Device ms per call of every device op that is not PyTorch's own: the
port's hand-written kernels."""
from rtbench import trace


def read(run):
    if run.trace is None or not run.trace.device:
        return None
    s = trace.device_s(run.trace, torch_ops=False)
    return s / run.calls * 1e3 if s > 0 else None
