"""The hand-written kernels' share of their bandwidth roofline, %: the
least bytes of the query (``least_bytes.query_bytes``) at the card's
published HBM rate, over the kernels' device time per call. Bytes bound
it: no count of ray-primitive tests free of the implementation exists."""
from rtbench import peaks, trace


def read(run):
    peak = peaks.PEAKS.get(run.device_kind)
    if run.trace is None or peak is None:
        return None
    s = trace.device_s(run.trace, torch_ops=False) / run.calls
    if s <= 0:
        return None
    return run.least_bytes / peak["hbm_bytes_per_s"] / s * 100
