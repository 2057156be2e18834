"""Mrays/s: the rays of every call completed in the window over the
window's wall time (host clock)."""


def read(run):
    return run.calls * run.rays_per_call / run.window_s / 1e6
