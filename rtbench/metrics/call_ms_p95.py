"""The 95th percentile, over every call of the window, of the host-clock
time from issuing the call to the synchronize after it, ms."""
import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.call_s) * 1e3, 95))
