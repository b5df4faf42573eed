"""latency_ms_p95: the 95th percentile, over every scan due in the live
window, of the time from the scan's due time to its pose and var_icp on
the host, by the host's clock: what a robot feels from scan to pose,
including any wait behind the frame before. A frame whose pose never came
counts as infinitely late."""

import math

import numpy as np

LAYER = "end to end"
UNIT = "ms"
SOURCE = "host_clock"
BETTER = "lower"


def read(run):
    ms = [(f.t_done - f.due) * 1e3 if f.arrived else math.inf
          for f in run.window.frames if f.due is not None]
    return float(np.percentile(ms, 95)) if ms else None
