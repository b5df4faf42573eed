"""frame_ms_p95: the 95th percentile, over every frame of the window, of
the time from handing the scan to `feed_scan` to its pose and var_icp on
the host, by the host's clock. A frame whose pose never came counts as
infinitely late."""

import math

import numpy as np

LAYER = "end to end"
UNIT = "ms"
SOURCE = "host_clock"
BETTER = "lower"


def read(run):
    ms = [(f.t_done - f.t_feed) * 1e3 if f.arrived else math.inf for f in run.window.frames]
    return float(np.percentile(ms, 95)) if ms else None
