"""device_idle_pct.live: the share of the traced live frames' own time in
which no operation ran on the card: 100 (1 - busy / wall) inside each
frame's span, from handing the scan over to its pose and var_icp read
back, so the waits between 10 Hz scans are left out. It follows the
latency a frame has (a frame the host holds up longer idles more), not
the sensor's rate."""

LAYER = "device (H100)"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "latency_ms_p95"


def read(run):
    t = run.trace
    if t is None or t.frame_s <= 0 or t.frame_busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.frame_busy_s / t.frame_s)
