"""device_idle_pct: the share of the traced stretch of replayed frames in
which no operation ran on the card: 100 (1 - busy / wall), busy the union
of the device operations' intervals in the `torch.profiler` trace."""

LAYER = "device (H100)"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "lower"
MOVES = "frames_per_s"


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
