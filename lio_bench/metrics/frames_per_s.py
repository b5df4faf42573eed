"""frames_per_s: every frame whose pose reached the host in the window
(each pass's bootstrap frame included), over the window's wall time, by
the host's clock. A replay user's throughput."""

LAYER = "end to end"
UNIT = "frames/s"
SOURCE = "host_clock"
BETTER = "higher"


def read(run):
    done = sum(1 for f in run.window.frames if f.arrived)
    return done / run.window.seconds
