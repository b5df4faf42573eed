"""setup_s: from the process's start to the window's opening, by the
host's clock: imports, the card's context, loading (and in a fresh
checkout building) the kernels, making the drive, and the warm-up frames."""

LAYER = "end to end"
UNIT = "s"
SOURCE = "host_clock"
BETTER = "lower"


def read(run):
    return run.setup_s
