"""align_iters_per_frame: `FrameOutput.icp_iterations` summed over the
window's frames, per frame (each pass's bootstrap frame, which registers
nothing, included)."""

LAYER = "registration (core/svn.py align loop, runtime/pipeline.py step)"
UNIT = "iters/frame"
SOURCE = "program_counter"
BETTER = "lower"
MOVES = "latency_ms_p95"


def read(run):
    frames = run.window.frames
    if not frames:
        return None
    return sum(f.iterations for f in frames) / len(frames)
