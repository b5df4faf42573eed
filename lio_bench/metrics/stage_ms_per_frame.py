"""stage_ms_per_frame: the mean, over the window's frames, of the
pipeline's own `preprocess` span (`LIOPipeline.frame_timings`,
`runtime/profiling.StageTimer`): on the raw route, the host's extrinsic
transform, range crop and pad of the scan into its upload rows (the
device's downsample stages run inside the step)."""

LAYER = "staging (runtime/ingest.py, io/native.py)"
UNIT = "ms"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "latency_ms_p95"


def read(run):
    frames = run.window.frames
    if not frames:
        return None
    return 1e3 * sum(f.preprocess_s for f in frames) / len(frames)
