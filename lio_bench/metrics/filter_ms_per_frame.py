"""filter_ms_per_frame: the host's wall time in the error-state Kalman
filter per frame: the program's `svnicp.filter.predict` spans (the
propagation over the frame's IMU window, `pipeline._imu_scan_predict`, a
string of small device operations per sample) and `svnicp.filter.update`
spans (`pipeline._kf_update`), summed over the traced stretch and divided
by its frames (`svnicp.frame` spans). The probe records the program's
spans (`runtime/profiling.py` `tracing()`); a program without them reads
nothing."""

import contextlib

LAYER = "filter (core/eskf.py, pipeline._imu_scan_predict, _kf_update)"
UNIT = "ms"
SOURCE = "program_span"
BETTER = "lower"
MOVES = "latency_ms_p95"


@contextlib.contextmanager
def probe(state, cfg):
    from svnicp_tpu_torch.runtime import profiling

    if not hasattr(profiling, "tracing"):
        yield
        return
    with profiling.tracing() as trace:
        yield
    state["trace"] = trace


def read(run):
    trace = run.probes.get("filter_ms_per_frame", {}).get("trace")
    frames = trace.named("svnicp.frame") if trace is not None else []
    spans = [s for s in trace.spans if s.name in (
        "svnicp.filter.predict", "svnicp.filter.update")] if frames else []
    if not spans:
        return None
    return 1e-6 * sum(s.ns for s in spans) / len(frames)
