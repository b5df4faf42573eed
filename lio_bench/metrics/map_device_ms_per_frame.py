"""map_device_ms_per_frame: the map's time on the card per frame: the
device intervals (a CUDA event pair on the stream at each end, so the
device's own clock) of the program's `svnicp.map.query` spans (the radius
query that cuts the target, `voxmap.query_radius`) and `svnicp.map.insert`
spans (`voxmap.insert`): their sorts, and the binary searches on the
sorted keys (`torch.searchsorted`) that find each row's voxel run and each
queried voxel's rows. Summed over the traced stretch and divided by its
frames (`svnicp.frame` spans). An interval
counts from the stream reaching the layer's first operation to its last,
so it holds any wait of the card for the host inside the layer. The probe
records the program's spans (`runtime/profiling.py` `tracing()`); on the
CPU, or in a program without them, it reads nothing."""

import contextlib

LAYER = "map (core/voxmap.py query_radius, insert)"
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
    trace = run.probes.get("map_device_ms_per_frame", {}).get("trace")
    frames = trace.named("svnicp.frame") if trace is not None else []
    spans = [s for s in trace.spans if s.name in (
        "svnicp.map.query", "svnicp.map.insert")] if frames else []
    if not spans or any(s.device_ms is None for s in spans):
        return None
    return sum(s.device_ms for s in spans) / len(frames)
