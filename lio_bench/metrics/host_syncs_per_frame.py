"""host_syncs_per_frame: the times per frame the host waits for the card
by the program's own count: its `svnicp.sync.*` spans (the align loop's
stop statistic each iteration, the degeneracy test, the failure-
containment reads of `align_ok`) and `svnicp.upload` spans (the scan's
rows and the IMU window, pageable copies that block the host), over the
traced stretch's frames (`svnicp.frame` spans). The probe records the
program's spans (`runtime/profiling.py` `tracing()`); a program without
them reads nothing."""

import contextlib

LAYER = "host (runtime/pipeline.py, core/svn.py read-backs)"
UNIT = "syncs/frame"
SOURCE = "program_counter"
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
    trace = run.probes.get("host_syncs_per_frame", {}).get("trace")
    frames = trace.named("svnicp.frame") if trace is not None else []
    if not frames:
        return None
    syncs = sum(1 for s in trace.spans
                if s.name.startswith("svnicp.sync.") or s.name == "svnicp.upload")
    return syncs / len(frames)
