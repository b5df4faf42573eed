"""align_launch_ms_per_iter: the host's time issuing one pass of the align
loop (`core/svn.py` `align`: kernel B4, B3 and the update's small
operations), the mean self time of the program's `svnicp.align.iter` spans
over the traced stretch: each pass's wall less its `svnicp.sync.stop`
read-back. The probe records the program's spans (`runtime/profiling.py`
`tracing()`) around the stretch; a program without them reads nothing."""

import contextlib

LAYER = "registration (core/svn.py align loop, runtime/pipeline.py step)"
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
    trace = run.probes.get("align_launch_ms_per_iter", {}).get("trace")
    iters = trace.named("svnicp.align.iter") if trace is not None else []
    if not iters:
        return None
    return 1e-6 * sum(s.self_ns for s in iters) / len(iters)
