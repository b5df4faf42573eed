"""align_wait_ms_per_iter: the host's time blocked on the align loop's stop
statistic (`float(stop)` in `core/svn.py` `align`, the program's
`svnicp.sync.stop` spans), summed over the traced stretch and divided by
the passes of the loop (`svnicp.align.iter` spans). Short when the card
has finished a pass before the host reads it, long when the host waits
for the card. The probe records the program's spans
(`runtime/profiling.py` `tracing()`); a program without them reads
nothing."""

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
    trace = run.probes.get("align_wait_ms_per_iter", {}).get("trace")
    iters = trace.named("svnicp.align.iter") if trace is not None else []
    if not iters:
        return None
    return 1e-6 * sum(s.ns for s in trace.named("svnicp.sync.stop")) / len(iters)
