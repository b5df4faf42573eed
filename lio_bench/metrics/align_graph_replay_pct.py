"""align_graph_replay_pct: the share of the align loop's rounds
(`core/svn.py` `align`: m passes, then one read of the stop flags) that
the host ran as one launch of a captured CUDA graph, over the traced
stretch: 100 x `svnicp.align.graph_replays` / (`graph_replays` +
`svnicp.align.eager_rounds`), the program's own counters of the rounds it
replayed and of those it issued op by op. 100 where every round of the
stretch skipped the host's per-pass launches. The probe records the
program's counters (`runtime/profiling.py` `tracing()`); a program that
counts neither kind of round reads nothing."""

import contextlib

LAYER = "registration (core/svn.py align loop, runtime/pipeline.py step)"
UNIT = "%"
SOURCE = "program_counter"
BETTER = "higher"
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
    trace = run.probes.get("align_graph_replay_pct", {}).get("trace")
    if trace is None:
        return None
    replays = trace.counters.get("svnicp.align.graph_replays", 0)
    rounds = replays + trace.counters.get("svnicp.align.eager_rounds", 0)
    if rounds == 0:
        return None
    return 100.0 * replays / rounds
