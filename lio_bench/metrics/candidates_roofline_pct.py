"""candidates_roofline_pct: stage 1's share of its roofline over the
traced stretch: the least time an H100 could take for the (source, target)
pairs stage 1 needs, over the device time of the launches named in KERNELS
(B1: the target prep and the search).

The work is counted from each call's own operands, as the kernel table's
B1 rule counts it (PERF.md, `chip_smoke.time_stage1`): 8 operations per
pair of a valid source row and a valid target row for the score
|c|^2 - 2 s.c and its minimum, so the target's padding rows, which the
kernel scores too, count as no work; bytes: each source row's 3 floats and
mask byte, each target row's 3 floats and mask byte, and k slots of a point
and a distance (16 bytes) written per source row. Bound = max(operations /
67 TFLOP/s, bytes / 3.35 TB/s) (harness/peaks.py). The probe keeps each
stage-1 call's valid counts as device tensors (no read-back inside the
stretch) and its shapes, and records the program's spans and counters
(`runtime/profiling.py` `tracing()`); a program without the stage-1
counter `svnicp.candidates.scores`, or a stretch with no B1 launch (the
CPU), reads nothing."""

import contextlib

from lio_bench.harness import peaks

LAYER = "kernels (kernels/nn.py stage 1, csrc/stage1.cu)"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "higher"
MOVES = "latency_ms_p95"
KERNELS = ("stage1_prep_kernel", "stage1_kernel")
SCORES = "svnicp.candidates.scores"


@contextlib.contextmanager
def probe(state, cfg):
    from svnicp_tpu_torch.kernels import knn
    from svnicp_tpu_torch.runtime import profiling

    if not hasattr(profiling, "tracing"):
        yield
        return
    # the stage-1 entry, not B1's wrapper: the wrapper counts its launches
    # on the module's own function object
    orig = knn.find_candidate_points
    calls = state.setdefault("calls", [])

    def counted(icp, source_at_guess, target, source_valid, target_valid):
        calls.append((source_valid.sum(), target_valid.sum(), source_at_guess.shape[0],
                      target.shape[0], icp.knn_count))
        return orig(icp, source_at_guess, target, source_valid, target_valid)

    knn.find_candidate_points = counted
    try:
        with profiling.tracing() as trace:
            yield
    finally:
        knn.find_candidate_points = orig
    state["trace"] = trace


def bound_s(n_src: int, n_tgt: int, b: int, nt: int, k: int) -> float:
    """The least time of one stage-1 call: `n_src` of `b` source rows and
    `n_tgt` of `nt` target rows valid, k slots a source row."""
    nbytes = b * (3 * 4 + 1 + k * 16) + nt * (3 * 4 + 1)
    flops = 8.0 * n_src * n_tgt
    return max(flops / peaks.FP32_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)


def read(run):
    st, t = run.probes.get("candidates_roofline_pct", {}), run.trace
    trace = st.get("trace")
    if trace is None or t is None or not trace.counters.get(SCORES):
        return None
    if not st.get("calls"):
        return None
    device_s = sum(s for name, s in t.kernel_s.items()
                   if any(k in name for k in KERNELS))
    if device_s <= 0:
        return None
    need = sum(bound_s(int(n_src), int(n_tgt), b, nt, k)
               for n_src, n_tgt, b, nt, k in st["calls"])
    return 100.0 * need / device_s
