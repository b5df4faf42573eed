"""moments_roofline_pct: the point-moments function's share of its
roofline over the traced stretch: the least time an H100 could take for
the work these inputs need, over the device time of the launches named in
KERNELS.

The work is counted from each frame's own shapes, whatever implements it
(the kernel table's rule in PERF.md): for each iteration, P particles
against the frame's live source rows and their valid stage-1 candidate
slots; 8 operations per (particle, slot) for the score |c|^2 - 2 c.(T s),
15 + 150 per (particle, live row) for T s, the tie average, residual,
weight and moments, 5 per slot once; bytes: a mask byte per row, per live
row k candidate slots of 3 floats and a validity byte and its 3 source
floats, the particles read and H and b written. Bound = max(operations /
67 TFLOP/s, bytes / 3.35 TB/s) (harness/peaks.py). The probe counts the
live rows and slots where the frame's operands are prepared
(`kernels.nn.prepare_moments_point`) and the launches between two
preparations (`point_moments.launches`)."""

import contextlib

from lio_bench.harness import peaks

LAYER = "kernels (kernels/nn.py point moments, csrc/point_moments.cu)"
UNIT = "%"
SOURCE = "device_trace"
BETTER = "higher"
MOVES = "latency_ms_p95"
KERNELS = ("point_moments_kernel", "point_system_kernel")


@contextlib.contextmanager
def probe(state, cfg):
    import torch

    from svnicp_tpu_torch.kernels import nn

    orig = nn.prepare_moments_point
    preps = state.setdefault("preps", [])

    def counted(feat, bias, cand_pts, source, src_valid):
        preps.append(((torch.isfinite(bias) & src_valid[:, None]).sum(),
                      src_valid.sum(), bias.shape[0], nn.point_moments.launches))
        return orig(feat, bias, cand_pts, source, src_valid)

    nn.prepare_moments_point = counted
    try:
        yield
    finally:
        nn.prepare_moments_point = orig
        state["launches_end"] = nn.point_moments.launches
        state["particles"] = cfg.icp.particle_count
        state["k"] = cfg.icp.knn_count


def bound_s(p: int, k: int, b: int, n_pts: int, n_slots: int) -> float:
    nbytes = b + n_pts * (k * (3 * 4 + 1) + 3 * 4) + p * (12 + 42) * 4
    flops = p * (8.0 * n_slots + (15.0 + 150.0) * n_pts) + 5.0 * n_slots
    return max(flops / peaks.FP32_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)


def read(run):
    st, t = run.probes.get("moments_roofline_pct"), run.trace
    if not st or not st.get("preps") or t is None:
        return None
    device_s = sum(s for name, s in t.kernel_s.items()
                   if any(k in name for k in KERNELS))
    if device_s <= 0:
        return None
    preps = st["preps"]
    ends = [c for *_, c in preps[1:]] + [st["launches_end"]]
    need = 0.0
    for (slots, pts, b, start), end in zip(preps, ends):
        need += (end - start) * bound_s(st["particles"], st["k"], b, int(pts), int(slots))
    return 100.0 * need / device_s
