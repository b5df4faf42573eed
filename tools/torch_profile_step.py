"""Device-time breakdown of the port's bench operating point on the card.

Runs `svnicp_tpu_torch.bench`'s operating point (its `build`, 64 particles,
the kernel route) for 3 warm-up frames and then `--frames` steady-state
frames under `torch.profiler`, and prints the top device operations by
total time, the same grouped by a coarse stage rule under the port's
kernel names, and the device's busy and idle share of the traced window
(the counterpart of the JAX package's `tools/profile_step.py`):

    python3 tools/torch_profile_step.py [--frames 8] [--residual point_to_plane]
        [--method bucketed] [--top 30] [--keep trace.json] [--device cpu]

With `--keep` the trace is also written as a Chrome trace. On the CPU
(`--device cpu`) the same tables list the CPU operators.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# (substring of the operation's name, group), first match wins: the port's
# kernels by their CUDA function names, then torch's own operations
STAGES = [
    ("stage1", "B1 stage-1 candidates"),
    ("plane_moments", "B2 plane moments"),
    ("plane_system", "B2 plane moments"),
    ("point_moments", "B4 point moments"),
    ("point_system", "B4 point moments"),
    ("nn_match", "B5 nn match"),
    ("stein_kernel", "B3 stein update"),
    ("cummax", "map run broadcasts (cummax)"),
    ("scan_innermost_dim_with_indices", "map run broadcasts (cummax)"),
    ("sort", "map/query sorts"),
    ("gemm", "matmuls"),
    ("matmul", "matmuls"),
    ("bmm", "matmuls"),
    ("memcpy", "copies"),
    ("copy", "copies"),
    ("reduce", "reductions"),
    ("sum", "reductions"),
    ("elementwise", "elementwise"),
    ("fill", "fills"),
]


def group(totals: dict) -> collections.Counter:
    """Total time by STAGES group of {operation name: time}."""
    groups = collections.Counter()
    for name, t in totals.items():
        low = name.lower()
        groups[next((label for key, label in STAGES if key in low), "other")] += t
    return groups


def op_table(prof, device_type) -> tuple[dict, dict]:
    """({name: self time [us]}, {name: count}) of the trace's operations that
    ran on `device_type` (CUDA kernels, or CPU operators)."""
    totals, counts = {}, {}
    for e in prof.key_averages():
        if e.device_type != device_type:
            continue
        t = (e.self_device_time_total if device_type.name == "CUDA"
             else e.self_cpu_time_total)
        if t > 0:
            totals[e.key] = t
            counts[e.key] = e.count
    return totals, counts


def report(totals: dict, counts: dict, frames: int, wall_s: float, top: int) -> None:
    total = sum(totals.values())
    print(f"\ntotal {total / 1e3 / frames:.3f} ms/frame over {frames} frames; "
          f"busy {100 * total / 1e6 / wall_s:.1f}% of {wall_s * 1e3:.1f} ms wall, "
          f"idle {100 * (1 - total / 1e6 / wall_s):.1f}%\n")
    print(f"{'op':<72} {'ms/frame':>9} {'n/frame':>8} {'%':>6}")
    for name, t in sorted(totals.items(), key=lambda kv: -kv[1])[:top]:
        print(f"{name[:72]:<72} {t / 1e3 / frames:9.3f} {counts[name] / frames:8.1f} "
              f"{100 * t / total:5.1f}%")
    print("\nby group:")
    for label, t in group(totals).most_common():
        print(f"  {label:<30} {t / 1e3 / frames:8.3f} ms/frame {100 * t / total:5.1f}%")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--residual", default="point_to_plane")
    ap.add_argument("--method", default="bucketed")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--keep", default="", help="write the Chrome trace here")
    ap.add_argument("--device", default=None, help="cpu for the plain versions")
    args = ap.parse_args(argv)

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from svnicp_tpu_torch import bench

    warm = 3
    pipe, times, scans = bench.build(warm + args.frames, particles=64, use_pallas=True,
                                     candidate_method=args.method,
                                     residual=args.residual, device=args.device)
    cuda = pipe.device.type == "cuda"

    def sync(out):
        out.pose_t.cpu()
        if cuda:
            torch.cuda.synchronize()

    out = None
    for i in range(warm):
        out = pipe.feed_scan(float(times[i]), scans[i]) or out
    sync(pipe.flush() or out)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for i in range(warm, warm + args.frames):
            out = pipe.feed_scan(float(times[i]), scans[i]) or out
        sync(pipe.flush() or out)
        wall = time.perf_counter() - t0
    pipe.close()
    iters = sum(int(o.icp_iterations) for o in pipe.outputs[warm:])
    where = bench.nvidia_smi_line() if cuda else "cpu"
    print(f"{args.frames} frames, {iters} align iterations, {wall * 1e3:.1f} ms wall "
          f"[{where}]")
    totals, counts = op_table(prof, DeviceType.CUDA if cuda else DeviceType.CPU)
    report(totals, counts, args.frames, wall, args.top)
    if args.keep:
        prof.export_chrome_trace(args.keep)
    return dict(totals=totals, counts=counts, groups=group(totals), wall_s=wall,
                iterations=iters)


if __name__ == "__main__":
    main()
