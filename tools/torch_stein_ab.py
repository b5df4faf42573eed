"""The Stein-update kernel (B3) on and off at the reference's particle
counts, on the card.

Runs `svnicp_tpu_torch.bench`'s `build` operating point (its own default,
point-to-point: kernels B1, B4 and B3, or B1, B4 and the plain Stein
update with `stein_kernel` off) at each of `--particles`, the two settings
alternating in one process with the order swapped every rep (a fresh
pipeline each run; only back-to-back comparisons mean anything), and
prints one JSON line per particle count with every run's frames/s and the
medians (the counterpart of the JAX package's `tools/stein_ab.py`):

    python3 tools/torch_stein_ab.py [--particles 10,30] [--reps 3] [--frames 23]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure(pipe, times, scans, warmup=3) -> float:
    """Frames/s of the frames after `warmup`, closed by reading the last
    pose to the host."""
    out = None
    for i in range(warmup):
        out = pipe.feed_scan(float(times[i]), scans[i]) or out
    (pipe.flush() or out).pose_t.cpu()
    t0 = time.perf_counter()
    for i in range(warmup, len(scans)):
        out = pipe.feed_scan(float(times[i]), scans[i]) or out
    (pipe.flush() or out).pose_t.cpu()
    fps = (len(scans) - warmup) / (time.perf_counter() - t0)
    pipe.close()
    return fps


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--particles", default="10,30")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--frames", type=int, default=23)
    ap.add_argument("--device", default=None, help="cpu for the plain versions")
    args = ap.parse_args(argv)

    from svnicp_tpu_torch import bench
    from svnicp_tpu_torch.runtime import pipeline as pl

    times, _, _, scans = bench.sequence(args.frames)
    lines = []
    for p in (int(x) for x in args.particles.split(",")):
        cfgs = {stein: bench.pipeline_config(p, use_pallas=True, stein_kernel=stein)
                for stein in (True, False)}
        samples = {True: [], False: []}
        for rep in range(args.reps):
            for stein in ((True, False) if rep % 2 == 0 else (False, True)):
                pipe = pl.LIOPipeline(cfgs[stein], device=args.device)
                samples[stein].append(measure(pipe, times, scans))
                device = pipe.device
        line = {
            "particles": p,
            "kernel_on": [round(s, 2) for s in samples[True]],
            "kernel_off": [round(s, 2) for s in samples[False]],
            "median_on": round(float(np.median(samples[True])), 2),
            "median_off": round(float(np.median(samples[False])), 2),
            "device": bench.nvidia_smi_line() if device.type == "cuda" else "cpu",
        }
        print(json.dumps(line), flush=True)
        lines.append(line)
    return lines


if __name__ == "__main__":
    main()
