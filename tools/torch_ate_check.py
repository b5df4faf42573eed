"""ATE and RPE of the port's bench operating point on the card.

Runs the sequence of `svnicp_tpu_torch.bench` (its `build`, 64 particles,
the kernel route) for a candidate method, residual, insert cadence,
segmentation or features, and prints one JSON line with the ATE, the RPE,
the mean align iterations and the mean 6-DoF NEES of the per-frame
correction: the accuracy companion of the bench's frames/s line, and the
counterpart of the JAX package's `tools/ate_check.py`.

    python3 tools/torch_ate_check.py [--method bucketed|topk|voxel]
        [--residual point_to_plane] [--frames 30] [--insert-every 1]
        [--segmentation | --features] [--icp-method svn|svgd|svd]
        [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--method", default="bucketed")
    ap.add_argument("--residual", default="point_to_plane")
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--insert-every", type=int, default=1)
    ap.add_argument("--segmentation", action="store_true",
                    help="HDL-64 raycast scans through range-image segmentation")
    ap.add_argument("--features", action="store_true",
                    help="HDL-64 raycast scans through LOAM-style feature selection")
    ap.add_argument("--icp-method", default="svn", choices=["svn", "svgd", "svd"])
    ap.add_argument("--device", default=None, help="cpu for the plain versions")
    args = ap.parse_args(argv)

    from svnicp_tpu_torch import bench
    from svnicp_tpu_torch.io import datasets, metrics

    n = args.frames
    pipe, times, scans = bench.build(
        n, particles=64, use_pallas=True, candidate_method=args.method,
        residual=args.residual, insert_every=args.insert_every,
        segmentation=args.segmentation, features=args.features,
        icp_method=args.icp_method, device=args.device)
    _, rots, trans = datasets.synthetic_trajectory(n, dt=0.1, speed=2.0, seed=7)
    for i in range(n):
        pipe.feed_scan(float(times[i]), scans[i])
    pipe.close()
    est = pipe.trajectory()
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, :3, :3] = rots
    gt[:, :3, 3] = trans
    ate = metrics.ate_rmse(est, gt)
    rpe_t, rpe_r = metrics.rpe(est, gt)
    mean_iters = float(np.mean([int(o.icp_iterations) for o in pipe.outputs[1:]]))
    # calibration of the per-frame correction's covariance (the bootstrap
    # frame has no alignment)
    guess = np.tile(np.eye(4), (n, 1, 1))
    covs = np.zeros((n, 6, 6))
    for i, o in enumerate(pipe.outputs):
        guess[i, :3, :3] = o.guess_r.cpu().numpy()
        guess[i, :3, 3] = o.guess_t.cpu().numpy()
        covs[i] = o.cov.cpu().numpy()
    mean_nees, _ = metrics.nees(est[1:], gt[1:], guess[1:], covs[1:])
    rec = {
        "method": args.method, "residual": args.residual,
        "icp_method": args.icp_method, "segmentation": bool(args.segmentation),
        "frames": n, "ate_rmse_m": round(float(ate), 4),
        "rpe_trans_m": round(float(rpe_t), 4), "rpe_rot_rad": round(float(rpe_r), 5),
        "mean_icp_iterations": round(mean_iters, 1),
        "mean_nees_6dof": round(float(mean_nees), 2),
        "device": (bench.nvidia_smi_line() if pipe.device.type == "cuda"
                   else "cpu"),
    }
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
