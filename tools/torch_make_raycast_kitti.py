"""Write a KITTI-odometry sequence of HDL-64 raycast scans.

The port's counterpart of the JAX package's `tools/make_raycast_kitti.py`,
with the port's `io/datasets.raycast_scan`: scans raycast with the HDL-64E
ray pattern (64 x 2250) over SyntheticWorld(extent=80, n_walls=24,
n_boxes=16, seed) along synthetic_trajectory(dt=0.1, speed=2.0, seed), in
KITTI's layout: velodyne/NNNNNN.bin (x, y, z, intensity as float32),
times.txt and poses.txt (3x4 rows, identity calibration), which the port's
KITTI reader and `python -m svnicp_tpu_torch.cli kitti` read.

    python3 tools/torch_make_raycast_kitti.py --out DIR [--frames 25] [--seed 7]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def write(out: str, frames: int, seed: int) -> None:
    from svnicp_tpu_torch.io import datasets

    world = datasets.SyntheticWorld(extent=80.0, n_walls=24, n_boxes=16, seed=seed)
    times, rots, trans = datasets.synthetic_trajectory(frames, dt=0.1, speed=2.0,
                                                       seed=seed)
    rng = np.random.default_rng(seed)
    vel = os.path.join(out, "velodyne")
    os.makedirs(vel, exist_ok=True)
    for i in range(frames):
        pts = datasets.raycast_scan(world._surfaces, rots[i], trans[i], max_range=75.0,
                                    rng=rng)
        rec = np.zeros((len(pts), 4), np.float32)
        rec[:, :3] = pts
        rec[:, 3] = 0.5   # a constant intensity, which the reader drops
        rec.tofile(os.path.join(vel, f"{i:06d}.bin"))
    np.savetxt(os.path.join(out, "times.txt"), times, fmt="%.6f")
    poses = np.concatenate([rots, trans[:, :, None]], axis=2).reshape(-1, 12)
    np.savetxt(os.path.join(out, "poses.txt"), poses, fmt="%.9f")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("--frames", type=int, default=25)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    write(args.out, args.frames, args.seed)
    print(f"wrote {args.frames} HDL-64 raycast frames to {args.out}")


if __name__ == "__main__":
    main()
