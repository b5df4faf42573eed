#!/usr/bin/env python3
"""Iterations per frame of chip_smoke.py's main and GEODE-Alpha paths on one
NVIDIA GPU with the plain PyTorch versions of B2, B3 and B4 in place of
their CUDA kernels, beside the kernels' own run.

    python3 tools/torch_iterations_plain.py

The plain versions compute the same functions with other rounding, so the
two runs show how far the iteration counts move under rounding alone (the
stop statistic of a noisy frame hovers at its threshold). Prints, for each
path and each variant, the iterations per frame, their sum and the ATE.
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def run(name, cfg, frames, rots, trans) -> None:
    import numpy as np

    import chip_smoke as cs
    from svnicp_tpu_torch.io import metrics

    pipe, _, launches = cs.run_path(cfg, frames)
    iters = [o.icp_iterations for o in pipe.outputs]
    gt = np.tile(np.eye(4), (len(iters), 1, 1))
    gt[:, :3, :3] = rots
    gt[:, :3, 3] = trans
    ate = metrics.ate_rmse(pipe.trajectory(), gt)
    print(f"{name}: iterations {iters} sum {sum(iters)}; ATE {ate:.4f} m; "
          f"kernel launches {launches}")


def main() -> int:
    import torch

    import chip_smoke as cs
    from svnicp_tpu_torch import config as cfg_mod
    from svnicp_tpu_torch.kernels import nn, stein

    if not torch.cuda.is_available():
        print("torch_iterations_plain: no CUDA device", file=sys.stderr)
        return 2
    n = cs.WARMUP + cs.TIMED
    cfg = cfg_mod.from_yaml(os.path.join(ROOT, "configs", "tpu_plane.yaml"))
    gcfg = cfg_mod.from_yaml(os.path.join(ROOT, "configs", "geode_alpha.yaml"))
    times, rots, trans, scans = cs.bench_sequence(n)
    gtimes, grots, gtrans, gscans, gimu = cs.geode_sequence(n)
    frames = [(times[i], scans[i], None, None) for i in range(n)]
    gframes = [(gtimes[i], gscans[i], gimu[i], None) for i in range(n)]

    kernel_b3, moments = stein.stein_update, dict(nn.MOMENTS)
    for variant in ("kernels", "plain B2, B3 and B4"):
        if variant != "kernels":
            nn.MOMENTS[nn.PlanePrep] = (nn.plane_moments_plain, nn.plane_moments_plain)
            nn.MOMENTS[nn.PointPrep] = (nn.point_moments_plain, nn.point_moments_plain)
            stein.stein_update = stein.stein_update_plain
        run(f"main path, {variant}", cfg, frames, rots, trans)
        run(f"geode path, {variant}", gcfg, gframes, grots, gtrans)
    stein.stein_update = kernel_b3
    nn.MOMENTS.update(moments)
    return 0


if __name__ == "__main__":
    sys.exit(main())
