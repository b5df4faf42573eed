#!/usr/bin/env python3
"""Iterations per frame and ATE of chip_smoke.py's three paths on one NVIDIA
GPU with the plain PyTorch versions of some kernels in place of their CUDA
kernels, beside the kernels' own run.

    python3 tools/torch_iterations_plain.py

The plain versions compute the same functions with other rounding, so the
runs show how far the iteration counts and the ATE move under rounding
alone (the stop statistic of a noisy frame hovers at its threshold, and
the SVGD path runs every frame to its cap). Variants: the main and
GEODE-Alpha paths with the plain B1, and with the plain B2, B3 and B4; the
SVGD path with the plain B1, the plain B5, and both. Prints, for each path
and each variant, the iterations per frame, their sum and the ATE.
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
    vcfg = cs.svgd_config()
    times, rots, trans, scans = cs.bench_sequence(n)
    gtimes, grots, gtrans, gscans, gimu = cs.geode_sequence(n)
    vtimes, vsweeps, vrots, vtrans = cs.svgd_sequence(n)
    frames = [(times[i], scans[i], [], None) for i in range(n)]
    gframes = [(gtimes[i], gscans[i], [gimu[i]], None) for i in range(n)]
    vframes = [(vtimes[i], vsweeps[i][0], [], vsweeps[i][1]) for i in range(n)]

    kernels = dict(b1=nn.bucketed_candidates, b3=stein.stein_update, b5=nn.nn_match,
                   moments=dict(nn.MOMENTS))

    def use(plain: str) -> None:
        """Put the kernels back, then the plain versions of those named."""
        nn.bucketed_candidates = (nn.bucketed_candidates_plain if "B1" in plain
                                  else kernels["b1"])
        nn.nn_match = nn.nn_match_plain if "B5" in plain else kernels["b5"]
        nn.MOMENTS.update(kernels["moments"])
        stein.stein_update = kernels["b3"]
        if "B2" in plain:
            nn.MOMENTS[nn.PlanePrep] = (nn.plane_moments_plain, nn.plane_moments_plain)
            nn.MOMENTS[nn.PointPrep] = (nn.point_moments_plain, nn.point_moments_plain)
            stein.stein_update = stein.stein_update_plain

    paths = [("main path", cfg, frames, rots, trans),
             ("geode path", gcfg, gframes, grots, gtrans),
             ("svgd path", vcfg, vframes, vrots, vtrans)]
    variants = {"main path": ("", "B1", "B2, B3 and B4"),
                "geode path": ("", "B1", "B2, B3 and B4"),
                "svgd path": ("", "B1", "B5", "B1 and B5")}
    try:
        for name, c, fr, r, t in paths:
            for plain in variants[name]:
                use(plain)
                run(f"{name}, {'plain ' + plain if plain else 'kernels'}", c, fr, r, t)
    finally:
        use("")
    return 0


if __name__ == "__main__":
    sys.exit(main())
