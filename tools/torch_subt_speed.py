"""The SubT-MRS operating points on the card, played from the straight
HDL-64 proxy log.

Records (once; cached under build/svnicp_tpu_torch/tools/) the straight
proxy log with the port's `io/stream.record_proxy` and plays it through
`LIOPipeline` for each variant, `--repeat` times, printing one JSON line a
variant (the counterpart of the JAX package's `tools/subt_speed.py`):

  subt       configs/subt_mrs.yaml as written (pure ICP, P=30, 0.2 m
             voxels, 1 point a voxel, the stop at 1e-4);
  subt-fast  the same registration with the host crop and downsample, the
             int16 upload, deskew and stage-ahead (as configs/
             subt_mrs_fast.yaml).

    python3 tools/torch_subt_speed.py [--variants subt,subt-fast] [--frames 60]
        [--seed 3] [--repeat 2] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CACHE = os.path.join(ROOT, "build", "svnicp_tpu_torch", "tools")


def record_straight(frames: int, seed: int) -> tuple[str, str]:
    """Record (once, cached) the straight proxy log -> (log, ground truth)."""
    from svnicp_tpu_torch.io import stream

    key = hashlib.sha1(f"straight5 {frames} {seed}".encode()).hexdigest()[:12]
    log = os.path.join(CACHE, f"subt_proxy_{key}.svnl")
    gtp = os.path.join(CACHE, f"subt_proxy_{key}_gt.npy")
    if not (os.path.exists(log) and os.path.exists(gtp)):
        os.makedirs(CACHE, exist_ok=True)
        t0 = time.perf_counter()
        np.save(gtp, stream.record_proxy(log, n_frames=frames, seed=seed))
        print(f"[torch_subt_speed] recorded {frames} frames in "
              f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
    return log, gtp


def variant_config(name: str):
    from svnicp_tpu_torch import config as cfg_mod

    cfg = cfg_mod.from_yaml(os.path.join(ROOT, "configs", "subt_mrs.yaml"))
    if name == "subt":
        return cfg
    if name == "subt-fast":
        return dataclasses.replace(
            cfg,
            preprocess=dataclasses.replace(cfg.preprocess, deskew=True,
                                           host_downsample=True, quantize_upload=True),
            stage_ahead=True)
    raise SystemExit(f"unknown variant {name!r}")


def run_variant(name: str, log: str, gtp: str, repeat: int = 2, device=None) -> dict:
    from svnicp_tpu_torch import bench
    from svnicp_tpu_torch.io import metrics, stream
    from svnicp_tpu_torch.runtime import pipeline as pl

    cfg = variant_config(name)
    gt = np.load(gtp)
    samples, ate, n = [], None, 0
    for _ in range(repeat):
        pipe = pl.LIOPipeline(cfg, device=device)
        t0 = time.perf_counter()
        with open(log, "rb") as f:
            n = stream.play(pipe, f)
        pipe.close()
        pipe.outputs[-1].pose_t.cpu()
        samples.append(n / (time.perf_counter() - t0))
        est = pipe.trajectory()
        if len(est) == len(gt):
            ate = round(metrics.ate_rmse(est, gt), 4)
    rec = {"variant": name, "frames": n, "fps_warm": round(max(samples), 2),
           "fps_all": [round(s, 2) for s in samples], "ate_rmse_m": ate,
           "iterations": sum(int(o.icp_iterations) for o in pipe.outputs),
           "device": (bench.nvidia_smi_line() if pipe.device.type == "cuda"
                      else "cpu")}
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default="subt,subt-fast")
    ap.add_argument("--frames", type=int, default=60)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--repeat", type=int, default=2)
    ap.add_argument("--device", default=None, help="cpu for the plain versions")
    args = ap.parse_args(argv)
    log, gtp = record_straight(args.frames, args.seed)
    return [run_variant(name.strip(), log, gtp, args.repeat, args.device)
            for name in args.variants.split(",")]


if __name__ == "__main__":
    main()
