"""The ring-cloud loop study on the card: every variant of the JAX package's
`tools/loop_study.py` on the capped-range loop log.

Records (once; cached under build/svnicp_tpu_torch/tools/) the port's
`io/stream.record_proxy` loop log (a circle of `--loop-radius` with the
HDL-64 sweeps capped at `--scan-range`) and plays it through `LIOPipeline`
for each variant, printing one JSON line a variant with loop_study's
fields (frames/s, ATE, final and largest position error, yaw drift, the
loop gate, align failures, mean iterations; with `--posegraph` the
closures and re-anchors):

  base       configs/proxy_hdl64.yaml as written
  base-icp   the same with the ICP estimator
  seg        range-image segmentation, the ICP estimator, the MAP prior
  feat       feature selection, the ICP estimator, the MAP prior
  feat-kf    feature selection with the ESKF, the cold-start bootstrap and
             the MAP prior
  <v>-plane  any of those with point-to-plane at K=32 and the mean-drift
             stop at 1e-3

    python3 tools/torch_loop_study.py [--variants base-icp,seg] [--frames 246]
        [--scan-range 9.0] [--loop-radius 6.0] [--seed 3] [--posegraph]
        [--device cpu]
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
VARIANTS = ("base", "base-icp", "seg", "feat", "feat-kf")


def record_loop(frames: int, scan_range: float, loop_radius: float,
                seed: int) -> tuple[str, str]:
    """Record (once, cached) the capped-range loop log -> (log, ground truth)."""
    from svnicp_tpu_torch.io import stream

    key = hashlib.sha1(
        f"loop5 {frames} {scan_range} {loop_radius} {seed}".encode()).hexdigest()[:12]
    log = os.path.join(CACHE, f"loop_proxy_{key}.svnl")
    gtp = os.path.join(CACHE, f"loop_proxy_{key}_gt.npy")
    if not (os.path.exists(log) and os.path.exists(gtp)):
        os.makedirs(CACHE, exist_ok=True)
        t0 = time.perf_counter()
        np.save(gtp, stream.record_proxy(log, n_frames=frames, path_shape="loop",
                                         loop_radius=loop_radius,
                                         scan_range=scan_range, seed=seed))
        print(f"[torch_loop_study] recorded {frames} frames in "
              f"{time.perf_counter() - t0:.1f}s -> {log}", file=sys.stderr)
    return log, gtp


def variant_config(name: str):
    """loop_study's variant on configs/proxy_hdl64.yaml."""
    from svnicp_tpu_torch import config as cfg_mod

    cfg = cfg_mod.from_yaml(os.path.join(ROOT, "configs", "proxy_hdl64.yaml"))
    icp_est = dataclasses.replace(cfg.lio, estimator="icp")
    prior = dataclasses.replace(cfg.icp, prior_information=True)
    if name == "base":
        return cfg
    if name == "base-icp":
        return dataclasses.replace(cfg, lio=icp_est)
    if name == "seg":
        # deskew stays on: the sweep times ride through the projection
        return dataclasses.replace(
            cfg, lio=icp_est, icp=prior,
            preprocess=dataclasses.replace(cfg.preprocess, use_segmentation=True))
    if name == "feat":
        return dataclasses.replace(
            cfg, lio=icp_est, icp=prior,
            preprocess=dataclasses.replace(cfg.preprocess, feature_select=True))
    if name == "feat-kf":
        return dataclasses.replace(
            cfg, lio=dataclasses.replace(cfg.lio, init_from_motion=True), icp=prior,
            preprocess=dataclasses.replace(cfg.preprocess, feature_select=True))
    if name.endswith("-plane"):
        # the selected source samples surfaces unlike the downsampled map,
        # so the plane residual (normals from the K=32 candidates) measures
        # the distance to the surface rather than to a sample
        base = variant_config(name[: -len("-plane")])
        return dataclasses.replace(
            base, icp=dataclasses.replace(
                base.icp, residual="point_to_plane", knn_count=32,
                convergence_metric="mean_delta", convergence_threshold=1e-3))
    raise SystemExit(f"unknown variant {name!r}")


def with_posegraph(cfg):
    """loop_study's pose-graph block, sized for the 246-frame circle:
    keyframes every 1.5 m (~25 in all), so the separation gate sits well
    below that; the candidate radius covers the feat-kf-plane odometry's
    tail error."""
    return dataclasses.replace(cfg, posegraph=dataclasses.replace(
        cfg.posegraph, enabled=True, reanchor=True, keyframe_trans_threshold=1.5,
        loop_min_separation=12, loop_radius=4.0, loop_iterations=60, loop_knn=32,
        loop_use_pallas=True))


def run_variant(name: str, log: str, gtp: str, posegraph: bool = False,
                device=None) -> dict:
    import torch

    from svnicp_tpu_torch import bench
    from svnicp_tpu_torch.core import geometry as geo
    from svnicp_tpu_torch.io import metrics, stream
    from svnicp_tpu_torch.runtime import pipeline as pl

    cfg = variant_config(name)
    if posegraph:
        cfg = with_posegraph(cfg)
    gt = np.load(gtp)
    pipe = pl.LIOPipeline(cfg, device=device)
    t0 = time.perf_counter()
    with open(log, "rb") as f:
        n = stream.play(pipe, f)
    pipe.close()
    est = pipe.trajectory()
    rec = {"variant": name, "frames": n, "fps": round(n / (time.perf_counter() - t0), 2)}
    if len(est) == len(gt):
        rec["ate_rmse_m"] = round(metrics.ate_rmse(est, gt), 4)
        # the final drift and the per-frame yaw error's trend
        err_t = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)
        rec["final_pos_err_m"] = round(float(err_t[-1]), 3)
        rec["max_pos_err_m"] = round(float(err_t.max()), 3)
        yaw_err = [float(geo.so3_log(torch.from_numpy(e[:3, :3] @ g[:3, :3].T))[2])
                   for e, g in zip(est, gt)]
        rec["final_yaw_err_rad"] = round(yaw_err[-1], 4)
        rec["yaw_drift_rad_per_frame"] = round(
            float(np.polyfit(np.arange(len(yaw_err)), yaw_err, 1)[0]), 5)
        # the loop gate: back in the start region (the last 10% of frames),
        # is the estimate within 2.5 m of where it thinks the start was?
        tail = slice(int(0.9 * len(est)), len(est))
        rec["tail_pos_err_m"] = round(float(err_t[tail].mean()), 3)
        rec["loop_gate_ok"] = bool(err_t[tail].mean() < 2.5)
    rec["align_fail"] = int(sum(not o.align_ok for o in pipe.outputs))
    rec["mean_iters"] = round(float(np.mean(
        [int(o.icp_iterations) for o in pipe.outputs[1:]])), 1)
    if posegraph:
        rec["loop_closures"] = len(pipe.loop_closures)
        rec["reanchors"] = pipe.reanchors
        rec["reanchors_rejected"] = pipe.reanchors_rejected
        rec["loop_edges_pruned"] = pipe.loop_edges_pruned
    rec["device"] = bench.nvidia_smi_line() if pipe.device.type == "cuda" else "cpu"
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--variants", default="base-icp,seg")
    ap.add_argument("--frames", type=int, default=246)
    ap.add_argument("--scan-range", type=float, default=9.0)
    ap.add_argument("--loop-radius", type=float, default=6.0)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument("--posegraph", action="store_true",
                    help="the keyframe graph and re-anchoring on each variant")
    ap.add_argument("--device", default=None, help="cpu for the plain versions")
    args = ap.parse_args(argv)
    log, gtp = record_loop(args.frames, args.scan_range, args.loop_radius, args.seed)
    return [run_variant(name.strip(), log, gtp, args.posegraph, args.device)
            for name in args.variants.split(",")]


if __name__ == "__main__":
    main()
