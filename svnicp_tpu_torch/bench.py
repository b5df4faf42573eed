"""The port's benchmark: LiDAR odometry frames per second on one card at 64
particles.

    python -m svnicp_tpu_torch.bench [--frames N] [--iters 100] [--particles 64]
        [--method bucketed|topk|voxel] [--no-pallas] [--no-early-stop]
        [--batch F] [--segmentation | --features]
        [--residual point_to_plane|point_to_point] [--insert-every N]
        [--no-stein-kernel] [--repeat 3] [--icp-method svn|svgd|svd]
        [--cpu-baseline]

The counterpart of the JAX package's `bench.py`, with its flags: the same
operating point (`pipeline_config`), the same synthetic sequence
(`sequence`) and the same warm-up and timed frame counts (`frame_counts`).
Prints ONE JSON line: `metric`, `value` (the median of the samples,
frames/s), `unit`, `vs_baseline`, `runs` (every sample), `quartiles` (the
25th and 75th percentiles of the samples), `iterations` (each sample's
align iterations over all its frames) and `device` (the card's name and
power limit as `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader` gives them).

A sample is a fresh `LIOPipeline` over the same scans; with `--repeat` > 1
one pass that is not recorded runs first. The timed window opens after the
warm-up frames are flushed and their last pose read to the host, and
closes when the last timed frame's pose has been read to the host, so all
the device work of the timed frames lies inside it; scan generation and
the kernels' build lie outside.

`vs_baseline` is the median over the port's own single-CPU figure, which
`--cpu-baseline` measures (`device="cpu"`, `--frames` frames, default 6)
and writes to `build/svnicp_tpu_torch/cpu_baseline.json`; without that
file it is null. Without CUDA the bench raises unless `--cpu-baseline` is
given: it never measures the CPU under the card's metric.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import platform
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

from svnicp_tpu_torch import config as cfg_mod

BASELINE_FILE = (Path(__file__).resolve().parents[1] / "build" / "svnicp_tpu_torch"
                 / "cpu_baseline.json")


def pipeline_config(particles: int, use_pallas: bool = False,
                    candidate_method: str = "bucketed", iterations: int = 100,
                    early_stop: bool = True, residual: str = "point_to_point",
                    batch: int = 1, host_ds: bool = True, segmentation: bool = False,
                    icp_method: str = "svn", insert_every: int = 1,
                    stein_kernel: bool = True, features: bool = False
                    ) -> cfg_mod.PipelineConfig:
    """The JAX package's bench operating point (its `bench.build`): GEODE-
    Alpha's registration scaled to 64 particles on 1 m voxels; the plane
    residual with K=32 and the mean-drift stop at 1e-3, point-to-point with
    K=100 and the gradient-norm stop at 5e-4; SVGD at lr 0.03; the MAP
    prior where segmentation or feature selection leaves null directions;
    the real HDL-64 range image (64 x 2250) on the raw route for those two
    modes, and otherwise the host downsample with the int16 upload and
    stage-ahead."""
    plane = residual == "point_to_plane"
    raw = segmentation or features
    return cfg_mod.PipelineConfig(
        icp=cfg_mod.SteinICPConfig(
            method=icp_method, particle_count=particles, iterations=iterations,
            lr=0.03 if icp_method == "svgd" else 1.0, max_dist=3.0,
            knn_count=32 if plane else 100, early_stop=early_stop,
            convergence_threshold=1e-3 if plane else 5e-4,
            convergence_metric="mean_delta" if plane else "grad_norm",
            prior_information=raw, source_capacity=4096, target_capacity=65536,
            use_pallas=use_pallas, candidate_method=candidate_method,
            residual=residual, stein_kernel=stein_kernel),
        map=cfg_mod.MapConfig(voxel_size=1.0, max_points_per_voxel=20,
                              max_range=300.0, capacity=131072,
                              insert_every=insert_every),
        preprocess=cfg_mod.PreprocessConfig(
            min_range=2.0, max_range=80.0, voxel_size=1.0,
            use_segmentation=segmentation, sensor_model="hdl64",
            feature_select=features, raw_capacity=147456 if raw else 32768,
            host_downsample=host_ds and not raw,
            quantize_upload=host_ds or raw),
        lio=cfg_mod.LIOConfig(estimator="icp", frame_gap_seconds=0.0),
        dispatch_batch=batch,
        stage_ahead=host_ds and batch == 1,
    )


def sequence(n_frames: int, raycast: bool = False):
    """The bench's synthetic drive -> (times [N], rotations [N,3,3],
    translations [N,3], scans): SyntheticWorld(extent=80, n_walls=24,
    n_boxes=16, seed=7) along synthetic_trajectory(dt=0.1, speed=2.0,
    seed=7), 32,000-point scans to 75 m, or with `raycast` HDL-64 raycast
    scans (64 x 2250 rays) to 75 m, noise from default_rng(7)."""
    from svnicp_tpu_torch.io import datasets

    world = datasets.SyntheticWorld(extent=80.0, n_walls=24, n_boxes=16, seed=7)
    times, rots, trans = datasets.synthetic_trajectory(n_frames, dt=0.1, speed=2.0,
                                                       seed=7)
    rng = np.random.default_rng(7)
    if raycast:
        scans = [datasets.raycast_scan(world._surfaces, rots[i], trans[i],
                                       max_range=75.0, rng=rng)
                 for i in range(n_frames)]
    else:
        scans = [world.scan_at(rng, rots[i], trans[i], n_points=32000, max_range=75.0)
                 for i in range(n_frames)]
    return times, rots, trans, scans


def build(n_frames: int, particles: int, use_pallas: bool = False,
          candidate_method: str = "bucketed", iterations: int = 100,
          early_stop: bool = True, residual: str = "point_to_point",
          batch: int = 1, host_ds: bool = True, segmentation: bool = False,
          icp_method: str = "svn", insert_every: int = 1,
          stein_kernel: bool = True, features: bool = False, device=None):
    """The bench's pipeline and scans -> (LIOPipeline, times, scans). The
    pipeline runs on the card, or on `device` ("cpu") when given."""
    from svnicp_tpu_torch.runtime import pipeline as pl

    cfg = pipeline_config(particles, use_pallas, candidate_method, iterations,
                          early_stop, residual, batch, host_ds, segmentation,
                          icp_method, insert_every, stein_kernel, features)
    times, _, _, scans = sequence(n_frames, raycast=segmentation or features)
    return pl.LIOPipeline(cfg, device=device), times, scans


class BenchRun(NamedTuple):
    samples: list      # frames/s of each recorded sample
    iterations: list   # each recorded sample's align iterations over all frames
    passes: int        # pipelines run, the pass that is not recorded included
    pipe: object       # the last sample's LIOPipeline (closed)


def _feed(pipe, times, scans, lo: int, hi: int):
    out = None
    for i in range(lo, hi):
        out = pipe.feed_scan(float(times[i]), scans[i]) or out
    return pipe.flush() or out


def run(n_frames: int, warmup: int, particles: int = 64, use_pallas: bool = False,
        candidate_method: str = "bucketed", iterations: int = 100,
        early_stop: bool = True, residual: str = "point_to_point",
        batch: int = 1, segmentation: bool = False, icp_method: str = "svn",
        insert_every: int = 1, stein_kernel: bool = True, repeat: int = 1,
        features: bool = False, device=None) -> BenchRun:
    """Measure frames/s: `repeat` samples (at least one), each a fresh
    pipeline over the same scans, after one pass that is not recorded when
    repeat > 1 (a process's first pass runs its first launches and
    allocations)."""
    from svnicp_tpu_torch.runtime import pipeline as pl

    pipe, times, scans = build(n_frames, particles, use_pallas, candidate_method,
                               iterations, early_stop, residual, batch,
                               segmentation=segmentation, icp_method=icp_method,
                               insert_every=insert_every, stein_kernel=stein_kernel,
                               features=features, device=device)
    samples, iters = [], []
    first = -1 if repeat > 1 else 0
    for rep in range(first, max(1, repeat)):
        if rep > first:
            pipe = pl.LIOPipeline(pipe.cfg, device=pipe.device)
        out = _feed(pipe, times, scans, 0, warmup)
        if out is not None:
            out.pose_t.cpu()
        t0 = time.perf_counter()
        out = _feed(pipe, times, scans, warmup, n_frames)
        out.pose_t.cpu()   # waits for the device: its work is inside the window
        dt = time.perf_counter() - t0
        pipe.close()
        if rep >= 0:
            samples.append((n_frames - warmup) / dt)
            iters.append(sum(int(o.icp_iterations) for o in pipe.outputs))
    return BenchRun(samples, iters, max(1, repeat) - first, pipe)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cpu-baseline", action="store_true",
                    help="measure the port's single-CPU frames/s (device cpu) and "
                         "write it to build/svnicp_tpu_torch/cpu_baseline.json")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--particles", type=int, default=64)
    ap.add_argument("--method", default="bucketed", choices=["bucketed", "topk", "voxel"],
                    help="stage-1 correspondence candidate method")
    ap.add_argument("--no-pallas", action="store_true",
                    help="the XLA route: plain torch ops in place of the kernels")
    ap.add_argument("--no-early-stop", action="store_true",
                    help="run all --iters iterations")
    ap.add_argument("--batch", type=int, default=1,
                    help="frames per device dispatch (dispatch_batch)")
    ap.add_argument("--segmentation", action="store_true",
                    help="HDL-64 raycast scans through range-image segmentation")
    ap.add_argument("--features", action="store_true",
                    help="HDL-64 raycast scans through LOAM-style feature selection")
    ap.add_argument("--residual", default="point_to_plane",
                    choices=["point_to_point", "point_to_plane"],
                    help="ICP residual; point_to_point is the reference-parity row")
    ap.add_argument("--insert-every", type=int, default=1,
                    help="map insert cadence (off-cadence frames skip the insert)")
    ap.add_argument("--no-stein-kernel", action="store_true",
                    help="the plain Stein update in place of its kernel")
    ap.add_argument("--repeat", type=int, default=3,
                    help="timed samples in one process; reports the median and "
                         "quartiles (1: a single sample, no unrecorded pass)")
    ap.add_argument("--icp-method", default="svn", choices=["svn", "svgd", "svd"])
    return ap


def frame_counts(args) -> tuple[int, int]:
    """(warm-up, timed) frames: warm-up spans the bootstrap, a batch's
    first dispatches and the first on-cadence insert; the timed count is a
    multiple of the batch (a partial batch would change the dispatch inside
    the window), 20 for the raycast modes (their scans are the set-up
    cost), else 40."""
    batch = args.batch
    warmup = max(3, args.insert_every + 1) if batch <= 1 else 1 + 2 * batch
    timed = 40 if batch <= 1 else ((40 + batch - 1) // batch) * batch
    if args.segmentation or args.features:
        timed = min(timed, 20)
    return warmup, timed


def run_kwargs(args) -> dict:
    """`run`'s keywords for the parsed flags (all but frame counts, repeat
    and device)."""
    return dict(use_pallas=not args.no_pallas, candidate_method=args.method,
                iterations=args.iters, particles=args.particles,
                early_stop=not args.no_early_stop, residual=args.residual,
                batch=args.batch, segmentation=args.segmentation,
                icp_method=args.icp_method, insert_every=args.insert_every,
                stein_kernel=not args.no_stein_kernel, features=args.features)


def metric_name(args) -> str:
    metric = "lidar_frames_per_sec_per_chip_64_particles"
    if args.segmentation:
        return metric + "_segmentation"
    if args.features:
        return metric + "_features"
    if args.icp_method != "svn":
        return metric + f"_{args.icp_method}"
    return metric


def nvidia_smi_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cpu_baseline_fps() -> float | None:
    """The port's own single-CPU frames/s from `--cpu-baseline`, or None."""
    try:
        return float(json.loads(BASELINE_FILE.read_text())["value"])
    except (OSError, KeyError, ValueError):
        return None


def record(args, result: BenchRun, device: str) -> dict:
    """The bench's JSON line for `result`."""
    fps = float(np.median(result.samples))
    base = cpu_baseline_fps()
    return {
        "metric": metric_name(args),
        "value": round(fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(fps / base, 2) if base else None,
        "runs": [round(s, 3) for s in result.samples],
        "quartiles": [round(float(q), 3) for q in np.percentile(result.samples, [25, 75])],
        "iterations": result.iterations,
        "device": device,
    }


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    if args.cpu_baseline:
        import torch

        res = run(n_frames=args.frames or 6, warmup=2, device="cpu")
        rec = {"metric": "cpu_baseline_frames_per_sec",
               "value": round(res.samples[0], 4), "unit": "frames/s",
               "vs_baseline": 1.0, "date": datetime.date.today().isoformat(),
               "device": f"cpu: {platform.machine()}, {os.cpu_count()} cores, "
                         f"{torch.get_num_threads()} torch threads"}
        BASELINE_FILE.parent.mkdir(parents=True, exist_ok=True)
        BASELINE_FILE.write_text(json.dumps(rec) + "\n")
        print(json.dumps(rec))
        return rec

    from svnicp_tpu_torch import resolve_device

    resolve_device(None)   # raises on a host without CUDA
    warmup, timed = frame_counts(args)
    result = run(n_frames=args.frames or (warmup + timed), warmup=warmup,
                 repeat=args.repeat, **run_kwargs(args))
    rec = record(args, result, nvidia_smi_line())
    print(json.dumps(rec))
    return rec


if __name__ == "__main__":
    main()
