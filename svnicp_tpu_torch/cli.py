"""Command-line entry points of the port (port of `svnicp_tpu/cli.py`):

    python -m svnicp_tpu_torch.cli demo   [--config CFG] [--frames N] [--output out.jsonl]
    python -m svnicp_tpu_torch.cli kitti  --velodyne DIR [--poses FILE] [--config CFG] ...
    python -m svnicp_tpu_torch.cli stream --log run.svnl [--config CFG] [--gt gt.npy] ...
    python -m svnicp_tpu_torch.cli record --log run.svnl [--proxy] [--gt gt.npy] ...

The flags, defaults, JSONL records (io/records.py) and the summary line
are the JAX package's; `--device` (default: the card) picks where the
pipeline runs, `--device cpu` for a host without CUDA. `main` returns what
the command returns: (pipeline, summary) for demo, kitti and stream.

With SVNICP_COORDINATOR ("host:port"), SVNICP_NUM_PROCESSES and
SVNICP_PROCESS_ID set, every launched process runs the same command line
and first joins the process group (`parallel/distributed.py`); a config
whose `sharding` spans that many shards then runs one shard per process.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


def _load_config(path: str | None):
    from svnicp_tpu_torch import config as cfg_mod

    if path is None:
        return cfg_mod.PipelineConfig()
    return cfg_mod.from_yaml(path)


def _open_writer(path: str | None):
    from svnicp_tpu_torch.io.records import JSONLWriter

    if path is None:
        return None, contextlib.nullcontext()
    f = open(path, "w")
    return JSONLWriter(f), contextlib.closing(f)


def _run_stream(cfg, stream, imu_stream=None, writer=None, gt_poses=None,
                progress=True, device=None):
    """Feed (t, points[, times]) frames through a LIOPipeline, writing each
    frame's records as it comes out, and print the summary line."""
    import numpy as np

    from svnicp_tpu_torch.io import metrics, records
    from svnicp_tpu_torch.runtime import pipeline as pl

    pipe = pl.LIOPipeline(cfg, device=device)
    if writer is not None:
        writer.write(records.ParametersRecord.from_config(cfg))
    if imu_stream is not None:
        for t, acc, gyro in imu_stream:
            pipe.feed_imu(t, acc, gyro)

    n_frames = 0
    kf_mode = cfg.lio.estimator == "kf"

    def drain_new() -> None:
        # records come from the pipeline's own (time, output, timing)
        # triples, so stage-ahead latency cannot skew them
        nonlocal n_frames
        while n_frames < len(pipe.outputs):
            t_out = pipe.times[n_frames]
            out = pipe.outputs[n_frames]
            timing = pipe.frame_timings[n_frames]
            n_frames += 1
            if writer is not None:
                # the records copy the output to the host, which waits for
                # the device: the sync span completes the frame's time
                t_sync = time.perf_counter()
                recs = records.frame_records(t_out, out, include_kf_gain=kf_mode)
                sync_wall = time.perf_counter() - t_sync
                writer.write(records.RuntimeRecord(
                    stamp=t_out,
                    preprocessing_time=timing["preprocessing_time"],
                    steinicp_time=timing["steinicp_time"] + sync_wall,
                    finish_iter=int(out.icp_iterations)))
                writer.write_all(recs)
            if progress and n_frames % 20 == 0:
                p = out.pose_t.cpu().numpy()
                print(f"[svnicp] frame {n_frames}  "
                      f"pose=({p[0]:.2f},{p[1]:.2f},{p[2]:.2f})"
                      f"  map={int(out.map_points)}", file=sys.stderr)

    t_start = time.perf_counter()
    for item in stream:
        t, pts = item[0], item[1]
        ts = item[2] if len(item) > 2 else None
        pipe.feed_scan(t, pts, ts)
        drain_new()
    pipe.flush()    # the staged-ahead tail
    drain_new()
    wall = time.perf_counter() - t_start

    est = pipe.trajectory()
    summary = {"frames": n_frames, "wall_seconds": round(wall, 3),
               "frames_per_sec": round(n_frames / max(wall, 1e-9), 3)}
    if gt_poses is not None and len(est) == len(gt_poses):
        summary["ate_rmse_m"] = round(metrics.ate_rmse(est, gt_poses), 4)
        rpe_t, rpe_r = metrics.rpe(est, gt_poses)
        summary["rpe_trans_m"] = round(rpe_t, 4)
        summary["rpe_rot_rad"] = round(rpe_r, 5)
    print(json.dumps(summary))
    return pipe, summary


def cmd_demo(args):
    import dataclasses

    import numpy as np

    from svnicp_tpu_torch.core.imu import GRAVITY
    from svnicp_tpu_torch.io import datasets

    cfg = _load_config(args.config)
    if args.save_particles:
        cfg = dataclasses.replace(cfg, save_particles=True)
    world = datasets.SyntheticWorld(extent=60.0, seed=args.seed)
    times, rots, trans = datasets.synthetic_trajectory(
        args.frames, dt=0.1, speed=1.5, seed=args.seed, ramp_seconds=1.0)
    rng = np.random.default_rng(args.seed)

    def stream():
        for i in range(args.frames):
            yield float(times[i]), world.scan_at(rng, rots[i], trans[i],
                                                 n_points=args.points)

    imu = (datasets.synthetic_imu(times, rots, trans, GRAVITY)
           if cfg.lio.estimator == "kf" else None)
    gt = np.tile(np.eye(4), (args.frames, 1, 1))
    gt[:, :3, :3] = rots
    gt[:, :3, 3] = trans
    writer, ctx = _open_writer(args.output)
    with ctx:
        return _run_stream(cfg, stream(), imu, writer, gt, device=args.device)


def cmd_kitti(args):
    import itertools

    from svnicp_tpu_torch.io import datasets

    cfg = _load_config(args.config)
    stream = datasets.kitti_sequence(args.velodyne, args.times)
    if args.kitti_correction:
        # the per-point vertical fix and azimuth pseudo-times for deskewing
        # (ref: OdometryPipeline.cpp:385-400), on the host's CPU
        import torch

        from svnicp_tpu_torch.core.pointcloud import kitti_vertical_correction

        def corrected(raw_stream):
            for t, pts in raw_stream:
                fixed, tau = kitti_vertical_correction(torch.from_numpy(pts))
                yield t, fixed.numpy(), tau.numpy()

        stream = corrected(stream)
    if args.max_frames:
        stream = itertools.islice(stream, args.max_frames)
    gt = None
    if args.poses:
        gt = datasets.read_kitti_poses(args.poses)
        if args.max_frames:
            gt = gt[: args.max_frames]
    writer, ctx = _open_writer(args.output)
    with ctx:
        return _run_stream(cfg, stream, None, writer, gt, device=args.device)


def cmd_stream(args):
    """Play a recorded SVNL sensor log (io/stream.py) through the pipeline,
    the offline counterpart of the reference's ROS subscribers
    (ref: OdometryPipeline.cpp:307-354)."""
    import numpy as np

    from svnicp_tpu_torch.io import metrics, records
    from svnicp_tpu_torch.io import stream as stream_mod
    from svnicp_tpu_torch.runtime import pipeline as pl

    cfg = _load_config(args.config)
    pipe = pl.LIOPipeline(cfg, device=args.device)
    writer, ctx = _open_writer(args.output)
    t0 = time.perf_counter()
    with ctx, open(args.log, "rb") as f:
        if writer is not None:
            writer.write(records.ParametersRecord.from_config(cfg))

        def progress(n, stamp):
            if n % 20 == 0:
                print(f"[svnicp] stream frame {n} @ {stamp:.2f}s", file=sys.stderr)

        n = stream_mod.play(pipe, f, progress=progress)
        wall = time.perf_counter() - t0
        if writer is not None:
            kf_mode = cfg.lio.estimator == "kf"
            for t_out, out, timing in zip(pipe.times, pipe.outputs,
                                          pipe.frame_timings):
                writer.write(records.RuntimeRecord(
                    stamp=t_out,
                    preprocessing_time=timing["preprocessing_time"],
                    steinicp_time=timing["steinicp_time"],
                    finish_iter=int(out.icp_iterations)))
                writer.write_all(records.frame_records(
                    t_out, out, include_kf_gain=kf_mode))
    est = pipe.trajectory()
    summary = {"frames": n, "wall_seconds": round(wall, 3),
               "frames_per_sec": round(n / max(wall, 1e-9), 3)}
    if args.gt:
        gt = np.load(args.gt)
        if len(gt) == len(est):
            summary["ate_rmse_m"] = round(metrics.ate_rmse(est, gt), 4)
    print(json.dumps(summary))
    return pipe, summary


def cmd_record(args):
    """Write a synthetic SVNL log (and its ground-truth poses as .npy): a
    data source for `stream` without sensors."""
    import numpy as np

    from svnicp_tpu_torch.io import stream as stream_mod

    if args.proxy:
        gt = stream_mod.record_proxy(args.log, n_frames=args.frames, seed=args.seed,
                                     col_step=args.col_step)
    else:
        gt = stream_mod.record_synthetic(args.log, n_frames=args.frames,
                                         seed=args.seed, n_points=args.points)
    if args.gt:
        np.save(args.gt, gt)
    print(json.dumps({"log": args.log, "frames": args.frames,
                      "proxy": bool(args.proxy)}))


def main(argv=None):
    from svnicp_tpu_torch.parallel import distributed

    distributed.maybe_initialize_from_env()
    ap = argparse.ArgumentParser(prog="svnicp_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def device_flag(p):
        p.add_argument("--device", default=None,
                       help="torch device of the pipeline (default: the card)")

    d = sub.add_parser("demo", help="synthetic ground-truthed sequence")
    d.add_argument("--config", default=None)
    d.add_argument("--frames", type=int, default=40)
    d.add_argument("--points", type=int, default=8000)
    d.add_argument("--seed", type=int, default=0)
    d.add_argument("--output", default=None, help="JSONL record stream path")
    d.add_argument("--save-particles", action="store_true",
                   help="record per-iteration particle trajectories "
                        "(ParticleHistoryRecord, ref /svnicp/all_particles)")
    device_flag(d)
    d.set_defaults(fn=cmd_demo)

    k = sub.add_parser("kitti", help="KITTI odometry sequence directory")
    k.add_argument("--velodyne", required=True)
    k.add_argument("--times", default=None)
    k.add_argument("--poses", default=None)
    k.add_argument("--config", default=None)
    k.add_argument("--max-frames", type=int, default=0)
    k.add_argument("--kitti-correction", action="store_true",
                   help="apply the 0.205 deg vertical fix + azimuth timestamps")
    k.add_argument("--output", default=None)
    device_flag(k)
    k.set_defaults(fn=cmd_kitti)

    s = sub.add_parser("stream", help="play a recorded SVNL sensor stream")
    s.add_argument("--log", required=True, help="SVNL packet log path")
    s.add_argument("--config", default=None)
    s.add_argument("--gt", default=None, help="[N,4,4] poses .npy for ATE")
    s.add_argument("--output", default=None, help="JSONL record stream path")
    device_flag(s)
    s.set_defaults(fn=cmd_stream)

    r = sub.add_parser("record", help="write a synthetic SVNL stream")
    r.add_argument("--log", required=True)
    r.add_argument("--frames", type=int, default=20)
    r.add_argument("--points", type=int, default=4000)
    r.add_argument("--seed", type=int, default=5)
    r.add_argument("--gt", default=None, help="write ground-truth poses .npy")
    r.add_argument("--proxy", action="store_true",
                   help="realistic proxy log: motion-distorted HDL-64 "
                        "raycast sweeps + noisy/biased 100 Hz IMU "
                        "(io/stream.record_proxy)")
    r.add_argument("--col-step", type=int, default=3,
                   help="proxy azimuth decimation (1 = full 2250 columns)")
    r.set_defaults(fn=cmd_record)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
