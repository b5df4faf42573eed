#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (svnicp_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, each printing its own line(s); any failure raises and exits non-zero:
1. device: the card's name, `nvidia-smi` name and power limit, TF32 off;
2. build: nvcc builds the five CUDA kernels (sm_90a) and g++ the host
   staging library, from the sources in this checkout; every kernel's
   ptxas registers and spills are printed, and none may spill;
3. kernels: each kernel's wrapper against its plain PyTorch version on the
   same inputs on the card, at the shapes of the three paths below and at
   ragged shapes with exact ties (B3 also at P=300 and 512), repeats
   bit-identical, with the kernel's time, the plain version's time and the
   bound (B1 at both k, B3 at both P, B4 also at configs/subt_mrs.yaml's
   shapes, B1 and B2 also on the features path's operands: P=10, K=32,
   B=4096); then one proxy sweep's feature selection and segmentation on
   the card against the CPU, and their device time;
4. main path: `LIOPipeline(configs/tpu_plane.yaml)` on 3 warm-up + 20 timed
   frames of the bench sequence (32,000-point scans of
   SyntheticWorld(extent=80, n_walls=24, n_boxes=16, seed=7)), with each
   kernel's launch count checked against what the path must make, every
   frame aligned and ATE against ground truth under the limit taken from the
   JAX package's own run (PLANE_ATE_LIMIT below), its iterations per frame
   beside that run's; then the cost of the host-side early-stop check per
   iteration;
5. GEODE-Alpha path: `LIOPipeline(configs/geode_alpha.yaml)` (the ESKF
   with IMU propagation and the point-to-point residual, kernels B1, B4,
   B3) on 3 warm-up + 20 timed frames of the JAX package's `cli demo`
   recipe (32,000-point scans of SyntheticWorld(extent=60, seed=7) along a
   trajectory that ramps up from rest, synthetic IMU samples fed before
   each scan), with the launch counts, every frame aligned, a non-zero
   Kalman gain and ATE under the limit taken from the JAX package's own run
   (GEODE_ATE_LIMIT below), its iterations per frame beside that run's;
6. SVGD path: `LIOPipeline(configs/generic_svgd.yaml)` with
   icp.use_pallas=True, the JAX package's kernel route for SVGD (P=30, Adam,
   per-point deskew; kernels B1 and B5), on 3 warm-up + 20 timed
   motion-distorted 32,000-point sweeps of SyntheticWorld(extent=60,
   seed=7) fed with their per-point times, with the launch counts, the
   frames aligned as in the JAX package's own run and ATE against the
   mid-sweep poses under the limit taken from that run (SVGD_ATE_LIMIT);
7. features path: `LIOPipeline(configs/tpu_features.yaml)` (LOAM feature
   selection on the raw sweep, deskew, point-to-plane, the ESKF with the
   cold-start bootstrap; kernels B1, B2, B3) on 3 warm-up + 20 timed frames
   of the JAX package's `cli record --proxy` recipe (`proxy_sequence`:
   ~44,000-point motion-distorted HDL-64 sweeps with their per-point times,
   a noisy 100 Hz IMU fed in arrival order), with the launch counts, the
   frames aligned as in the JAX package's own run, a non-zero Kalman gain,
   the picks per frame and ATE against the mid-sweep poses under the limit
   taken from that run (FEATURES_ATE_LIMIT), its iterations beside that
   run's;
8. SubT-fast path: `LIOPipeline(configs/subt_mrs_fast.yaml)` (host crop and
   stage-A downsample carrying the sweep times, the int16 upload, deskew on
   the device, stage-ahead; ICP estimator; kernels B1, B4, B3) on the same
   frames, with the same checks (SUBT_FAST_ATE_LIMIT).
Each path's launch counts are set to 0 just before it and read just after.
Each path prints its iterations per frame beside EARLIER_ITERS (those of
the first B2 and B3 kernels) and names the frames that moved; the SVGD
path, which runs neither, must repeat its count and the ATE of its B1 and
B5 (SVGD_ATE) exactly.
With `--profile`, a torch.profiler trace of 5 more frames of each path
(device-busy share, kernels by device time).
The last lines are the kernel table as JSON (`launches` summed over the
five paths), the line `nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader` prints, and {"ok": true, "device": {...}}. Without a
CUDA device it exits 2 and prints no result. It imports nothing of JAX or of
the JAX package. The whole run takes well under its 1200 s limit; if it ever
does not, the main path is to be cut in depth, not the GEODE-Alpha path or
the two paths of the raw-scan preprocessing.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM published peaks (dense, non-tensor FP32) and memory rate
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
WARMUP, TIMED = 3, 20
# The JAX package's own LIOPipeline on the GEODE-Alpha path's 23 frames, in
# float32 on the CPU (tests/test_torch_geode_reference.py, run as a
# script), reached this ATE [m]; the port on the card must stay under
# max(1.5 ATE, ATE + 0.05 m).
GEODE_JAX_ATE = 0.05608570797270728
GEODE_ATE_LIMIT = max(1.5 * GEODE_JAX_ATE, GEODE_JAX_ATE + 0.05)
# Iterations per frame of that script's run (its `iterations` output), printed
# beside the port's: float32 counts of these noisy frames depend on rounding,
# so they show how the port's spread sits around the JAX package's, not a
# bound. (This run's ATE was 0.0555 m: the JAX CPU run's rounding depends
# on the host it runs on.)
GEODE_JAX_ITERS = [0, 26, 15, 23, 17, 19, 22, 20, 25, 16, 18, 21, 18, 20, 13, 23, 19, 24,
                   23, 12, 25, 100, 20]
# The same for the main path (tests/test_torch_plane_reference.py):
# configs/tpu_plane.yaml on bench.py's 23 frames.
PLANE_JAX_ATE = 0.015401806072672613
PLANE_ATE_LIMIT = max(1.5 * PLANE_JAX_ATE, PLANE_JAX_ATE + 0.05)
PLANE_JAX_ITERS = [0, 8, 100, 25, 2, 4, 17, 80, 39, 14, 8, 13, 13, 13, 8, 17, 14, 27, 18,
                   3, 17, 14, 11]
# The same for the SVGD path (tests/test_torch_svgd_reference.py), whose
# frames the JAX run aligned as listed.
SVGD_JAX_ATE = 0.7128996366642155
SVGD_ATE_LIMIT = max(1.5 * SVGD_JAX_ATE, SVGD_JAX_ATE + 0.05)
SVGD_JAX_ALIGN_OK = [True] * 23
# The same for the features path (tests/test_torch_features_reference.py):
# configs/tpu_features.yaml on the 23 frames of proxy_sequence.
FEATURES_JAX_ATE = 0.03604090909697647
FEATURES_ATE_LIMIT = max(1.5 * FEATURES_JAX_ATE, FEATURES_JAX_ATE + 0.05)
FEATURES_JAX_ITERS = [0, 88, 5, 12, 10, 55, 6, 100, 36, 4, 78, 18, 7, 9, 4, 6, 6, 8, 9, 9, 10, 5, 8]
FEATURES_JAX_ALIGN_OK = [True] * 23
# The same for the SubT-fast path (tests/test_torch_subt_fast_reference.py):
# configs/subt_mrs_fast.yaml on the same frames.
SUBT_FAST_JAX_ATE = 0.17700382819413998
SUBT_FAST_ATE_LIMIT = max(1.5 * SUBT_FAST_JAX_ATE, SUBT_FAST_JAX_ATE + 0.05)
SUBT_FAST_JAX_ITERS = [0, 95, 100, 100, 100, 100, 100, 100, 81, 100, 100, 100, 100, 100, 100, 100, 100, 100, 100, 100, 100, 100, 100]
SUBT_FAST_JAX_ALIGN_OK = [True] * 23
# Iterations per frame of each path with the first B2 and B3 kernels (one
# block per ensemble with a bisection median; 8 particles per block), on
# the H100: a kernel that sums in another order may move a frame whose stop
# statistic sits at its threshold, so moved frames are printed, not refused.
# The SVGD path runs neither kernel and must repeat its count exactly (every
# frame at the cap).
EARLIER_ITERS = {
    "main": [0, 26, 51, 67, 100, 49, 100, 8, 34, 5, 39, 25, 17, 6, 21, 13, 4, 12,
             11, 5, 13, 7, 18],
    "geode": [0, 24, 23, 24, 15, 24, 18, 19, 19, 14, 19, 20, 17, 22, 22, 21, 17, 21,
              14, 19, 20, 19, 18],
    "svgd": [0] + [30] * 22,
}
# The SVGD path's ATE [m] at 4 decimals with the B1 and B5 kernels of this
# tree, to repeat exactly: its trajectory follows a few near-tie picks of
# stage 1, so another rounding of B1's score moves it (0.54-1.00 m under
# the plain B1 and two kernels, tools/torch_iterations_plain.py).
SVGD_ATE = 1.0009
# kernels whose ptxas report must show no spill
NO_SPILL = ("stein.cu", "plane_moments.cu", "point_moments.cu", "nn_match.cu", "stage1.cu")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int) -> float:
    """Mean wall time of fn() over `reps` back-to-back calls, by CUDA events:
    the wrapper's host work included, so a small kernel reads host-bound."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def device_ms(fn, reps: int, kernels=None) -> float:
    """Device time per call [ms] from torch.profiler over `reps` calls: with
    `kernels`, each of which launches once per call, the sum of their mean
    time per recorded launch; without, all CUDA kernel time over `reps`.
    The profiler can drop events (a trace once held 1 launch of 50, and a
    loop of bare ctypes launches 99 of 100), so a trace that holds fewer
    than half the launches of a kernel is taken again, up to three times.
    Raises if it stays short (a renamed kernel would drop out of the sum
    unseen) or holds no kernel: a wall time would be another quantity under
    the same name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = kernels or [""]   # "" is in every name
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        launches = {k: sum(e.count for e in events if k in e.key) for k in names}
        times = {k: sum(e.self_device_time_total for e in events if k in e.key) for k in names}
        short = {k: n for k, n in launches.items() if n < (reps + 1) // 2 or n == 0}
        if not short:
            if kernels is None:
                return times[""] / 1e3 / reps
            return sum(times[k] / launches[k] for k in names) / 1e3
    raise RuntimeError(f"the profiler recorded too few launches in {reps} calls: {short}")


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def bench_sequence(n_frames: int, n_points: int = 32000):
    """The bench.py recipe: scans, ground-truth rotations and translations."""
    from svnicp_tpu_torch.io import datasets

    world = datasets.SyntheticWorld(extent=80.0, n_walls=24, n_boxes=16, seed=7)
    times, rots, trans = datasets.synthetic_trajectory(n_frames, dt=0.1,
                                                       speed=2.0, seed=7)
    rng = np.random.default_rng(7)
    scans = [world.scan_at(rng, rots[i], trans[i], n_points=n_points, max_range=75.0)
             for i in range(n_frames)]
    return times, rots, trans, scans


def geode_sequence(n_frames: int, n_points: int = 32000):
    """The JAX package's `cli demo` recipe: scans, ground truth and IMU
    samples (t, acc, gyro) at the frame stamps."""
    from svnicp_tpu_torch.core.imu import GRAVITY
    from svnicp_tpu_torch.io import datasets

    world = datasets.SyntheticWorld(extent=60.0, seed=7)
    times, rots, trans = datasets.synthetic_trajectory(
        n_frames, dt=0.1, speed=1.5, seed=7, ramp_seconds=1.0)
    rng = np.random.default_rng(7)
    scans = [world.scan_at(rng, rots[i], trans[i], n_points=n_points)
             for i in range(n_frames)]
    return times, rots, trans, scans, datasets.synthetic_imu(times, rots, trans,
                                                             GRAVITY)


def svgd_sequence(n_frames: int, n_points: int = 32000):
    """The SVGD path's recipe: motion-distorted sweeps from pose i to pose
    i+1 of synthetic_trajectory(n_frames + 1, speed=2.0) -> (frame stamps,
    [(points, per-point times in [0,1])], mid-sweep rotations, translations)."""
    from svnicp_tpu_torch.io import datasets

    world = datasets.SyntheticWorld(extent=60.0, seed=7)
    times, rots, trans = datasets.synthetic_trajectory(n_frames + 1, dt=0.1,
                                                       speed=2.0, seed=7)
    rng = np.random.default_rng(7)
    sweeps, gt_r, gt_t = [], [], []
    for i in range(n_frames):
        pts, tau, (mr, mt) = world.scan_sweep(rng, rots[i], trans[i], rots[i + 1],
                                              trans[i + 1], n_points=n_points)
        sweeps.append((pts, tau))
        gt_r.append(mr)
        gt_t.append(mt)
    return times[:n_frames], sweeps, np.stack(gt_r), np.stack(gt_t)


def proxy_sequence(n_frames: int, seed: int = 5, col_step: int = 3):
    """The JAX package's `cli record --proxy` recipe (`io/stream.record_proxy`
    with every default: speed 1.5 m/s ramping up over 1 s, 100 Hz IMU with
    white noise and constant biases, HDL-64 raycast sweeps to 80 m with
    range noise 0.02 m and dropout 0.05 in 25 pose groups), in memory: one
    generator (seed + 1) draws the biases, then each sweep's dropout and
    noise and each IMU sample's noise in arrival order. Values are rounded
    to float32, as the log stores them, and each sweep's times min-max
    normalised, as the log reader does -> (events, mid-sweep rotations,
    translations); an event is ("imu", t, acc, gyro) or ("scan", mid-sweep
    stamp, points [N,3], per-point times [N] in [0,1])."""
    from svnicp_tpu_torch.core.imu import GRAVITY
    from svnicp_tpu_torch.io import datasets

    world = datasets.SyntheticWorld(extent=60.0, seed=seed)
    imu_dt, stride = 0.01, 10
    times, rots, trans = datasets.synthetic_trajectory(
        n_frames * stride + 2, dt=imu_dt, speed=1.5, seed=seed, ramp_seconds=1.0)
    clean_imu = datasets.synthetic_imu(times, rots, trans, GRAVITY)
    rng = np.random.default_rng(seed + 1)
    bg = rng.normal(scale=0.001, size=3)
    ba = rng.normal(scale=0.02, size=3)
    events, gt_r, gt_t = [], [], []
    for t, acc, gyro in clean_imu:
        while len(gt_r) < n_frames:
            i = len(gt_r)
            mid_stamp = (i * stride + stride / 2.0) * imu_dt
            if mid_stamp > t:
                break
            k0, k1 = i * stride, (i + 1) * stride
            pts, tau, (mid_r, mid_t) = datasets.raycast_sweep(
                world._surfaces, rots[k0], trans[k0], rots[k1], trans[k1],
                col_step=col_step, n_groups=25, noise=0.02, dropout=0.05,
                rng=rng, max_range=80.0)
            # the log reader min-max normalises the times in float64
            tau64 = tau.astype(np.float64)
            lo, hi = tau64.min(), tau64.max()
            tau = ((tau64 - lo) * (1.0 / (hi - lo))).astype(np.float32)
            events.append(("scan", float(mid_stamp), pts, tau))
            gt_r.append(mid_r)
            gt_t.append(mid_t)
        acc = acc + ba + rng.normal(scale=0.05, size=3)
        gyro = gyro + bg + rng.normal(scale=0.005, size=3)
        events.append(("imu", float(t), acc.astype(np.float32).astype(np.float64),
                       gyro.astype(np.float32).astype(np.float64)))
    return events, np.stack(gt_r), np.stack(gt_t)


def proxy_frames(events):
    """proxy_sequence's events as frames (stamp, points, [the IMU samples
    (t, acc, gyro) that arrive before the scan], per-point times); samples
    after the last scan are dropped."""
    frames, imus = [], []
    for ev in events:
        if ev[0] == "imu":
            imus.append(ev[1:])
        else:
            frames.append((ev[1], ev[2], imus, ev[3]))
            imus = []
    return frames


def svgd_config():
    """configs/generic_svgd.yaml on the JAX package's kernel route for SVGD
    (icp.use_pallas=True; the file leaves the XLA route on)."""
    import dataclasses

    from svnicp_tpu_torch import config as cfg_mod

    cfg = cfg_mod.from_yaml(os.path.join(ROOT, "configs", "generic_svgd.yaml"))
    return dataclasses.replace(cfg, icp=dataclasses.replace(cfg.icp, use_pallas=True))


# ------------------------------------------------------------------ B1 inputs

def stage1_inputs(cfg, scans, dev):
    """Main-path-shaped stage-1 inputs from real data: scans 0 and 1 inserted
    at the identity as the map (queried into target_capacity rows), scan 2's
    stage-B source cloud at the identity."""
    import torch

    from svnicp_tpu_torch.core import pointcloud as pc
    from svnicp_tpu_torch.core import voxmap
    from svnicp_tpu_torch.runtime import pipeline as pl

    eye = torch.eye(3, device=dev)
    zero = torch.zeros(3, device=dev)
    vm = voxmap.create(cfg.map.capacity, torch.float32, dev)
    for s in scans[:2]:
        pts = torch.from_numpy(s).to(dev)
        vm, _ = voxmap.insert(vm, pc.PaddedCloud(pts, torch.ones(len(s), dtype=torch.bool, device=dev)),
                              eye, zero, cfg.map.voxel_size,
                              cfg.map.max_points_per_voxel, cfg.map.max_range)
    target, _ = voxmap.query_radius(vm, zero, cfg.preprocess.max_range + 10.0,
                                    cfg.icp.target_capacity)
    raw = np.zeros((cfg.preprocess.raw_capacity, 3), np.float32)
    n = min(len(scans[2]), len(raw))
    raw[:n] = scans[2][:n]
    _, _, source, _ = pl._preprocess(cfg, pl.init_state(cfg, dev),
                                  torch.from_numpy(raw).to(dev),
                                  torch.arange(len(raw), device=dev) < n)
    return source.points, source.valid, target.points, target.valid


def check_stage1(name, src, sv, tgt, tv, k, rows):
    """Kernel vs plain: every slot's point within 1e-4 and its squared
    distance within 1e-4 max(|s|^2, 1), except slots where the two picked
    different targets; those must be near-ties (runner-up score within
    2e-6 max(|s|^2, 1) of the minimum, the scale of f32 rounding in
    |c|^2 - 2<s,c>) and fewer than 0.1% of the valid slots."""
    import torch

    from svnicp_tpu_torch.kernels import knn, nn

    cand_k, d2_k = nn.bucketed_candidates(src, tgt, sv, tv, k)
    torch.cuda.synchronize()
    cand_p, d2_p = nn.bucketed_candidates_plain(src, tgt, sv, tv, k)
    fin = torch.isfinite(d2_p)
    assert torch.equal(torch.isfinite(d2_k), fin), f"{name}: validity differs"
    scale = (src * src).sum(-1, keepdim=True).expand_as(d2_p).clamp_min(1.0)
    score, _ = knn.group_scores(src, tgt, tv, k)
    two = torch.topk(score, 2, dim=-1, largest=False).values
    del score
    near_tie = fin & ((two[..., 1] - two[..., 0]) <= 2e-6 * scale)
    pt_diff = (cand_k - cand_p).abs().amax(-1)
    differ = fin & (pt_diff > 1e-4)
    n_fin = max(int(fin.sum()), 1)
    same = fin & ~differ
    pt_err = pt_diff[same].max().item() if same.any() else 0.0
    d2_err = ((d2_k - d2_p).abs() / scale)[fin].max().item() if fin.any() else 0.0
    n_differ, n_tie = int(differ.sum()), int(near_tie.sum())
    print(f"kernel B1 stage1 {name}: max|pts| {pt_err:.3g} on agreeing slots, "
          f"max|d2|/max(|s|^2,1) {d2_err:.3g}; slots picking another target "
          f"{n_differ} ({100 * n_differ / n_fin:.4f}%), near-tie slots {n_tie} "
          f"({100 * n_tie / n_fin:.4f}%)")
    assert pt_err <= 1e-4 and d2_err <= 1e-4, f"{name}: B1 disagrees"
    assert bool((near_tie | ~differ).all()), f"{name}: a non-tie slot differs"
    assert n_differ < 1e-3 * n_fin, f"{name}: too many differing slots"
    d2_abs = (d2_k - d2_p).abs()[fin].max().item() if fin.any() else 0.0
    rows.append(max(pt_err, d2_abs))
    return pt_err


# ------------------------------------------------------------------ B2 inputs

def tied_moments_inputs(icp, p, b, k, dev, seed):
    """Synthetic operands with exact ties, prepared as `icp`'s residual is
    on its path (plane fits for B2, K padded to a multiple of 8): candidate
    k of point b sits 0.1 + 0.1 k m from the point at the guess, particles
    perturb the guess by ~1 mm (and 1e-5 rad), a sixth of the points have
    all candidates beyond the gate and ~8% of the candidate slots are
    invalid. Then candidate 1 takes candidate 0's score features, so the two
    tie at the minimum wherever candidate 0 is valid, but keeps the first
    row of the averaged operand 5 cm larger (n.q for B2, x for B4): the
    tie-averaged answer differs from either one's."""
    import torch

    from svnicp_tpu_torch.core import geometry as geo
    from svnicp_tpu_torch.core import svn

    g = torch.Generator().manual_seed(seed)
    src = (torch.rand((b, 3), generator=g) - 0.5) * 60.0
    dirs = torch.randn((b, k, 3), generator=g)
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    radius = 0.1 + 0.1 * torch.arange(k, dtype=torch.float32)
    radius = radius[None, :].repeat(b, 1)
    radius[: b // 6] += 2.0
    cand = src[:, None, :] + dirs * radius[..., None]
    cvalid = torch.rand((b, k), generator=g) > 0.08
    cvalid[b // 6: b // 6 + 3] = False
    valid = torch.rand(b, generator=g) > 0.1
    xi = torch.randn((p, 6), generator=g) * torch.tensor([1e-3] * 3 + [1e-5] * 3)
    r = geo.so3_exp(xi[:, 3:])
    params = torch.cat([r.reshape(p, 9), xi[:, :3]], dim=-1)
    src, cand, cvalid, valid, params = (
        x.to(dev) for x in (src, cand, cvalid, valid, params))
    prep = svn._prepare_align(icp, src, valid, cand, cvalid)
    prep.feat13[:, 1] = prep.feat13[:, 0]
    avg = prep.averaged
    avg[..., 1, :] = avg[..., 0, :]
    avg.view(-1, *avg.shape[-2:])[0, 1] += 0.05
    return params.contiguous(), prep


def main_path_moments_inputs(icp, src, sv, tgt, tv, dev):
    """A path's own operands: the stage-1 candidates of the B1 inputs at the
    path's k, the path's prep (plane fits for B2, K padded to a multiple of
    8 for both) and the path's P particles drawn in the prior box."""
    import torch

    from svnicp_tpu_torch.core import geometry as geo
    from svnicp_tpu_torch.core import svn
    from svnicp_tpu_torch.kernels import nn

    p = icp.particle_count
    cand, d2 = nn.bucketed_candidates(src, tgt, sv, tv, icp.knn_count)
    prep = svn._prepare_align(icp, src, sv, cand, torch.isfinite(d2))
    g = torch.Generator().manual_seed(4)
    lo, hi = torch.tensor(icp.init_lb), torch.tensor(icp.init_ub)
    draw = lo + (hi - lo) * torch.rand((p, 6), generator=g)
    params = torch.cat([geo.so3_exp(draw[:, 3:]).reshape(p, 9), draw[:, :3]], -1)
    return params.to(dev).contiguous(), prep


def _double(prep):
    return type(prep)(*(x.double() for x in prep))


def _first_index(prep):
    """The float64 prep whose answer a first-index tie rule gives: candidate
    1 (tied with candidate 0) carries candidate 0's averaged values."""
    first = _double(prep)
    first.averaged[..., 1, :] = first.averaged[..., 0, :]
    return first


def check_moments(name, params, prep, max_dist, rows, ties=False):
    """Kernel vs plain on the same operands (B2 or B4, by the prep's type),
    both held to the plain version run in float64: the kernel's largest
    error in H (and in b) must be at most twice the float32 plain
    version's, plus 1e-7 of the largest entry. A fixed rtol does not fit b:
    each term carries a residual that is a difference of two numbers of the
    size of |s| (n.(T s) - n.q, or T s - q), so in float32 both versions
    carry ~1e-5 relative error in it, and b sums such terms of both signs.
    The kernel sums its tiles in a fixed order, so a repeat run must give
    the same bits. With `ties` (candidates 0 and 1 tied, see
    tied_moments_inputs) the kernel's b must also lie ten times farther from
    the first-index answer than from the tie-averaged one."""
    import torch

    from svnicp_tpu_torch.kernels import nn

    kernel, plain = nn.MOMENTS[type(prep)]
    key = next(k for k, v in KERNELS.items() if v[0] == f"nn.{kernel.__name__}")
    label = f"{key} {kernel.__name__}"
    h_k, b_k = nn.moments(params, prep, max_dist)
    torch.cuda.synchronize()
    h_p, b_p = plain(params, prep, max_dist)
    h_k2, b_k2 = nn.moments(params, prep, max_dist)
    assert torch.equal(h_k, h_k2) and torch.equal(b_k, b_k2), \
        f"{name}: {label} is not deterministic"
    h64, b64 = plain(params.double(), _double(prep), max_dist)

    def err(a, ref):
        return (a.double() - ref).abs().max().item()

    ek_h, ep_h, ek_b, ep_b = err(h_k, h64), err(h_p, h64), err(b_k, b64), err(b_p, b64)
    abs_err = max((h_k - h_p).abs().max().item(), (b_k - b_p).abs().max().item())
    print(f"kernel {label} {name}: max|kernel-plain| {abs_err:.3g}; "
          f"max error vs float64: H kernel {ek_h:.3g} plain {ep_h:.3g} "
          f"(max|H| {h64.abs().max().item():.3g}), b kernel {ek_b:.3g} plain "
          f"{ep_b:.3g} (max|b| {b64.abs().max().item():.3g}); repeat run bit-identical")
    assert ek_h <= 2 * ep_h + 1e-7 * h64.abs().max().item(), f"{name}: {label} H"
    assert ek_b <= 2 * ep_b + 1e-7 * b64.abs().max().item(), f"{name}: {label} b"
    if ties:
        e_first = err(b_k, plain(params.double(), _first_index(prep), max_dist)[1])
        print(f"kernel {label} {name}: b is {e_first:.3g} from the "
              f"first-index answer, {ek_b:.3g} from the tie-averaged one")
        assert e_first > 10 * ek_b, f"{name}: {label} does not average ties"
    rows.append(abs_err)
    return abs_err


# ------------------------------------------------------------------ B5 inputs

def svgd_match_inputs(icp, src, sv, tgt, tv, dev):
    """The SVGD path's own B5 operands: the stage-1 candidates of the B1
    inputs at the path's k, the per-frame prep of the SVGD loop and P
    particles drawn in the prior box as [vec(R), t] of their Euler angles."""
    import torch

    from svnicp_tpu_torch.core import geometry as geo
    from svnicp_tpu_torch.core import svgd
    from svnicp_tpu_torch.kernels import nn

    p = icp.particle_count
    cand, d2 = nn.bucketed_candidates(src, tgt, sv, tv, icp.knn_count)
    prep = svgd.prepare(src, sv, cand, torch.isfinite(d2))
    g = torch.Generator().manual_seed(6)
    lo, hi = torch.tensor(icp.init_lb), torch.tensor(icp.init_ub)
    draw = lo + (hi - lo) * torch.rand((p, 6), generator=g)
    r = geo.euler_zyx_to_matrix(draw[:, 3], draw[:, 4], draw[:, 5])
    params = torch.cat([r.reshape(p, 9), draw[:, :3]], -1)
    return params.to(dev).contiguous(), prep


def check_nn_match(name, params, prep, rows, ties=False):
    """B5 against the plain version run in float64 on the same operands
    (the float32 plain version's figures beside it). Where both are finite
    the kernel's best score must be within twice the float32 plain
    version's largest error plus 1e-6 of the largest |score|. A pair whose
    matched point differs from float64's by more than 1e-4 m picked another
    candidate: it must be a near-tie in float64 (runner-up score within
    1e-5 max(|T s|^2, 1) of the minimum, the scale of float32 rounding in
    the 13-term score) and such pairs fewer than 0.1%; every other pair's
    point within 1e-4 m. Pairs whose best is +inf (no valid candidate)
    must agree in that and are not compared further: their point is gated
    out downstream. A repeat run must give the same bits. With `ties`
    (candidates 0 and 1 tied, see tied_moments_inputs) the kernel's points
    must lie ten times farther from the first-index answer than from the
    tie-averaged one."""
    import torch

    from svnicp_tpu_torch.kernels import nn

    m_k, b_k = nn.nn_match(params, prep)
    torch.cuda.synchronize()
    m_k2, b_k2 = nn.nn_match(params, prep)
    assert torch.equal(m_k, m_k2) and torch.equal(b_k, b_k2), \
        f"{name}: B5 nn_match is not deterministic"
    m_p, b_p = nn.nn_match_plain(params, prep)
    p64 = params.double()
    m64, b64 = nn.nn_match_plain(p64, _double(prep))
    fin = torch.isfinite(b64)
    assert torch.equal(torch.isfinite(b_k), fin), f"{name}: B5 validity differs"
    rot, trn = p64[:, :9].reshape(-1, 3, 3), p64[:, 9:]
    ts = torch.einsum("pij,jb->pbi", rot, _double(prep).src_t) + trn[:, None, :]
    scale = (ts * ts).sum(-1).clamp_min(1.0)
    params13 = torch.cat([p64, p64.new_ones((p64.shape[0], 1))], dim=-1)
    score = torch.einsum("pc,ckb->pkb", params13, prep.feat13.double())
    two = torch.topk(score, 2, dim=1, largest=False).values
    del score
    near_tie = fin & ((two[:, 1] - two[:, 0]) <= 1e-5 * scale)

    def split(m):
        diff = (m.double() - m64).abs().amax(-1)
        differ = fin & (diff > 1e-4)
        same = fin & ~differ
        return differ, (diff[same].max().item() if same.any() else 0.0)

    differ_k, pt_k = split(m_k)
    differ_p, pt_p = split(m_p)
    n_fin = max(int(fin.sum()), 1)
    top = b64[fin].abs().max().item() if fin.any() else 1.0
    eb_k = (b_k.double() - b64)[fin].abs().max().item() if fin.any() else 0.0
    eb_p = (b_p.double() - b64)[fin].abs().max().item() if fin.any() else 0.0
    print(f"kernel B5 nn_match {name}: max error vs float64 on finite pairs: best "
          f"kernel {eb_k:.3g} plain {eb_p:.3g} (max|best| {top:.3g}), point "
          f"kernel {pt_k:.3g} plain {pt_p:.3g} m on agreeing pairs; pairs "
          f"matching another candidate: kernel {int(differ_k.sum())} plain "
          f"{int(differ_p.sum())} of {n_fin} ({int(near_tie.sum())} near-ties); "
          f"repeat run bit-identical")
    assert eb_k <= 2 * eb_p + 1e-6 * top, f"{name}: B5 best"
    assert pt_k <= 1e-4, f"{name}: B5 matched points"
    assert bool((near_tie | ~differ_k).all()), f"{name}: B5 differs at a non-tie"
    assert int(differ_k.sum()) < 1e-3 * n_fin, f"{name}: B5 too many differing pairs"
    if ties:
        first = _first_index(prep)
        m_first, _ = nn.nn_match_plain(p64, first)
        e_first = (m_k.double() - m_first).abs()[fin].max().item()
        e_avg = (m_k.double() - m64).abs()[fin].max().item()
        print(f"kernel B5 nn_match {name}: points are {e_first:.3g} m from the "
              f"first-index answer, {e_avg:.3g} m from the tie-averaged one")
        assert e_first > 10 * e_avg, f"{name}: B5 does not average ties"
    err = max((m_k - m_p).abs()[fin].max().item() if fin.any() else 0.0,
              (b_k - b_p).abs()[fin].max().item() if fin.any() else 0.0)
    rows.append(err)
    return err


def match_bound(params, prep, k: int) -> tuple[float, str]:
    """What the 1-NN match needs: each of the k stage-1 candidate slots'
    3 coordinates and |c|^2 (+inf marks an invalid slot) read once, the
    particles, and 4 floats written per (particle, point); 8 operations per
    (particle, valid slot) for |c|^2 - 2 c.(T s), 15 per (particle, real
    point) for T s."""
    import torch

    p, b = params.shape[0], prep.vmask.shape[0]
    n_slots = int(torch.isfinite(prep.feat13[12]).sum())
    n_pts = int((prep.vmask > 0).sum())
    nbytes = b * k * 16 + p * 12 * 4 + p * b * 16
    flops = p * (8.0 * n_slots + 15.0 * n_pts)
    return bound_ms(flops, nbytes)


# ------------------------------------------------------------------ B3 inputs

def stein_inputs(p, dev, seed):
    import torch

    from svnicp_tpu_torch.core import geometry as geo

    g = torch.Generator().manual_seed(seed)
    a = torch.randn((p, 6, 6), generator=g)
    hess = a @ a.transpose(1, 2) + 10.0 * torch.eye(6)
    b = torch.randn((p, 6), generator=g)
    r = geo.so3_exp(0.1 * torch.randn((p, 3), generator=g))
    t = 0.5 * torch.randn((p, 3), generator=g)
    prior = torch.stack([torch.full((6,), 3.0), torch.full((6,), 0.5)])
    return [x.to(dev).contiguous() for x in (hess, b, r, t, prior)]


def check_stein(name, hess, b, r, t, prior, rows):
    """B3 against its plain version with and without the prior (rtol and
    atol 2e-5); a repeat run must give the same bits."""
    import torch

    from svnicp_tpu_torch.kernels import stein

    worst = 0.0
    for pr in (None, prior):
        out_k = stein.stein_update(hess, b, r, t, pr, max_dist=3.0)
        torch.cuda.synchronize()
        out_p = stein.stein_update_plain(hess, b, r, t, pr, max_dist=3.0)
        for a, e in zip(out_k, out_p):
            torch.testing.assert_close(a, e, rtol=2e-5, atol=2e-5)
            worst = max(worst, (a - e).abs().max().item())
        out_k2 = stein.stein_update(hess, b, r, t, pr, max_dist=3.0)
        assert all(torch.equal(a, c) for a, c in zip(out_k, out_k2)), \
            f"{name}: B3 is not deterministic"
    print(f"kernel B3 stein_update {name} (with and without prior): "
          f"max|d| {worst:.3g} (rtol 2e-5, atol 2e-5); repeat run bit-identical")
    rows.append(worst)
    return worst


def stein_bound(p: int) -> tuple[float, str]:
    """What the Stein update needs, not the kernel's way of doing it: per
    particle ~400 operations (prior, 6x6 Cholesky solve, so3 log/exp, clip,
    update); per pair 18 for its squared distance, counted once, 3 for a
    linear-time selection of the lower median, and 60 for the RBF kernel,
    its gradient and the two kernel sums; the operands read and written
    once."""
    return bound_ms(400.0 * p + (18.0 + 3.0 + 60.0) * p * p,
                    p * (36 + 6 + 9 + 3 + 9 + 3) * 4 + 8)


def time_stein(hess, b, r, t) -> dict:
    """B3's device time (profiler), wrapper time back to back, plain time
    and bound on one ensemble, without the prior."""
    from svnicp_tpu_torch.kernels import stein

    def kernel():
        return stein.stein_update(hess, b, r, t, None, max_dist=3.0)

    b_ms, b_by = stein_bound(hess.shape[0])
    return dict(ms=device_ms(kernel, 200, ["stein_kernel"]),
                call_ms=cuda_time_ms(kernel, 200),
                plain_ms=device_ms(lambda: stein.stein_update_plain(
                    hess, b, r, t, None, max_dist=3.0), 20),
                bound_ms=b_ms, bound_by=b_by)


def check_ptxas(log_by_source: dict) -> None:
    """Print every kernel function's ptxas register and spill lines; the
    kernels of NO_SPILL must report 0 bytes of spill stores and loads."""
    import re

    spills = []
    for src, log in sorted(log_by_source.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Function properties" in line:
                print(f"  ptxas {src}: {line.strip()}")
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and src in NO_SPILL and not m.group(1) == m.group(2) == "0":
                spills.append(f"{src}: {line.strip()}")
    assert not spills, f"spills: {spills}"
    for src in NO_SPILL:
        assert "spill stores" in log_by_source.get(src, ""), f"no ptxas report for {src}"


def early_stop_cost(cfg, src, sv, tgt, tv, dev) -> float:
    """Cost of the host-side early stop: one registration of the main path's
    shapes run for 100 iterations with the stop statistic read back every
    iteration (threshold 0, so it never stops) and with early stop off (no
    read until the end). Returns the difference per iteration [ms]."""
    import dataclasses

    import torch

    from svnicp_tpu_torch.core import svn

    g = torch.Generator(device=dev).manual_seed(5)
    lb = torch.tensor(cfg.icp.init_lb, device=dev)
    ub = torch.tensor(cfg.icp.init_ub, device=dev)
    init = lb + (ub - lb) * torch.rand((cfg.icp.particle_count, 6), generator=g,
                                       device=dev)
    eye, zero = torch.eye(3, device=dev), torch.zeros(3, device=dev)

    def run(icp) -> float:
        def once():
            res = svn.register(icp, src, sv, tgt, tv, eye, zero, init)
            assert res.iterations == 100
            float(res.mean[0])

        once()
        t0 = time.perf_counter()
        for _ in range(3):
            once()
        return (time.perf_counter() - t0) / 3 * 1e3

    checked = run(dataclasses.replace(cfg.icp, iterations=100,
                                      convergence_threshold=0.0))
    unchecked = run(dataclasses.replace(cfg.icp, iterations=100, early_stop=False))
    per_iter = (checked - unchecked) / 100
    print(f"early stop: 100 iterations {checked:.2f} ms with the per-iteration "
          f"host check, {unchecked:.2f} ms without; {per_iter * 1e3:.1f} us per "
          f"iteration for the check")
    return per_iter


KERNELS = {  # key: (wrapper path in the port, JSON name, source, TPU kernel)
    "B1": ("nn.bucketed_candidates", "stage1_candidates",
           "svnicp_tpu_torch/csrc/stage1.cu", "svnicp_tpu/kernels/nn_pallas.py:563"),
    "B2": ("nn.plane_moments", "plane_moments",
           "svnicp_tpu_torch/csrc/plane_moments.cu", "svnicp_tpu/kernels/nn_pallas.py:412"),
    "B3": ("stein.stein_update", "stein_update",
           "svnicp_tpu_torch/csrc/stein.cu", "svnicp_tpu/kernels/stein_pallas.py:227"),
    "B4": ("nn.point_moments", "point_moments",
           "svnicp_tpu_torch/csrc/point_moments.cu", "svnicp_tpu/kernels/nn_pallas.py:254"),
    "B5": ("nn.nn_match", "nn_match",
           "svnicp_tpu_torch/csrc/nn_match.cu", "svnicp_tpu/kernels/nn_pallas.py:65"),
}


def _wrapper(key):
    from svnicp_tpu_torch.kernels import nn, stein

    mod, name = KERNELS[key][0].split(".")
    return getattr({"nn": nn, "stein": stein}[mod], name)


def feed(pipe, frames, lo: int, hi: int) -> None:
    """Feed frames lo..hi-1, each (t, scan, IMU samples, per-point times or
    None): the IMU samples first, as a sensor stream delivers them before
    the scan they end."""
    for t, scan, imus, tau in frames[lo:hi]:
        for sample in imus:
            pipe.feed_imu(*sample)
        pipe.feed_scan(float(t), scan, timestamps=tau)


def run_path(cfg, frames):
    """A fresh LIOPipeline on the card over WARMUP + TIMED frames, with every
    kernel's launch count set to 0 just before and read just after ->
    (pipeline, timed wall seconds, launches)."""
    import torch

    from svnicp_tpu_torch.runtime import pipeline as pl

    pipe = pl.LIOPipeline(cfg, device="cuda")
    for key in KERNELS:
        _wrapper(key).launches = 0
    feed(pipe, frames, 0, WARMUP)
    pipe.flush()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    feed(pipe, frames, WARMUP, WARMUP + TIMED)
    pipe.flush()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    pipe.close()
    return pipe, dt, {key: _wrapper(key).launches for key in KERNELS}


def report_path(name, pipe, dt, launches, rots, trans, smi, earlier,
                align_ok=None, scans="32,000-point scans") -> float:
    """Print a path's frames/s, iterations (beside `earlier`, the first
    kernels' counts, naming the frames that moved; None for a path those
    kernels never ran), align_ok, ATE and launches and check what every
    path must show (every frame aligned, or those of `align_ok`) -> ATE [m]."""
    from svnicp_tpu_torch.io import metrics

    n = WARMUP + TIMED
    outs = pipe.outputs
    iters = [o.icp_iterations for o in outs]
    traj = pipe.trajectory()
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, :3, :3] = rots
    gt[:, :3, 3] = trans
    ate = metrics.ate_rmse(traj, gt)
    print(f"{name}: {TIMED / dt:.2f} frames/s over {TIMED} timed frames "
          f"({scans}) [{smi}]")
    print(f"iterations per frame: {iters}")
    if earlier is not None:
        moved = [(i, a, b) for i, (a, b) in enumerate(zip(earlier, iters)) if a != b]
        print(f"iterations: {sum(iters)} against {sum(earlier)} with the first B2/B3 "
              f"kernels; frames moved (frame, before, now): {moved}")
    print(f"align_ok per frame: {[o.align_ok for o in outs]}")
    print(f"ATE {ate:.4f} m over {n} frames; launches {launches}; "
          f"stage times {pipe.timer.report()}")
    assert len(outs) == n, len(outs)
    assert launches["B1"] == n - 1, launches
    want_ok = [True] * n if align_ok is None else list(align_ok)
    assert [o.align_ok for o in outs] == want_ok, want_ok
    assert np.isfinite(traj).all()
    return ate


def print_jax_iters(name, jax_iters, pipe) -> None:
    """Print the JAX package's float32 iterations per frame beside the port's
    and the frames where they differ (rounding moves whole frames; not a bound)."""
    moved = [(i, a, o.icp_iterations) for i, (a, o) in enumerate(zip(jax_iters, pipe.outputs))
             if a != o.icp_iterations]
    print(f"{name}: the JAX package's float32 run took {sum(jax_iters)} iterations "
          f"{jax_iters}; frames that differ from it (frame, JAX, port): {moved}")


def profile_frames(cfg, frames, first: int, count: int) -> None:
    """torch.profiler over `count` frames of a fresh pipeline (after `first`
    warm-up frames): device-busy share of the window and kernels by time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from svnicp_tpu_torch.runtime import pipeline as pl

    pipe = pl.LIOPipeline(cfg, device="cuda")
    feed(pipe, frames, 0, first)
    pipe.flush()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        feed(pipe, frames, first, first + count)
        pipe.flush()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    pipe.close()
    iters = sum(o.icp_iterations for o in pipe.outputs[first:])
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e6
    print(f"profile: {count} frames ({iters} iterations) in {wall * 1e3:.1f} ms wall, "
          f"device busy {busy * 1e3:.1f} ms ({100 * busy / wall:.1f}%), "
          f"idle {100 * (1 - busy / wall):.1f}%")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<6d} {e.key[:90]}")


def sweep_buffers(cap: int, frame) -> list:
    """A proxy frame's sweep padded into the raw route's buffers -> CPU
    tensors [points [cap,3], valid [cap], times [cap]]."""
    import torch

    _, pts, _, tau = frame
    n = min(len(pts), cap)
    buf = np.zeros((cap, 3), np.float32)
    buf[:n] = pts[:n]
    ts = np.zeros(cap, np.float32)
    ts[:n] = tau[:n]
    return [torch.from_numpy(a) for a in (buf, np.arange(cap) < n, ts)]


def compare_preprocess(cfg, frame, dev) -> tuple[int, int, int, int, list]:
    """One proxy sweep through the configured feature selection and through
    range-image segmentation, on the card and on the CPU, both computed
    with the same float32 steps (glibc's atan2f written out, fused
    multiply-adds exact), so the picks are expected identical; a pick that
    differs must come from the card's rounding, and such picks must stay
    under 1% -> (selection picks that differ, picks, segmented points that
    differ, points, [(card, CPU) n_edge, n_planar, n_ground])."""
    from svnicp_tpu_torch.core import segmentation as seg
    from svnicp_tpu_torch.runtime import pipeline as pl

    pp = cfg.preprocess
    cap = pp.raw_capacity
    host = sweep_buffers(cap, frame)
    card = [a.to(dev) for a in host]
    sensor = seg.SENSORS[pp.sensor_model]

    def differing(a_pts, a_valid, b_pts, b_valid) -> int:
        same = (a_valid == b_valid) & ((a_pts - b_pts).abs().amax(-1) == 0)
        return int((~same & (a_valid | b_valid)).sum())

    want = pl.select_features(cfg, *host)
    got = pl.select_features(cfg, *card)
    n_sel = int(want.valid.sum())
    d_sel = differing(got.points.cpu(), got.valid.cpu(), want.points, want.valid)
    counts = [(int(a), int(b)) for a, b in zip(got[3:], want[3:])]
    cloud_w, _ = seg.segment_cloud(*host[:2], sensor, cap, timestamps=host[2])
    cloud_g, _ = seg.segment_cloud(*card[:2], sensor, cap, timestamps=card[2])
    n_seg = int(cloud_w.valid.sum())
    d_seg = differing(cloud_g.points.cpu(), cloud_g.valid.cpu(), cloud_w.points,
                      cloud_w.valid)
    assert n_sel > 500 and n_seg > 1000, (n_sel, n_seg)
    assert d_sel <= 0.01 * n_sel and d_seg <= 0.01 * n_seg, (d_sel, d_seg)
    return d_sel, n_sel, d_seg, n_seg, counts


def check_preprocess(cfg, frames, dev, smi) -> None:
    """`compare_preprocess` on two proxy sweeps (the card's first call
    captures the selection's CUDA graph, the second replays it on new
    inputs), then the selection's and the projection's device time and the
    selection's time per call."""
    from svnicp_tpu_torch.core import features
    from svnicp_tpu_torch.core import segmentation as seg
    from svnicp_tpu_torch.runtime import pipeline as pl

    for frame in frames:
        d_sel, n_sel, d_seg, n_seg, counts = compare_preprocess(cfg, frame, dev)
        print(f"preprocess on the card vs the CPU, one {len(frame[1])}-point sweep: "
              f"select_features {d_sel} of {n_sel} picks differ, (n_edge, n_planar, "
              f"n_ground) card/CPU {counts}; segment_cloud {d_seg} of {n_seg} "
              f"points differ")
    pp = cfg.preprocess
    cap = pp.raw_capacity
    card = [a.to(dev) for a in sweep_buffers(cap, frames[0])]
    sensor = seg.SENSORS[pp.sensor_model]
    sel_ms = device_ms(lambda: pl.select_features(cfg, *card), 10)
    sel_call = cuda_time_ms(lambda: pl.select_features(cfg, *card), 10)
    # the selection launched op by op, as before it became one graph
    opts = pl.selection_options(cfg)
    sel_ops = cuda_time_ms(lambda: features.select_features_ops(*card, **opts), 10)
    proj_ms = device_ms(lambda: seg.project(card[0], card[1], sensor, card[2]), 10)
    seg_ms = device_ms(lambda: seg.segment_cloud(*card[:2], sensor, cap), 3)
    print(f"time select_features: {sel_ms:.4f} ms on the device per sweep "
          f"({sel_call:.4f} ms per call back to back, one CUDA graph; {sel_ops:.4f} "
          f"ms per call launched op by op), of which project {proj_ms:.4f} ms; "
          f"segment_cloud {seg_ms:.4f} ms on the device  [{smi}]")


def moments_bound(params, prep, k: int, point_floats: int, slot_ops: float,
                  point_ops: float) -> tuple[float, str]:
    """What a moments function (B2, B4) needs on this run's data, not the
    kernels' operand layout (13 prepared floats per slot). Bytes: the mask
    byte of each of the b rows; for each row the mask keeps, the k stage-1
    candidate slots once (3 coordinates and a validity byte, read in the
    coordinate form score = |c|^2 - 2 c.(T s)) and `point_floats` floats;
    the particles read and H and b written. Operations, counted where the
    work lies (kept rows, valid slots of those): 8 per (particle, slot) for
    the score, `slot_ops` per slot once for all particles (|c|^2, and n.c
    for B2), 15 per (particle, point) for T s and `point_ops` for the tie
    average, residual, weight and moments."""
    import torch

    p, b = params.shape[0], prep.vmask.shape[0]
    kept = prep.vmask > 0
    n_slots = int((torch.isfinite(prep.feat13[12]) & kept).sum())
    n_pts = int(kept.sum())
    nbytes = b + n_pts * (k * (3 * 4 + 1) + point_floats * 4) + p * (12 + 42) * 4
    flops = p * (8.0 * n_slots + (15.0 + point_ops) * n_pts) + slot_ops * n_slots
    return bound_ms(flops, nbytes)


def main() -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace 5 frames of each path with torch.profiler "
                         "and print the device-busy share and the kernels by "
                         "device time")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    from svnicp_tpu_torch import config as cfg_mod
    from svnicp_tpu_torch import resolve_device
    from svnicp_tpu_torch.io import native
    from svnicp_tpu_torch.kernels import _build, nn

    # ---- 1. device
    dev = resolve_device("cuda")
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    print(f"device: {kind} x{torch.cuda.device_count()}  nvidia-smi: {smi}  "
          f"torch {torch.__version__} cuda {torch.version.cuda}  TF32 off")

    # ---- 2. build
    t0 = time.perf_counter()
    _build.build_all()
    native.library()
    print(f"build: {len(_build.CUDA_SOURCES)} CUDA kernels (nvcc sm_90a, in "
          f"parallel) + host staging (g++) in {time.perf_counter() - t0:.1f} s")
    check_ptxas(_build.build_log)

    cfg = cfg_mod.from_yaml(os.path.join(ROOT, "configs", "tpu_plane.yaml"))
    gcfg = cfg_mod.from_yaml(os.path.join(ROOT, "configs", "geode_alpha.yaml"))
    scfg = cfg_mod.from_yaml(os.path.join(ROOT, "configs", "subt_mrs.yaml"))
    vcfg = svgd_config()
    fcfg = cfg_mod.from_yaml(os.path.join(ROOT, "configs", "tpu_features.yaml"))
    sfcfg = cfg_mod.from_yaml(os.path.join(ROOT, "configs", "subt_mrs_fast.yaml"))
    n_frames = WARMUP + TIMED
    times, rots, trans, scans = bench_sequence(n_frames)
    gtimes, grots, gtrans, gscans, gimu = geode_sequence(n_frames)
    vtimes, vsweeps, vgt_r, vgt_t = svgd_sequence(n_frames)
    events, pgt_r, pgt_t = proxy_sequence(n_frames)
    pframes = proxy_frames(events)
    del events
    icp, gicp = cfg.icp, gcfg.icp
    p, k = icp.particle_count, icp.knn_count

    # ---- 3. kernels vs plain
    table = {}
    errs = {key: [] for key in KERNELS}
    src, sv, tgt, tv = stage1_inputs(cfg, scans, dev)
    check_stage1(f"main B={src.shape[0]} Nt={tgt.shape[0]} k={k}",
                 src, sv, tgt, tv, k, errs["B1"])
    gsrc, gsv, gtgt, gtv = stage1_inputs(gcfg, gscans, dev)
    gk = gicp.knn_count
    check_stage1(f"geode B={gsrc.shape[0]} Nt={gtgt.shape[0]} k={gk}",
                 gsrc, gsv, gtgt, gtv, gk, errs["B1"])
    g = torch.Generator().manual_seed(3)
    rs = torch.randn((300, 3), generator=g).mul(20).to(dev)
    rt = torch.randn((5000, 3), generator=g).mul(20).to(dev)
    check_stage1("ragged B=300 Nt=5000 k=12", rs, torch.rand(300, generator=g).to(dev) > 0.1,
                 rt, torch.rand(5000, generator=g).to(dev) > 0.2, 12, errs["B1"])

    def time_stage1(s_, sv_, t_, tv_, k_):
        n_src, n_tgt = int(sv_.sum()), int(tv_.sum())
        call = cuda_time_ms(lambda: nn.bucketed_candidates(s_, t_, sv_, tv_, k_), 20)
        # both launches: the target prep and the search
        ms = device_ms(lambda: nn.bucketed_candidates(s_, t_, sv_, tv_, k_), 20,
                       ["stage1_prep_kernel", "stage1_kernel"])
        plain = device_ms(lambda: nn.bucketed_candidates_plain(s_, t_, sv_, tv_, k_), 5)
        b_ms, b_by = bound_ms(8.0 * n_src * n_tgt,
                              s_.numel() * 4 + sv_.numel() + t_.numel() * 4 + tv_.numel()
                              + s_.shape[0] * k_ * 16)
        return dict(ms=ms, call_ms=call, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)

    table["B1"] = time_stage1(src, sv, tgt, tv, k)
    table[f"B1 (geode k={gk})"] = time_stage1(gsrc, gsv, gtgt, gtv, gk)

    params, prep = main_path_moments_inputs(icp, src, sv, tgt, tv, dev)
    check_moments(f"main P={p} B={icp.source_capacity} K={k}", params, prep,
                  icp.max_dist, errs["B2"])
    params_r, prep_r = tied_moments_inputs(icp, 10, 300, 12, dev, seed=12)
    check_moments(f"ragged P=10 B=300 K={prep_r.feat13.shape[1]} with ties",
                  params_r, prep_r, icp.max_dist, errs["B2"], ties=True)

    def time_plane_moments(params_, prep_, icp_):
        md = icp_.max_dist
        call = cuda_time_ms(lambda: nn.plane_moments(params_, prep_, md), 50)
        # both launches: the moments and the pass that sums the tiles into H, b
        ms = device_ms(lambda: nn.plane_moments(params_, prep_, md), 50,
                       ["plane_moments_kernel", "plane_system_kernel"])
        plain = device_ms(lambda: nn.plane_moments_plain(params_, prep_, md), 10)
        # B2 reads a normal with each point and computes n.c once per slot
        b_ms, b_by = moments_bound(params_, prep_, icp_.knn_count, point_floats=6,
                                   slot_ops=10.0, point_ops=130.0)
        return dict(ms=ms, call_ms=call, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)

    table["B2"] = time_plane_moments(params, prep, icp)

    # B1 and B2 on the features path's own operands: sweep 2's feature
    # selection against a map of sweeps 0-1, P=10, K=32, B=4096 (B2 serves
    # 64 particles a block; 54 of them masked here)
    ficp = fcfg.icp
    fsrc, fsv, ftgt, ftv = stage1_inputs(fcfg, [f[1] for f in pframes], dev)
    check_stage1(f"features B={fsrc.shape[0]} Nt={ftgt.shape[0]} k={ficp.knn_count}",
                 fsrc, fsv, ftgt, ftv, ficp.knn_count, errs["B1"])
    fparams, fprep = main_path_moments_inputs(ficp, fsrc, fsv, ftgt, ftv, dev)
    check_moments(f"features P={ficp.particle_count} B={ficp.source_capacity} "
                  f"K={fprep.feat13.shape[1]} ({int(fsv.sum())} selected points)",
                  fparams, fprep, ficp.max_dist, errs["B2"])
    table[f"B2 (features P={ficp.particle_count})"] = time_plane_moments(fparams, fprep, ficp)
    del fsrc, fsv, ftgt, ftv, fparams, fprep
    check_preprocess(fcfg, pframes[2:4], dev, smi)

    # B4: the geode path's own operands, subt_mrs's shapes, ragged with ties
    gparams, gprep = main_path_moments_inputs(gicp, gsrc, gsv, gtgt, gtv, dev)
    check_moments(f"geode P={gicp.particle_count} B={gicp.source_capacity} "
                  f"K={gprep.feat13.shape[1]}", gparams, gprep, gicp.max_dist,
                  errs["B4"])
    ssrc, ssv, stgt, stv = stage1_inputs(scfg, gscans, dev)
    sparams, sprep = main_path_moments_inputs(scfg.icp, ssrc, ssv, stgt, stv, dev)
    check_moments(f"subt_mrs P={scfg.icp.particle_count} B={scfg.icp.source_capacity} "
                  f"K={sprep.feat13.shape[1]}", sparams, sprep, scfg.icp.max_dist,
                  errs["B4"])
    params_r, prep_r = tied_moments_inputs(gicp, 10, 300, 12, dev, seed=15)
    check_moments(f"ragged P=10 B=300 K={prep_r.feat13.shape[1]} with ties",
                  params_r, prep_r, gicp.max_dist, errs["B4"], ties=True)

    def time_point_moments(params_, prep_, icp_):
        md = icp_.max_dist
        call = cuda_time_ms(lambda: nn.point_moments(params_, prep_, md), 50)
        ms = device_ms(lambda: nn.point_moments(params_, prep_, md), 50,
                       ["point_moments_kernel", "point_system_kernel"])
        plain = device_ms(lambda: nn.point_moments_plain(params_, prep_, md), 10)
        b_ms, b_by = moments_bound(params_, prep_, icp_.knn_count, point_floats=3,
                                   slot_ops=5.0, point_ops=150.0)
        return dict(ms=ms, call_ms=call, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)

    table["B4"] = time_point_moments(gparams, gprep, gicp)
    table[f"B4 (subt_mrs P={scfg.icp.particle_count} B={scfg.icp.source_capacity})"] = \
        time_point_moments(sparams, sprep, scfg.icp)
    del ssrc, ssv, stgt, stv, sparams, sprep

    # B5: the SVGD path's own operands, ragged with ties
    vicp = vcfg.icp
    vsrc, vsv, vtgt, vtv = stage1_inputs(vcfg, [sw[0] for sw in vsweeps], dev)
    check_stage1(f"svgd B={vsrc.shape[0]} Nt={vtgt.shape[0]} k={vicp.knn_count}",
                 vsrc, vsv, vtgt, vtv, vicp.knn_count, errs["B1"])
    vparams, vprep = svgd_match_inputs(vicp, vsrc, vsv, vtgt, vtv, dev)
    check_nn_match(f"svgd P={vicp.particle_count} B={vicp.source_capacity} "
                   f"K={vprep.feat13.shape[1]}", vparams, vprep, errs["B5"])
    params_r, prep_r = tied_moments_inputs(gicp, 10, 300, 12, dev, seed=16)
    check_nn_match(f"ragged P=10 B=300 K={prep_r.feat13.shape[1]} with ties",
                   params_r, prep_r, errs["B5"], ties=True)
    call = cuda_time_ms(lambda: nn.nn_match(vparams, vprep), 50)
    ms = device_ms(lambda: nn.nn_match(vparams, vprep), 50, ["nn_match_kernel"])
    plain = device_ms(lambda: nn.nn_match_plain(vparams, vprep), 10)
    b_ms, b_by = match_bound(vparams, vprep, vicp.knn_count)
    table["B5"] = dict(ms=ms, call_ms=call, plain_ms=plain, bound_ms=b_ms, bound_by=b_by)
    del vsrc, vsv, vtgt, vtv, vparams, vprep

    # B3 at the main path's P and the geode path's, and past the size whose
    # distances stay in shared memory (P=300, 512)
    gp = gicp.particle_count
    hess, bb, r, t, prior = stein_inputs(p, dev, seed=13)
    ghess, gbb, gr, gt, gprior = stein_inputs(gp, dev, seed=14)
    check_stein(f"main P={p}", hess, bb, r, t, prior, errs["B3"])
    check_stein(f"geode P={gp}", ghess, gbb, gr, gt, gprior, errs["B3"])
    # and at the SubT-fast path's P
    sp = sfcfg.icp.particle_count
    shess, sbb, sr, st, sprior = stein_inputs(sp, dev, seed=sp)
    check_stein(f"subt-fast P={sp}", shess, sbb, sr, st, sprior, errs["B3"])
    for big in (300, 512):
        check_stein(f"large P={big}", *stein_inputs(big, dev, seed=big), errs["B3"])
    table["B3"] = time_stein(hess, bb, r, t)
    table[f"B3 (geode and features P={gp})"] = time_stein(ghess, gbb, gr, gt)
    table[f"B3 (subt-fast P={sp})"] = time_stein(shess, sbb, sr, st)
    # those bounds are far below one launch: the device time of a
    # one-element fill is the least any kernel takes here
    one = torch.zeros(1, device=dev)
    floor = device_ms(lambda: one.fill_(1.0), 200)
    print(f"launch floor: a one-element fill takes {floor:.4f} ms on the device "
          f"({cuda_time_ms(lambda: one.fill_(1.0), 200):.4f} ms per call, back "
          f"to back); B3's work bound is {table['B3']['bound_ms']:.6f} ms at "
          f"P={p} and {table[f'B3 (geode and features P={gp})']['bound_ms']:.6f} ms "
          f"at P={gp}  [{smi}]")
    for name, row in table.items():
        print(f"time {name}: kernel {row['ms']:.4f} ms on the device "
              f"({row['call_ms']:.4f} ms per wrapper call, back to back)  plain "
              f"{row['plain_ms']:.4f} ms on the device  bound {row['bound_ms']:.5f} ms "
              f"({row['bound_by']})  library_ms: none  [{smi}]")

    # ---- 4. main path
    frames = [(times[i], scans[i], [], None) for i in range(n_frames)]
    pipe, dt, launches = run_path(cfg, frames)
    ate = report_path("main path (configs/tpu_plane.yaml)", pipe, dt, launches,
                      rots, trans, smi, EARLIER_ITERS["main"])
    iters = sum(o.icp_iterations for o in pipe.outputs)
    assert launches["B2"] == iters == launches["B3"], (launches, iters)
    assert launches["B4"] == launches["B5"] == 0, launches
    print_jax_iters("main path", PLANE_JAX_ITERS, pipe)
    print(f"main path: ATE limit {PLANE_ATE_LIMIT:.4f} m (the JAX package's float32 "
          f"run: {PLANE_JAX_ATE:.4f} m)")
    assert ate < PLANE_ATE_LIMIT, (ate, PLANE_ATE_LIMIT)
    early_stop_cost(cfg, src, sv, tgt, tv, dev)
    if args.profile:
        profile_frames(cfg, frames, WARMUP, 5)
    del src, sv, tgt, tv, params, prep

    # ---- 5. GEODE-Alpha path
    gframes = [(gtimes[i], gscans[i], [gimu[i]], None) for i in range(n_frames)]
    gpipe, gdt, glaunches = run_path(gcfg, gframes)
    gate = report_path("geode path (configs/geode_alpha.yaml)", gpipe, gdt,
                       glaunches, grots, gtrans, smi, EARLIER_ITERS["geode"])
    giters = sum(o.icp_iterations for o in gpipe.outputs)
    gains = [float(o.kf_gain.abs().max()) for o in gpipe.outputs]
    print_jax_iters("geode path", GEODE_JAX_ITERS, gpipe)
    print(f"geode path: max |Kalman gain| per frame {[f'{x:.3g}' for x in gains]}; "
          f"ATE limit {GEODE_ATE_LIMIT:.4f} m (the JAX package's float32 run: "
          f"{GEODE_JAX_ATE:.4f} m)")
    assert glaunches["B4"] == giters == glaunches["B3"], (glaunches, giters)
    assert glaunches["B2"] == glaunches["B5"] == 0, glaunches
    assert all(x > 0 for x in gains[1:]), gains
    assert gate < GEODE_ATE_LIMIT, (gate, GEODE_ATE_LIMIT)
    if args.profile:
        profile_frames(gcfg, gframes, WARMUP, 5)

    # ---- 6. SVGD path
    vframes = [(vtimes[i], vsweeps[i][0], [], vsweeps[i][1]) for i in range(n_frames)]
    vpipe, vdt, vlaunches = run_path(vcfg, vframes)
    vate = report_path("svgd path (configs/generic_svgd.yaml, use_pallas=True)",
                       vpipe, vdt, vlaunches, vgt_r, vgt_t, smi, EARLIER_ITERS["svgd"],
                       SVGD_JAX_ALIGN_OK)
    viters = sum(o.icp_iterations for o in vpipe.outputs)
    steps = [f"{float(o.icp_grad_norm):.3g}" for o in vpipe.outputs[1:]]
    print(f"svgd path: last mean particle step per frame {steps}; ATE against the "
          f"mid-sweep poses, limit {SVGD_ATE_LIMIT:.4f} m (the JAX package's "
          f"float32 run: {SVGD_JAX_ATE:.4f} m)")
    assert vlaunches["B5"] == viters > 0, (vlaunches, viters)
    assert vlaunches["B2"] == vlaunches["B3"] == vlaunches["B4"] == 0, vlaunches
    assert vate < SVGD_ATE_LIMIT, (vate, SVGD_ATE_LIMIT)
    # B2 and B3 are off this path: it repeats its count and its B1 and B5's ATE
    assert [o.icp_iterations for o in vpipe.outputs] == EARLIER_ITERS["svgd"]
    assert round(vate, 4) == SVGD_ATE, vate
    if args.profile:
        profile_frames(vcfg, vframes, WARMUP, 5)

    # ---- 7. features path
    scans = (f"HDL-64 proxy sweeps of {int(np.mean([len(f[1]) for f in pframes]))} "
             f"points on average")
    fpipe, fdt, flaunches = run_path(fcfg, pframes)
    fate = report_path("features path (configs/tpu_features.yaml)", fpipe, fdt,
                       flaunches, pgt_r, pgt_t, smi, None, FEATURES_JAX_ALIGN_OK, scans)
    fiters = sum(o.icp_iterations for o in fpipe.outputs)
    fgains = [float(o.kf_gain.abs().max()) for o in fpipe.outputs]
    picks = [tuple(int(x) for x in o.feature_counts) for o in fpipe.outputs[1:]]
    print_jax_iters("features path", FEATURES_JAX_ITERS, fpipe)
    print(f"features path: (n_edge, n_planar, n_ground) per frame from frame 1 {picks}")
    print(f"features path: max |Kalman gain| per frame {[f'{x:.3g}' for x in fgains]}; "
          f"ATE against the mid-sweep poses, limit {FEATURES_ATE_LIMIT:.4f} m (the JAX "
          f"package's float32 run: {FEATURES_JAX_ATE:.4f} m)")
    assert flaunches["B2"] == fiters == flaunches["B3"], (flaunches, fiters)
    assert flaunches["B4"] == flaunches["B5"] == 0, flaunches
    assert all(x > 0 for x in fgains[1:]), fgains
    assert all(e + p > 0 for e, p, _ in picks), picks
    assert fate < FEATURES_ATE_LIMIT, (fate, FEATURES_ATE_LIMIT)
    if args.profile:
        profile_frames(fcfg, pframes, WARMUP, 5)

    # ---- 8. SubT-fast path (IMU samples fed too; the ICP estimator
    # consumes their windows unused, as the JAX package does)
    spipe, sdt, slaunches = run_path(sfcfg, pframes)
    sate = report_path("subt-fast path (configs/subt_mrs_fast.yaml)", spipe, sdt,
                       slaunches, pgt_r, pgt_t, smi, None, SUBT_FAST_JAX_ALIGN_OK, scans)
    siters = sum(o.icp_iterations for o in spipe.outputs)
    print_jax_iters("subt-fast path", SUBT_FAST_JAX_ITERS, spipe)
    print(f"subt-fast path: ATE against the mid-sweep poses, limit "
          f"{SUBT_FAST_ATE_LIMIT:.4f} m (the JAX package's float32 run: "
          f"{SUBT_FAST_JAX_ATE:.4f} m)")
    assert slaunches["B4"] == siters == slaunches["B3"], (slaunches, siters)
    assert slaunches["B2"] == slaunches["B5"] == 0, slaunches
    assert sate < SUBT_FAST_ATE_LIMIT, (sate, SUBT_FAST_ATE_LIMIT)
    if args.profile:
        profile_frames(sfcfg, pframes, WARMUP, 5)

    rows = []
    for key, (_, name, source, replaces) in KERNELS.items():
        row = table[key]
        rows.append(dict(name=name, route="cuda", source=source, replaces=replaces,
                         launches=sum(x[key] for x in (launches, glaunches, vlaunches,
                                                        flaunches, slaunches)),
                         max_abs_err=max(errs[key]), ms=row["ms"],
                         plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                         bound_by=row["bound_by"], library_ms=None))
    print(json.dumps({"kernels": rows}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
