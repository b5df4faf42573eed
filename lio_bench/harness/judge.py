"""The comparison that decides `correct`.

The judge takes what a run's timed path produced for one pass of the drive
(every frame's pose, prediction, ensemble mean and variance, iteration
count and `align_ok`, and the map at the pass's end) and works the pass
out again with the plain reference in float64, from the drive's own scans,
IMU samples and particle draws. It follows the run step by step: the
reference inserts each scan at the run's pose and feeds the run's
ensemble mean and variance to its filter, so each stage is judged from
the state the run itself was in. On the sampled frames it registers the
scan itself, from its own staging, map query and stage-1 candidates and
the same particle draws, and reads that registration twice: after the
run's own iteration count, and where the configuration's stop rule (the
statistic under `convergence_threshold`, else the cap of `iterations`)
ends it. The numbers compared:

- `guess_gap_m`: every frame's prediction (the filter's IMU propagation,
  or the constant-velocity guess) against the reference's, in metres;
- `pose_gap_m`: every frame's published position (the filter's fused pose,
  or the guess composed with the ensemble mean) against the reference's;
- `reg_t_gap_m`, `reg_r_gap_rad`: on the sampled frames, the ensemble
  mean's translation and rotation against the reference's after as many
  iterations as the run made;
- `var_gap_rel`: on those frames, the widest relative gap of the six
  ensemble variances (`var_icp`) against the same;
- `conv_t_gap_m`, `conv_r_gap_rad`: on those frames, the ensemble mean
  against the reference's where its own stop rule ends the loop, so a run
  that stops sooner than the configuration says (a higher threshold, a
  lower cap) is judged by the pose it left unconverged;
- `stop_ratio`: on those frames where the run stopped before the cap, the
  reference's stop statistic after the run's last iteration over the
  threshold: 1 or less where the reference would have stopped there too;
- `map_mismatch`: the share of the map's rows at the pass's end that the
  reference map does not hold in the same voxel, in the same order and
  within 1 mm.

Besides, where the configuration file states a size guarantee under
`guarantees` (`map`: no map row shed for capacity; `target`: every map
point within reach handed to stage 1), the run's own count is read on
every frame of the pass with the limit 0 (`COUNTS`: `map_dropped`,
`target_overflow`, the largest frame's reading). The reference runs at the
configuration's capacities, so a program that sheds rows is matched shed
for shed by `map_mismatch`; the counts catch it.

The reference is the module that the configuration file names under
`reference`: `lio_bench/reference/<name>.py` (`cell.reference_module`
loads it). It exports what `_walk` calls, with the signatures and records
of `svn_odometry`: `SUPPORTED` (the options it implements, at which values),
`Precision`, `Ops`, `stage`, `VoxelMap`, `map_insert`, `map_query`,
`register` (-> `Registration`), `filter_create`, `filter_predict`,
`filter_update`, `imu_pairs`, `constant_velocity_guess`, `compose` and
`so3_exp`. It imports nothing of the program and nothing of JAX; it may
import another reference's shared parts.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

NAMES = ("guess_gap_m", "pose_gap_m", "reg_t_gap_m", "reg_r_gap_rad",
         "var_gap_rel", "conv_t_gap_m", "conv_r_gap_rad", "stop_ratio", "map_mismatch")
# the size guarantees a configuration may state, and the count each is read from
GUARANTEED = {"map": "map_dropped", "target": "target_overflow"}
COUNTS = tuple(GUARANTEED.values())


@dataclasses.dataclass
class PassOutputs:
    """One pass of the drive as a run produced it, on the host."""

    pose_r: np.ndarray        # [n,3,3]
    pose_t: np.ndarray        # [n,3]
    guess_r: np.ndarray
    guess_t: np.ndarray
    mean: np.ndarray          # [n,6] ensemble mean [t, w] around the guess
    var: np.ndarray           # [n,6] var_icp
    iterations: np.ndarray    # [n]
    align_ok: np.ndarray      # [n] bool
    map_points: np.ndarray    # [C,3]
    map_key: np.ndarray       # [C]
    map_valid: np.ndarray     # [C] bool
    map_dropped: np.ndarray | None = None       # [n] rows shed for capacity
    target_overflow: np.ndarray | None = None   # [n] rows the target could not take

    @property
    def frames(self) -> int:
        return len(self.pose_t)


def imu_windows(drive) -> list:
    """Each frame's samples as (dt, acc, gyro), dt from the previous sample
    fed (the first ever 0), as the pipeline packs them."""
    out, last = [], None
    for samples in drive.imu:
        win = []
        for t, a, g in samples:
            win.append((0.0 if last is None else t - last, a, g))
            last = t
        out.append(win)
    return out


def sample_frames(out: PassOutputs, seed: int, count: int) -> list[int]:
    """The frames the registration is judged on: the one with the most
    iterations, and the rest drawn from the seed among frames 1..n-1."""
    n = out.frames
    if n <= 1:
        return []
    longest = 1 + int(np.argmax(out.iterations[1:]))
    rest = [k for k in range(1, n) if k != longest]
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 2])
    pick = rng.choice(len(rest), min(count - 1, len(rest)), replace=False)
    return sorted([longest] + [rest[i] for i in pick])


def check_supported(ref, cfg: dict) -> None:
    """Refuse a configuration whose options the reference `ref` does not
    implement (a missing key means its default, which is the value in
    `ref.SUPPORTED`)."""
    for group, opts in ref.SUPPORTED.items():
        for key, want in opts.items():
            got = cfg.get(group, {}).get(key, want)
            if got != want:
                raise ValueError(f"the reference implements {group}.{key} = {want!r} "
                                 f"only, the configuration sets {got!r}")
    if cfg.get("dtype", "float32") not in ("float32", "float64"):
        raise ValueError(f"unsupported dtype {cfg.get('dtype')!r}")


def guarantee_limits(guarantees: dict) -> dict:
    """The counts a configuration's stated size guarantees hold to 0."""
    return {name: 0 for key, name in GUARANTEED.items() if key in (guarantees or {})}


def map_mismatch(out: PassOutputs, vmap, tol: float = 1e-3) -> float:
    """The share of rows the two maps do not hold alike: a row matches one
    of the other map's in the same voxel at the same place in the voxel's
    insertion order, within `tol` metres."""
    ka = np.asarray(out.map_key[out.map_valid], np.int64)
    pa = np.asarray(out.map_points[out.map_valid], np.float64)
    valid = vmap.valid.cpu().numpy()
    kb = vmap.key.cpu().numpy()[valid]
    pb = vmap.points.cpu().numpy()[valid].astype(np.float64)
    ua, ia, ca = np.unique(ka, return_index=True, return_counts=True)
    ub, ib, cb = np.unique(kb, return_index=True, return_counts=True)
    _, xa, xb = np.intersect1d(ua, ub, return_indices=True)
    n = np.minimum(ca[xa], cb[xb])
    rows = max(len(ka), len(kb), 1)
    if n.sum() == 0:
        return 1.0 if len(ka) or len(kb) else 0.0
    offs = np.arange(n.sum()) - np.repeat(np.cumsum(n) - n, n)
    ra = np.repeat(ia[xa], n) + offs
    rb = np.repeat(ib[xb], n) + offs
    matched = int((np.linalg.norm(pa[ra] - pb[rb], axis=1) <= tol).sum())
    return float(1.0 - matched / rows)


def _walk(ref, cfg: dict, drive, ops, n: int, run: PassOutputs | None = None,
          sample=frozenset()):
    """The reference `ref`'s pipeline over the drive's first n frames. Without
    `run` it is the program's stand-in: it registers every frame with its
    own stop rule and carries its own state, and returns its outputs
    (PassOutputs). With `run` it follows the run: the constant-velocity
    guess from the run's poses, the filter fed the run's ensemble mean and
    variance, each scan inserted at the run's pose, a registration only on
    the `sample` frames; it returns the gaps (see the module docstring)."""
    icp, pp, mcfg = cfg["icp"], cfg["preprocess"], cfg["map"]
    kf = cfg["lio"].get("estimator", "kf") == "kf"
    scales = np.asarray(cfg["lio"].get("icp_cov_scales", [1.0] * 6), float)
    windows = imu_windows(drive)
    vmap = ref.VoxelMap.empty(int(mcfg["capacity"]), ops)
    filt = ref.filter_create(ops, cfg) if kf else None
    thr, cap = float(icp["convergence_threshold"]), int(icp["iterations"])
    early = bool(icp.get("early_stop", True))
    eye = torch.eye(3, dtype=ops.dtype, device=ops.device)
    zero = torch.zeros(3, dtype=ops.dtype, device=ops.device)
    g = dict.fromkeys(NAMES, 0.0)
    g["_ref_failed"] = 0
    rows = {k: [] for k in ("pose_r", "pose_t", "guess_r", "guess_t", "mean", "var",
                            "iterations", "align_ok")}
    poses = []          # the poses the next guess is made from: the run's, else its own

    def gap(name, value):
        g[name] = max(g[name], float(value))

    for k in range(n):
        cropped, to_map, source = ref.stage(ops, drive.scans[k], cfg)
        if k == 0:
            guess_r, guess_t = eye, zero
        elif kf:
            for prev, cur in ref.imu_pairs(windows[k]):
                filt = ref.filter_predict(ops, filt, prev, cur, cfg["imu"])
            guess_r, guess_t = filt.r, filt.t
        else:
            pr, pt = poses[k - 2] if k >= 2 else (eye, zero)
            guess_r, guess_t = ref.constant_velocity_guess(
                *poses[k - 1], pr, pt, float(drive.times[k]), float(drive.times[k - 1]),
                float(drive.times[k - 2]) if k >= 2 else 0.0, k)
        mean, var, its, ok = np.zeros(6), np.zeros(6), 0, True
        if k == 0:
            vmap = ref.map_insert(ops, vmap, *cropped, guess_r, guess_t, mcfg)
            pose_r, pose_t = guess_r, guess_t
        else:
            reg = None
            if run is None or k in sample:
                target = ref.map_query(vmap, guess_t, float(pp["max_range"]) + 10.0,
                                       int(icp["target_capacity"]))
                reg = ref.register(ops, icp, source, target, guess_r, guess_t,
                                   drive.particles[k],
                                   follow=None if run is None else int(run.iterations[k]))
                reg_ok = bool(np.isfinite(reg.mean).all() and np.isfinite(reg.var).all()
                              and reg.grad_norm < 0.999 * float(icp["max_dist"]))
            if run is None:
                mean, var, its, ok = reg.mean, reg.var, reg.iterations, reg_ok
            else:
                mean, var, ok = run.mean[k], run.var[k], bool(run.align_ok[k])
                if reg is not None:
                    n_it, fol = int(run.iterations[k]), reg.followed
                    g["_ref_failed"] += not reg_ok
                    gap("reg_t_gap_m", np.linalg.norm(fol.mean[:3] - mean[:3]))
                    gap("reg_r_gap_rad", np.linalg.norm(fol.mean[3:] - mean[3:]))
                    gap("var_gap_rel", np.max(np.abs(var - fol.var)
                                              / np.maximum(fol.var, 1e-30)))
                    gap("conv_t_gap_m", np.linalg.norm(reg.mean[:3] - mean[:3]))
                    gap("conv_r_gap_rad", np.linalg.norm(reg.mean[3:] - mean[3:]))
                    if n_it == 0:
                        g["stop_ratio"] = math.inf
                    elif early and n_it < cap:
                        gap("stop_ratio", reg.stats[n_it - 1] / thr
                            if n_it <= len(reg.stats) else math.inf)
            if not ok:
                pose_r, pose_t = guess_r, guess_t
            elif kf:
                filt = ref.filter_update(ops, filt, mean, var * scales)
                pose_r, pose_t = filt.r, filt.t
            else:
                m = ops.t(mean)
                pose_r, pose_t = ref.compose(guess_r, guess_t, ref.so3_exp(m[3:]), m[:3])
        if run is not None:
            gap("guess_gap_m", np.linalg.norm(guess_t.cpu().numpy() - run.guess_t[k]))
            gap("pose_gap_m", np.linalg.norm(pose_t.cpu().numpy() - run.pose_t[k]))
            pose_r, pose_t = ops.t(run.pose_r[k]), ops.t(run.pose_t[k])
        if k > 0 and ok and k % int(mcfg.get("insert_every", 1)) == 0:
            vmap = ref.map_insert(ops, vmap, *to_map, pose_r, pose_t, mcfg)
        poses.append((pose_r, pose_t))
        if run is None:
            for name, v in (("pose_r", pose_r), ("pose_t", pose_t), ("guess_r", guess_r),
                            ("guess_t", guess_t)):
                rows[name].append(v.cpu().numpy().astype(np.float64))
            rows["mean"].append(mean)
            rows["var"].append(var)
            rows["iterations"].append(its)
            rows["align_ok"].append(ok)
    if run is not None:
        g["map_mismatch"] = map_mismatch(run, vmap)
        for name in COUNTS:
            got = getattr(run, name)
            g[name] = int(np.max(got)) if got is not None and len(got) else 0
        g["_sampled"] = len(sample)
        return g
    return PassOutputs(**{k: np.asarray(v) for k, v in rows.items()},
                       map_points=vmap.points.cpu().numpy(),
                       map_key=vmap.key.cpu().numpy(),
                       map_valid=vmap.valid.cpu().numpy())


def judge(ref, cfg: dict, drive, out: PassOutputs, seed: int, check_frames: int,
          device, prec=None) -> dict:
    """The numbers compared, for one pass, by the reference `ref` in `prec`
    (float64 when not given; see the module docstring)."""
    sample = frozenset(sample_frames(out, seed, check_frames))
    ops = ref.Ops(prec or ref.Precision(), device)
    return _walk(ref, cfg, drive, ops, out.frames, run=out, sample=sample)


def ate(out: PassOutputs, gt_t: np.ndarray) -> float:
    """RMSE of the positions after the best rigid alignment (Umeyama,
    no scale) onto the ground truth."""
    a, b = out.pose_t.astype(np.float64), gt_t[:len(out.pose_t)].astype(np.float64)
    ma, mb = a.mean(0), b.mean(0)
    u, _, vt = np.linalg.svd((b - mb).T @ (a - ma))
    d = np.sign(np.linalg.det(u @ vt))
    r = u @ np.diag([1.0, 1.0, d]) @ vt
    return float(np.sqrt((((a - ma) @ r.T + mb - b) ** 2).sum(1).mean()))


def control_outputs(ref, cfg: dict, drive, n: int, device, prec=None) -> PassOutputs:
    """The reference `ref` put in the program's place: the first n frames of
    the drive run through the reference's own pipeline (its registration
    and stop rule every frame) in `prec` (float32 with TF32 products when
    not given), as a run's outputs; it counts no shed rows."""
    ops = ref.Ops(prec or ref.Precision(torch.float32, tf32=True), device)
    return _walk(ref, cfg, drive, ops, n)


def verdict(numbers: dict, limits: dict) -> tuple[bool, list[str]]:
    """(every compared number within its limit, one `name number <= limit`
    line per number). A cell compares the numbers its limits file names."""
    ok, lines = True, []
    for name in NAMES + COUNTS:
        if name not in limits:
            continue
        v, lim = numbers[name], float(limits[name])
        good = v <= lim
        ok &= good
        lines.append(f"{name} {v:.6g} {'<=' if good else '>'} {lim:.6g}")
    return bool(ok), lines
