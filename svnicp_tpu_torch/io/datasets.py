"""Synthetic ground-truthed LiDAR sequences and the KITTI readers (port of
`svnicp_tpu/io/datasets.py`: `SyntheticWorld.scan_at` and `scan_sweep`,
`raycast_scan`, `raycast_sweep`, `DegenerateWorld`, `synthetic_trajectory`,
`circular_trajectory`, `synthetic_imu`, and the KITTI odometry format). The
same numpy draws in the same order, so a scan made here from a seed is
byte-equal to the JAX package's (a sweep equal to float32 rounding)."""

from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class SyntheticWorld:
    """A random structured environment: ground plane + walls + boxes."""

    extent: float = 60.0
    n_walls: int = 14
    n_boxes: int = 10
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._surfaces = []  # (origin[3], u[3], v[3], u_len, v_len)
        e = self.extent
        self._surfaces.append((np.array([-e, -e, 0.0]), np.array([1.0, 0, 0]),
                               np.array([0, 1.0, 0]), 2 * e, 2 * e))
        for _ in range(self.n_walls):
            x, y = rng.uniform(-e, e, 2)
            ang = rng.uniform(0, np.pi)
            length = rng.uniform(8, 30)
            height = rng.uniform(2, 6)
            u = np.array([np.cos(ang), np.sin(ang), 0.0])
            self._surfaces.append((np.array([x, y, 0.0]), u,
                                   np.array([0, 0, 1.0]), length, height))
        for _ in range(self.n_boxes):
            x, y = rng.uniform(-e, e, 2)
            s = rng.uniform(1, 4)
            for du, dv, o in [((1, 0, 0), (0, 0, 1), (0, -s / 2, 0)),
                              ((0, 1, 0), (0, 0, 1), (-s / 2, 0, 0))]:
                self._surfaces.append((np.array([x, y, 0.0]) + np.asarray(o),
                                       np.asarray(du, float),
                                       np.asarray(dv, float), s, s))

    def sample_surface_points(self, rng, n: int) -> np.ndarray:
        areas = np.array([ul * vl for (_, _, _, ul, vl) in self._surfaces])
        areas[0] *= 0.15   # down-weight the ground plane
        counts = rng.multinomial(n, areas / areas.sum())
        pts = []
        for (o, u, v, ul, vl), c in zip(self._surfaces, counts):
            a = rng.uniform(0, ul, c)[:, None]
            b = rng.uniform(0, vl, c)[:, None]
            pts.append(o[None] + a * u[None] + b * v[None])
        return np.concatenate(pts, axis=0)

    def scan_at(self, rng, pose_r: np.ndarray, pose_t: np.ndarray,
                n_points: int = 8000, max_range: float = 45.0,
                noise: float = 0.02) -> np.ndarray:
        """Sample a scan in the sensor frame from pose (R, t)."""
        world_pts = self.sample_surface_points(rng, n_points * 3)
        d = np.linalg.norm(world_pts - pose_t[None], axis=1)
        world_pts = world_pts[(d < max_range) & (d > 1.0)]
        if len(world_pts) > n_points:
            world_pts = world_pts[rng.choice(len(world_pts), n_points,
                                             replace=False)]
        local = (world_pts - pose_t[None]) @ pose_r  # R^T (p - t)
        return (local + rng.normal(scale=noise, size=local.shape)).astype(np.float32)

    def scan_sweep(self, rng, pose0_r, pose0_t, pose1_r, pose1_t,
                   n_points: int = 8000, max_range: float = 45.0,
                   noise: float = 0.02):
        """Motion-distorted scan: each point is observed from the pose
        screw-interpolated between pose0 (sweep start, tau=0) and pose1
        (sweep end, tau=1) and expressed in its own observation frame, the
        distortion deskew inverts -> (points [N,3] f32, tau [N] f32,
        (mid_r, mid_t)), mid being the tau=0.5 pose the deskewed cloud lives
        in. The interpolation runs in float32 as the JAX package's does, so
        the two agree to rounding, not to the byte."""
        import torch

        from svnicp_tpu_torch.core import geometry as geo

        world_pts = self.sample_surface_points(rng, n_points * 3)
        mid_t_rough = 0.5 * (pose0_t + pose1_t)
        d = np.linalg.norm(world_pts - mid_t_rough[None], axis=1)
        world_pts = world_pts[(d < max_range) & (d > 1.0)]
        if len(world_pts) > n_points:
            world_pts = world_pts[rng.choice(len(world_pts), n_points,
                                             replace=False)]
        tau = rng.uniform(0.0, 1.0, len(world_pts)).astype(np.float32)

        def f32(a):
            return torch.as_tensor(np.asarray(a), dtype=torch.float32)

        rd, td = geo.transform_compose(
            *geo.transform_inverse(f32(pose0_r), f32(pose0_t)),
            f32(pose1_r), f32(pose1_t))
        xi = geo.se3_log(rd, td)
        rs, ts = geo.se3_exp(torch.from_numpy(tau)[:, None] * xi[None])
        r_obs = (f32(pose0_r) @ rs).numpy()
        t_obs = ts.numpy() @ np.asarray(pose0_r).T + pose0_t[None]
        local = np.einsum("nji,nj->ni", r_obs, world_pts - t_obs)  # R^T (p - t)
        rm, tm = geo.se3_exp(0.5 * xi)
        mid_r = pose0_r @ rm.numpy()
        mid_t = pose0_r @ tm.numpy() + pose0_t
        local += rng.normal(scale=noise, size=local.shape)
        return local.astype(np.float32), tau, (mid_r, mid_t)


def raycast_scan(surfaces, pose_r: np.ndarray, pose_t: np.ndarray,
                 n_scan: int = 64, horizon: int = 2250,
                 ang_res_y: float = 26.8 / 63.0, ang_bottom: float = 24.8,
                 max_range: float = 80.0, noise: float = 0.02,
                 col_step: int = 1, rng=None) -> np.ndarray:
    """A rotating-LiDAR scan raycast with the full HDL-64 ray pattern (64
    rings x 2250 azimuth steps by default, the geometry the reference's
    segmentation hard-codes, ref: ImageProjection.h:63-68), so the range-
    image pipeline runs at its true shape. `surfaces` is a list of finite
    rectangles (origin, u, v, u_len, v_len), as SyntheticWorld holds them;
    a ray that hits nothing within `max_range` gives no return.
    `col_step` decimates azimuth columns. Returns sensor-frame points
    [N,3] f32, with Gaussian noise of `noise` m per coordinate."""
    rows = np.arange(n_scan)
    cols = np.arange(0, horizon, col_step)
    vert = np.radians(-ang_bottom + rows * ang_res_y)            # [R]
    horiz = np.radians(90.0 - cols * (360.0 / horizon))          # [C]
    cv, sv = np.cos(vert)[:, None], np.sin(vert)[:, None]
    ch, sh = np.cos(horiz)[None, :], np.sin(horiz)[None, :]
    # the projection's convention: vert = atan2(z, hypot(x, y)), horiz = atan2(x, y)
    dirs = np.stack([cv * sh, cv * ch, np.broadcast_to(sv, (n_scan, len(cols)))],
                    axis=-1).reshape(-1, 3)                      # [R*C,3]
    dirs_w = dirs @ pose_r.T
    best_t = np.full(len(dirs), np.inf)
    for (o, u, v, ul, vl) in surfaces:
        n = np.cross(u, v)
        denom = dirs_w @ n
        with np.errstate(divide="ignore", invalid="ignore"):
            t = ((o - pose_t) @ n) / denom
            p = pose_t[None] + t[:, None] * dirs_w
            a = (p - o[None]) @ u
            b = (p - o[None]) @ v
            hit = (np.abs(denom) > 1e-9) & (t > 0.3) & (t < max_range) \
                & (a >= 0) & (a <= ul) & (b >= 0) & (b <= vl)
        best_t = np.where(hit & (t < best_t), t, best_t)
    ok = np.isfinite(best_t)
    pts = best_t[ok, None] * dirs[ok]
    if noise > 0:
        rng = rng or np.random.default_rng(0)
        pts = pts + rng.normal(scale=noise, size=pts.shape)
    return pts.astype(np.float32)


def raycast_sweep(surfaces, pose0_r, pose0_t, pose1_r, pose1_t,
                  n_scan: int = 64, horizon: int = 2250,
                  ang_res_y: float = 26.8 / 63.0, ang_bottom: float = 24.8,
                  max_range: float = 80.0, noise: float = 0.02,
                  col_step: int = 1, n_groups: int = 25,
                  dropout: float = 0.0, rng=None):
    """Motion-distorted HDL-64 raycast sweep (the JAX package's offline proxy
    of a rotating-LiDAR log). Azimuth column c is observed at sweep fraction
    tau = c / horizon from the pose screw-interpolated between pose0 (sweep
    start) and pose1 (sweep end), one pose per each of `n_groups` column
    groups; each ray's first hit on `surfaces` within (0.3, max_range) is
    returned in that pose's sensor frame, after per-ray `dropout` and range
    `noise` along the ray. The poses are interpolated in float32, as the JAX
    package does, so the two agree to rounding, not to the byte.

    Returns (points [N,3] f32 in the mixed sensor frames, tau [N] f32,
    (mid_r, mid_t), the tau=0.5 pose the deskewed cloud lives in)."""
    import torch

    from svnicp_tpu_torch.core import geometry as geo

    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32)

    rng = rng or np.random.default_rng(0)
    rows = np.arange(n_scan)
    cols = np.arange(0, horizon, col_step)
    vert = np.radians(-ang_bottom + rows * ang_res_y)            # [R]
    horiz = np.radians(90.0 - cols * (360.0 / horizon))          # [C]
    cv, sv = np.cos(vert)[:, None], np.sin(vert)[:, None]
    ch, sh = np.cos(horiz)[None, :], np.sin(horiz)[None, :]
    dirs = np.stack([cv * sh, cv * ch, np.broadcast_to(sv, (n_scan, len(cols)))],
                    axis=-1)                                     # [R,C,3]
    col_tau = (cols.astype(np.float64) / horizon).astype(np.float32)

    rdelta, tdelta = geo.transform_compose(
        *geo.transform_inverse(f32(pose0_r), f32(pose0_t)), f32(pose1_r),
        f32(pose1_t))
    xi = geo.se3_log(rdelta, tdelta).numpy()

    def pose_at(tau):
        rloc, tloc = geo.se3_exp(torch.from_numpy(tau * xi))
        return pose0_r @ rloc.numpy(), pose0_r @ tloc.numpy() + pose0_t

    bounds = np.linspace(0, len(cols), n_groups + 1).astype(int)
    out_pts, out_tau = [], []
    for g in range(n_groups):
        c0, c1 = bounds[g], bounds[g + 1]
        if c0 == c1:
            continue
        rg, tg = pose_at(float(col_tau[(c0 + c1) // 2]))
        d = dirs[:, c0:c1].reshape(-1, 3)
        dirs_w = d @ rg.T
        best_t = np.full(len(d), np.inf)
        for (o, u, v, ul, vl) in surfaces:
            n = np.cross(u, v)
            denom = dirs_w @ n
            with np.errstate(divide="ignore", invalid="ignore"):
                t = ((o - tg) @ n) / denom
                p = tg[None] + t[:, None] * dirs_w
                a = (p - o[None]) @ u
                b = (p - o[None]) @ v
                hit = (np.abs(denom) > 1e-9) & (t > 0.3) & (t < max_range) \
                    & (a >= 0) & (a <= ul) & (b >= 0) & (b <= vl)
            best_t = np.where(hit & (t < best_t), t, best_t)
        ok = np.isfinite(best_t)
        if dropout > 0:
            ok &= rng.uniform(size=len(d)) >= dropout
        rngs = best_t[ok]
        if noise > 0:
            rngs = rngs + rng.normal(scale=noise, size=rngs.shape)
        out_pts.append(rngs[:, None] * d[ok])
        out_tau.append(np.broadcast_to(
            col_tau[None, c0:c1], (n_scan, c1 - c0)).reshape(-1)[ok])
    pts = np.concatenate(out_pts).astype(np.float32)
    tau = np.concatenate(out_tau).astype(np.float32)
    return pts, tau, pose_at(0.5)


@dataclasses.dataclass
class DegenerateWorld:
    """Geometrically under-constrained scenes: 'corridor' (two walls and a
    floor along x: x-translation unobservable), 'tunnel' (an octagonal
    prism along x), 'plane' (bare ground: x, y and yaw unobservable)."""

    kind: str = "corridor"
    length: float = 120.0
    half_width: float = 3.0
    height: float = 4.0

    def __post_init__(self):
        L, w, h = self.length, self.half_width, self.height
        o = -L / 2
        ex = np.array([1.0, 0, 0])
        ez = np.array([0, 0, 1.0])
        self.surfaces = []
        if self.kind in ("corridor", "plane"):
            self.surfaces.append((np.array([o, -4 * w, 0.0]), ex,
                                  np.array([0, 1.0, 0]), L, 8 * w))  # floor
        if self.kind == "corridor":
            self.surfaces.append((np.array([o, -w, 0.0]), ex, ez, L, h))
            self.surfaces.append((np.array([o, w, 0.0]), ex, ez, L, h))
        elif self.kind == "tunnel":
            r = self.half_width
            ang = np.linspace(0, 2 * np.pi, 8, endpoint=False)
            for a0, a1 in zip(ang, np.roll(ang, -1)):
                p0 = np.array([o, r * np.cos(a0), r * np.sin(a0) + r])
                p1 = np.array([o, r * np.cos(a1), r * np.sin(a1) + r])
                v = p1 - p0
                self.surfaces.append((p0, ex, v / np.linalg.norm(v), L,
                                      np.linalg.norm(v)))
        elif self.kind != "plane":
            raise ValueError(f"unknown kind {self.kind!r}")

    def scan_at(self, rng, pose_r, pose_t, n_points: int = 4000,
                max_range: float = 45.0, noise: float = 0.01) -> np.ndarray:
        areas = np.array([ul * vl for (_, _, _, ul, vl) in self.surfaces])
        counts = rng.multinomial(n_points * 3, areas / areas.sum())
        pts = []
        for (o, u, v, ul, vl), c in zip(self.surfaces, counts):
            a = rng.uniform(0, ul, c)[:, None]
            b = rng.uniform(0, vl, c)[:, None]
            pts.append(o[None] + a * u[None] + b * v[None])
        world_pts = np.concatenate(pts, axis=0)
        d = np.linalg.norm(world_pts - pose_t[None], axis=1)
        world_pts = world_pts[(d < max_range) & (d > 1.0)]
        if len(world_pts) > n_points:
            world_pts = world_pts[rng.choice(len(world_pts), n_points,
                                             replace=False)]
        local = (world_pts - pose_t[None]) @ pose_r
        return (local + rng.normal(scale=noise, size=local.shape)).astype(np.float32)


def synthetic_trajectory(n_frames: int, dt: float = 0.1, speed: float = 1.5,
                         turn_rate: float = 0.08, seed: int = 0,
                         ramp_seconds: float = 0.0):
    """Smooth planar trajectory with yaw following heading; `ramp_seconds` > 0
    accelerates from rest (a filter's cold start at v=0 then sees no
    synthetic transient) -> (times [N], rotations [N,3,3], translations [N,3])."""
    rng = np.random.default_rng(seed)
    times = np.arange(n_frames) * dt
    yaw = np.cumsum(rng.normal(loc=turn_rate, scale=0.02, size=n_frames) * dt)
    heading = np.stack([np.cos(yaw), np.sin(yaw), np.zeros(n_frames)], axis=1)
    if ramp_seconds > 0:
        v = speed * np.clip(times / ramp_seconds, 0.0, 1.0)
    else:
        v = np.full(n_frames, speed)
    pos = np.cumsum(heading * v[:, None] * dt, axis=0)
    pos[:, 2] = 0.8 + 0.05 * np.sin(times)
    rots = np.zeros((n_frames, 3, 3))
    for i in range(n_frames):
        c, s = np.cos(yaw[i]), np.sin(yaw[i])
        rots[i] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    return times, rots, pos


def circular_trajectory(n_samples: int, dt: float, radius: float,
                        angular_rate: float, z: float = 0.8):
    """Constant-rate circle (the loop-closure scenario: with the scan range
    capped below the diameter, heading error compounds into drift until
    the start region comes back into view), from the origin heading +x,
    counter-clockwise about (0, radius) -> (times [N], rotations [N,3,3],
    translations [N,3])."""
    times = np.arange(n_samples) * dt
    theta = angular_rate * times
    center = np.array([0.0, radius, z])
    trans = center[None] + radius * np.stack(
        [np.sin(theta), -np.cos(theta), np.zeros(n_samples)], 1)
    rots = np.zeros((n_samples, 3, 3))
    c, s = np.cos(theta), np.sin(theta)
    for i in range(n_samples):
        rots[i] = [[c[i], -s[i], 0], [s[i], c[i], 0], [0, 0, 1]]
    return times, rots, trans


def synthetic_imu(times, rots, trans, gravity: float):
    """IMU samples consistent with a discrete trajectory (midpoint rates)
    -> list of (t, acc [3], gyro [3]) at the trajectory stamps; acc is the
    specific force in the body frame, R^T (a_nav + g_up)."""
    from scipy.spatial.transform import Rotation

    n = len(times)
    vel = np.gradient(trans, times, axis=0)
    acc_nav = np.gradient(vel, times, axis=0)
    g_up = np.array([0.0, 0.0, gravity])
    imu = []
    for i in range(n):
        r = rots[i]
        if i + 1 < n:
            w = (Rotation.from_matrix(r.T @ rots[i + 1]).as_rotvec()
                 / (times[i + 1] - times[i]))
        else:
            w = np.zeros(3)
        imu.append((float(times[i]), r.T @ (acc_nav[i] + g_up), w))
    return imu


# ------------------------------------------------------------ KITTI odometry


def read_kitti_bin(path: str) -> np.ndarray:
    """One KITTI velodyne .bin scan -> [N,3] float32 (intensity dropped)."""
    from svnicp_tpu_torch.io import native

    return native.read_kitti_bin(path)


def read_kitti_poses(path: str) -> np.ndarray:
    """KITTI poses.txt -> [N,4,4] homogeneous cam0 poses."""
    rows = np.loadtxt(path).reshape(-1, 3, 4)
    out = np.tile(np.eye(4), (rows.shape[0], 1, 1))
    out[:, :3, :] = rows
    return out


def kitti_sequence(velodyne_dir: str, times_path: str | None = None):
    """Iterate (t, points) over a KITTI sequence directory (10 Hz stamps
    when no times file is given)."""
    files = sorted(f for f in os.listdir(velodyne_dir) if f.endswith(".bin"))
    if times_path and os.path.exists(times_path):
        times = np.loadtxt(times_path)
    else:
        times = np.arange(len(files)) * 0.1
    for t, f in zip(times, files):
        yield float(t), read_kitti_bin(os.path.join(velodyne_dir, f))
