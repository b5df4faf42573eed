"""The drive a cell replays: scans, ground truth, IMU samples and particle
draws, made from a traffic file's parameters and the run's seed.

The world, trajectory and IMU generators are copies of the port's
`svnicp_tpu_torch/io/datasets.py` (`SyntheticWorld.__post_init__`,
`sample_surface_points`, `scan_at`, `scan_sweep`; `synthetic_trajectory`;
`synthetic_imu`), which are themselves copies of the JAX package's
`svnicp_tpu/io/datasets.py`, with the same numpy draws in the same order
(`scan_sweep` apart: see its docstring).
`synthetic_imu` is vectorised here (one `Rotation.from_matrix` call for
all samples); its values equal the loop's to rounding. The copies live
with the benchmark so that a change to the program cannot move the
yardstick.

The traffic file fixes the world and the trajectory (their own seeds): a
recorded route replayed. The run's seed draws everything a sensor and the
filter's particle prior add to it: which surface points each scan samples,
their noise, and the per-frame particle draws. So every seed gives the
same route, the same number of frames and scans of the same size, in
another realisation.

A scan is a snapshot from one pose, or with the traffic's `scan.sweep`
true, a spinning LiDAR's sweep over the scan period that ends at its
stamp, each point seen from the pose of its own firing time
(`SyntheticWorld.scan_sweep`), with that time as a 4th column.
"""

from __future__ import annotations

import dataclasses

import numpy as np

GRAVITY = 9.782940329221166   # the upstream IMU.h:24 value the port uses
# the particle prior box of the upstream node (OdometryPipeline.cpp:662-665),
# [t, w]; a configuration's icp.init_lb / init_ub replace it
PRIOR_LB = (-0.3, -0.2, -0.1, -0.004, -0.004, -0.012)
PRIOR_UB = (0.3, 0.2, 0.1, 0.004, 0.004, 0.012)


def prior_box(icp: dict) -> tuple:
    return tuple(icp.get("init_lb", PRIOR_LB)), tuple(icp.get("init_ub", PRIOR_UB))


def _skew(w):
    z = np.zeros_like(w[..., 0])
    return np.stack([np.stack([z, -w[..., 2], w[..., 1]], -1),
                     np.stack([w[..., 2], z, -w[..., 0]], -1),
                     np.stack([-w[..., 1], w[..., 0], z], -1)], -2)


def _so3(w):
    """[..., 3] rotation vectors -> (exp(w), its left Jacobian), float64."""
    a2 = (w * w).sum(-1)[..., None, None]
    small = a2 < 1e-12
    a = np.sqrt(np.where(small, 1.0, a2))
    s = np.where(small, 1.0 - a2 / 6.0, np.sin(a) / a)
    c = np.where(small, 0.5 - a2 / 24.0, (1.0 - np.cos(a)) / (a * a))
    s3 = np.where(small, 1.0 / 6.0 - a2 / 120.0, (a - np.sin(a)) / (a * a * a))
    wx = _skew(w)
    wx2 = wx @ wx
    return np.eye(3) + s * wx + c * wx2, np.eye(3) + c * wx + s3 * wx2


def se3_exp(xi):
    """[..., 6] twists [rho, w] -> (R [...,3,3], t [...,3])."""
    r, jl = _so3(xi[..., 3:])
    return r, (jl @ xi[..., :3, None])[..., 0]


def se3_log(r, t):
    """(R [3,3], t [3]) -> the twist [rho, w] with se3_exp = (R, t)."""
    from scipy.spatial.transform import Rotation

    w = Rotation.from_matrix(r).as_rotvec()
    return np.concatenate([np.linalg.solve(_so3(w)[1], t), w])


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
        distortion deskew inverts -> (points [N,3] float64, tau [N],
        (mid_r, mid_t)), mid being the tau=0.5 pose the deskewed cloud lives
        in. The port's recipe in float64, with two changes: a point's tau is
        its azimuth in the mid-sweep sensor frame, (atan2(y, x) + pi) / 2 pi,
        a spinning LiDAR's firing order, where the port draws tau uniformly
        (so the rng makes no draw for it); and the range gate is taken from
        the mid pose, where the port takes the mean of the two positions."""
        xi = se3_log(pose0_r.T @ pose1_r, pose0_r.T @ (pose1_t - pose0_t))
        rm, tm = se3_exp(0.5 * xi)
        mid_r, mid_t = pose0_r @ rm, pose0_r @ tm + pose0_t
        world_pts = self.sample_surface_points(rng, n_points * 3)
        d = np.linalg.norm(world_pts - mid_t[None], axis=1)
        world_pts = world_pts[(d < max_range) & (d > 1.0)]
        if len(world_pts) > n_points:
            world_pts = world_pts[rng.choice(len(world_pts), n_points,
                                             replace=False)]
        in_mid = (world_pts - mid_t[None]) @ mid_r
        tau = (np.arctan2(in_mid[:, 1], in_mid[:, 0]) + np.pi) / (2 * np.pi)
        rs, ts = se3_exp(tau[:, None] * xi[None])
        r_obs = pose0_r[None] @ rs
        t_obs = ts @ pose0_r.T + pose0_t[None]
        local = np.einsum("nji,nj->ni", r_obs, world_pts - t_obs)  # R^T (p - t)
        local += rng.normal(scale=noise, size=local.shape)
        return local, tau, (mid_r, mid_t)


def synthetic_trajectory(n_frames: int, dt: float = 0.1, speed: float = 1.5,
                         turn_rate: float = 0.08, seed: int = 0,
                         ramp_seconds: float = 0.0):
    """Smooth planar trajectory with yaw following heading; `ramp_seconds` > 0
    accelerates from rest -> (times [N], rotations [N,3,3], translations [N,3])."""
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
    c, s = np.cos(yaw), np.sin(yaw)
    rots[:, 0, 0], rots[:, 0, 1] = c, -s
    rots[:, 1, 0], rots[:, 1, 1] = s, c
    rots[:, 2, 2] = 1.0
    return times, rots, pos


def synthetic_imu(times, rots, trans, gravity: float = GRAVITY):
    """IMU samples consistent with a discrete trajectory (midpoint rates)
    -> (times [N], acc [N,3], gyro [N,3]); acc is the specific force in the
    body frame, R^T (a_nav + g_up), gyro the rotation to the next stamp
    over its interval (zero at the last)."""
    from scipy.spatial.transform import Rotation

    vel = np.gradient(trans, times, axis=0)
    acc_nav = np.gradient(vel, times, axis=0)
    g_up = np.array([0.0, 0.0, gravity])
    acc = np.einsum("nji,nj->ni", rots, acc_nav + g_up)
    gyro = np.zeros_like(acc)
    rel = np.einsum("nji,njk->nik", rots[:-1], rots[1:])      # R_i^T R_{i+1}
    gyro[:-1] = (Rotation.from_matrix(rel).as_rotvec()
                 / np.diff(times)[:, None])
    return np.asarray(times, float), acc, gyro


@dataclasses.dataclass
class Drive:
    """One cell's inputs, on the host (the harness uploads the particle
    draws itself)."""

    times: np.ndarray            # [F] scan stamps (a sweep's end)
    # [F,3,3], [F,3] ground-truth sensor pose: at the stamp for a snapshot,
    # for a sweep at its middle (tau 0.5), the frame its deskewed cloud lives in
    rots: np.ndarray
    trans: np.ndarray
    # F float32 scans in the sensor frame: [N,3] snapshots, or [N,4] sweeps,
    # each point in the frame of its own time, the 4th column (seconds from
    # the sweep's start, in [0, period])
    scans: list
    imu: list                    # F lists of (t, acc [3], gyro [3]) fed before scan k
    particles: np.ndarray        # [F,P,6] float32 prior draws, frame k's at k


def frame_count(traffic: dict, seconds: int) -> int:
    """Frames in the drive: the replay's fixed length, or for a live drive
    the warm-up, the window at the sensor's rate and a margin."""
    if traffic["kind"] == "replay":
        return int(traffic["frames"])
    rate = float(traffic["rate_hz"])
    return int(traffic["warmup_frames"]) + int(np.ceil(seconds * rate)) + 10


def make_drive(traffic: dict, seed: int, n_frames: int, particle_count: int,
               init_lb, init_ub) -> Drive:
    """The cell's drive from its traffic parameters and the run's seed."""
    w = traffic["world"]
    world = SyntheticWorld(extent=float(w["extent"]), n_walls=int(w["n_walls"]),
                           n_boxes=int(w["n_boxes"]), seed=int(w["seed"]))
    tr = traffic["trajectory"]
    period = 1.0 / float(traffic["scan_rate_hz"])
    imu_cfg = traffic.get("imu")
    # the trajectory runs at the IMU's rate when there is one; scans take
    # every `sub`-th stamp
    sub = 1 if not imu_cfg else int(round(float(imu_cfg["rate_hz"]) * period))
    times, rots, trans = synthetic_trajectory(
        (n_frames - 1) * sub + 1, dt=period / sub, speed=float(tr["speed"]),
        turn_rate=float(tr["turn_rate"]), seed=int(tr["seed"]),
        ramp_seconds=float(tr["ramp_seconds"]))
    seq = np.random.SeedSequence(int(seed))
    scan_rng, draw_rng = (np.random.default_rng(s) for s in seq.spawn(2))
    sc = traffic["scan"]
    idx = np.arange(n_frames) * sub
    size = dict(n_points=int(sc["points"]), max_range=float(sc["max_range"]),
                noise=float(sc["noise"]))
    gt_r, gt_t = rots[idx], trans[idx]
    if sc.get("sweep"):
        # scan k sweeps from scan k-1's stamp to its own; frame 0 is static
        scans = []
        for k, i in enumerate(idx):
            j = idx[max(k - 1, 0)]
            pts, tau, (gt_r[k], gt_t[k]) = world.scan_sweep(
                scan_rng, rots[j], trans[j], rots[i], trans[i], **size)
            scans.append(np.concatenate([pts, period * tau[:, None]], 1
                                        ).astype(np.float32))
    else:
        scans = [world.scan_at(scan_rng, rots[i], trans[i], **size) for i in idx]
    imu = [[] for _ in range(n_frames)]
    if imu_cfg:
        t_imu, acc, gyro = synthetic_imu(times, rots, trans)
        for j in range(len(t_imu)):
            # the samples after scan k-1's stamp, up to scan k's, go before scan k
            k = -(-j // sub)
            imu[k].append((float(t_imu[j]), acc[j], gyro[j]))
    lb = np.asarray(init_lb, np.float64)
    ub = np.asarray(init_ub, np.float64)
    u = draw_rng.random((n_frames, particle_count, 6))
    particles = (lb + (ub - lb) * u).astype(np.float32)
    return Drive(times[idx], gt_r, gt_t, scans, imu, particles)
