"""The SVNL sensor log: writer, reader, `play`, and the synthetic and
HDL-64 proxy recorders (port of `svnicp_tpu/io/stream.py`).

The log is the offline stand-in for the reference's ROS subscriber pair
(ref: svn-icp/src/core/OdometryPipeline.cpp:307-354): a packet stream
played through `LIOPipeline.feed_imu` / `feed_scan` in record order, the
call sequence the ROS executor would make. A cloud packet holds
interleaved point records described by field offsets, as a PointCloud2
does, read by strided views and the native time-field extraction
(`io/native.extract_timestamps`).

Format (little-endian, magic "SVNL\\x01"):

    packet  := u8 type, f64 stamp, u32 payload_len, payload
    type 1  := IMU     payload = f32 acc[3], f32 gyro[3]
    type 2  := CLOUD   payload = u32 n_points, u32 point_step,
                       u32 off_x, off_y, off_z (f32 fields),
                       i32 off_time (-1 = none), u8 time_dtype
                       (0=f4, 1=f8, 2=u4), u8 pad[3],
                       n_points * point_step raw record bytes

Rows with a non-finite coordinate are dropped on reading, before the time
field is normalised (ref: ImageProjection.h:233-249). The writer, the
reader and `record_synthetic` are numpy, so both packages write the same
bytes and each reads the other's logs; `record_proxy` interpolates its
sweeps' poses in float32 (`datasets.raycast_sweep`), so its points agree
with the JAX package's to float32 rounding.
"""

from __future__ import annotations

import struct
from typing import IO, Iterator, NamedTuple

import numpy as np

MAGIC = b"SVNL\x01"
IMU_PACKET = 1
CLOUD_PACKET = 2
_HEADER = struct.Struct("<Bd I")          # type, stamp, payload_len
_CLOUD_HEAD = struct.Struct("<IIIIIiB3x")  # n, step, offx, offy, offz, offt, tdtype
_TIME_DTYPES = {0: "f4", 1: "f8", 2: "u4"}
_TIME_CODES = {v: k for k, v in _TIME_DTYPES.items()}


class CloudPacket(NamedTuple):
    stamp: float
    points: np.ndarray            # [n,3] f32, non-finite rows removed
    timestamps: np.ndarray | None  # [n] f32 normalized sweep time, or None


class ImuPacket(NamedTuple):
    stamp: float
    acc: np.ndarray               # [3] f32
    gyro: np.ndarray              # [3] f32


class StreamWriter:
    """Append-only SVNL writer (tests, dataset conversion, live capture)."""

    def __init__(self, f: IO[bytes]):
        self._f = f
        f.write(MAGIC)

    def write_imu(self, stamp: float, acc, gyro) -> None:
        payload = (np.asarray(acc, "<f4").tobytes()
                   + np.asarray(gyro, "<f4").tobytes())
        self._f.write(_HEADER.pack(IMU_PACKET, stamp, len(payload)) + payload)

    def write_cloud(self, stamp: float, records: bytes | np.ndarray,
                    n_points: int, point_step: int,
                    off_xyz: tuple[int, int, int] = (0, 4, 8),
                    off_time: int = -1, time_dtype: str = "f4") -> None:
        """Write interleaved point records exactly as captured (a
        PointCloud2 `data` buffer passes through verbatim)."""
        raw = (records.tobytes() if isinstance(records, np.ndarray)
               else bytes(records))
        if len(raw) != n_points * point_step:
            raise ValueError(
                f"records carry {len(raw)} bytes, expected "
                f"{n_points}*{point_step}")
        head = _CLOUD_HEAD.pack(n_points, point_step, *off_xyz,
                                off_time, _TIME_CODES[time_dtype])
        self._f.write(_HEADER.pack(CLOUD_PACKET, stamp,
                                   len(head) + len(raw)) + head + raw)

    def write_cloud_xyz(self, stamp: float, xyz: np.ndarray,
                        timestamps: np.ndarray | None = None) -> None:
        """Convenience: pack a plain [n,3] float cloud (+ optional per-point
        times) into tightly packed records."""
        xyz = np.ascontiguousarray(xyz, "<f4")
        if timestamps is None:
            self.write_cloud(stamp, xyz, len(xyz), 12)
        else:
            rec = np.concatenate(
                [xyz, np.asarray(timestamps, "<f4")[:, None]], axis=1)
            self.write_cloud(stamp, np.ascontiguousarray(rec), len(xyz), 16,
                             off_time=12, time_dtype="f4")


def _parse_cloud(stamp: float, payload: bytes) -> CloudPacket:
    n, step, ox, oy, oz, ot, tcode = _CLOUD_HEAD.unpack_from(payload)
    raw = np.frombuffer(payload, np.uint8, count=n * step,
                        offset=_CLOUD_HEAD.size)
    # zero-copy strided view over the interleaved records (the numpy
    # equivalent of the reference's field-offset reads)
    xyz_dtype = np.dtype({"names": ["x", "y", "z"],
                          "formats": ["<f4"] * 3,
                          "offsets": [ox, oy, oz], "itemsize": step})
    rec = raw.view(xyz_dtype).reshape(n) if n else np.empty(0, xyz_dtype)
    pts = np.empty((n, 3), np.float32)
    pts[:, 0], pts[:, 1], pts[:, 2] = rec["x"], rec["y"], rec["z"]
    # NaN-removal FIRST, then timestamp normalization over survivors only:
    # invalid returns often carry NaN xyz with zero/garbage time fields, and
    # one such stamp among absolute epoch stamps would collapse the [0,1]
    # min-max range of the real sweep (the reference also drops NaN rows
    # before deskew normalization, ImageProjection.h:233-249).
    finite = np.isfinite(pts).all(axis=1)
    if not finite.all():
        pts = pts[finite]
        raw = np.ascontiguousarray(
            raw.reshape(n, step)[finite].reshape(-1))
        n = len(pts)
    ts = None
    if ot >= 0 and n:
        from svnicp_tpu_torch.io import native

        ts, ok = native.extract_timestamps(raw, n, step, ot,
                                           _TIME_DTYPES[tcode])
        if not ok:
            ts = None
    return CloudPacket(stamp, pts, ts)


class StreamReader:
    """Iterate an SVNL log in record order (the stream is stamped in
    arrival order, as a live subscriber would see it)."""

    def __init__(self, f: IO[bytes]):
        if f.read(len(MAGIC)) != MAGIC:
            raise ValueError("not an SVNL stream (bad magic)")
        self._f = f

    def __iter__(self) -> Iterator[CloudPacket | ImuPacket]:
        while True:
            head = self._f.read(_HEADER.size)
            if not head:
                return
            if len(head) < _HEADER.size:
                raise ValueError("truncated SVNL packet header")
            ptype, stamp, plen = _HEADER.unpack(head)
            payload = self._f.read(plen)
            if len(payload) < plen:
                raise ValueError("truncated SVNL payload")
            if ptype == IMU_PACKET:
                v = np.frombuffer(payload, "<f4")
                if v.shape[0] != 6:
                    raise ValueError(f"IMU payload has {v.shape[0]} floats")
                yield ImuPacket(stamp, v[:3].copy(), v[3:].copy())
            elif ptype == CLOUD_PACKET:
                yield _parse_cloud(stamp, payload)
            else:
                raise ValueError(f"unknown SVNL packet type {ptype}")


def play(pipeline, f: IO[bytes], progress=None):
    """Feed a recorded stream through a LIOPipeline, mirroring the
    reference's callback dispatch (IMU packets -> feed_imu, cloud packets
    -> feed_scan with per-point times when present). Returns the number of
    cloud packets fed."""
    n_clouds = 0
    for pkt in StreamReader(f):
        if isinstance(pkt, ImuPacket):
            pipeline.feed_imu(pkt.stamp, pkt.acc, pkt.gyro)
        else:
            pipeline.feed_scan(pkt.stamp, pkt.points, timestamps=pkt.timestamps)
            n_clouds += 1
            if progress is not None:
                progress(n_clouds, pkt.stamp)
    pipeline.flush()
    return n_clouds


def record_proxy(path: str, n_frames: int = 40, frame_dt: float = 0.1,
                 imu_rate: float = 100.0, speed: float = 1.5, seed: int = 3,
                 extent: float = 60.0, col_step: int = 3,
                 range_noise: float = 0.02, dropout: float = 0.05,
                 gyro_noise: float = 0.005, acc_noise: float = 0.05,
                 gyro_bias: float = 0.001, acc_bias: float = 0.02,
                 ramp_seconds: float = 1.0, n_groups: int = 25,
                 path_shape: str = "straight", loop_radius: float = 6.0,
                 scan_range: float = 80.0,
                 world_kwargs: dict | None = None) -> np.ndarray:
    """The HDL-64 proxy log: per frame a motion-distorted raycast sweep
    (`datasets.raycast_sweep`: the 64 x 2250 ray pattern, one pose per
    column group, range noise, dropout) with its per-point times; between
    frames `imu_rate` Hz IMU samples with white noise and constant biases.
    Packets go in arrival order: a scan after the IMU samples that cover its
    sweep. With `path_shape="loop"` the path is a circle of `loop_radius`
    (`datasets.circular_trajectory`), and `scan_range` below its diameter
    lets drift compound until the start comes back into view.

    Scans are stamped at mid-sweep; returns the [n_frames,4,4] mid-sweep
    poses, the frame the deskewed cloud lives in.
    """
    from svnicp_tpu_torch.core.imu import GRAVITY
    from svnicp_tpu_torch.io import datasets

    world = datasets.SyntheticWorld(extent=extent, seed=seed,
                                    **(world_kwargs or {}))
    imu_dt = 1.0 / imu_rate
    stride = int(round(frame_dt * imu_rate))
    n_dense = n_frames * stride + 2
    if path_shape == "loop":
        # closure scenario: circle through fresh territory; cap scan_range
        # below 2*loop_radius so drift compounds until the start region
        # re-enters view (see datasets.circular_trajectory)
        times, rots, trans = datasets.circular_trajectory(
            n_dense, dt=imu_dt, radius=loop_radius,
            angular_rate=speed / loop_radius)
    else:
        times, rots, trans = datasets.synthetic_trajectory(
            n_dense, dt=imu_dt, speed=speed, seed=seed,
            ramp_seconds=ramp_seconds)
    clean_imu = datasets.synthetic_imu(times, rots, trans, GRAVITY)
    rng = np.random.default_rng(seed + 1)
    bg = rng.normal(scale=gyro_bias, size=3)
    ba = rng.normal(scale=acc_bias, size=3)
    gt = np.tile(np.eye(4), (n_frames, 1, 1))
    with open(path, "wb") as f:
        w = StreamWriter(f)
        scan_i = 0
        for t, acc, gyro in clean_imu:
            while scan_i < n_frames:
                mid_stamp = (scan_i * stride + stride / 2.0) * imu_dt
                if mid_stamp > t:
                    break
                k0, k1 = scan_i * stride, (scan_i + 1) * stride
                pts, tau, (mid_r, mid_t) = datasets.raycast_sweep(
                    world._surfaces, rots[k0], trans[k0], rots[k1], trans[k1],
                    col_step=col_step, n_groups=n_groups, noise=range_noise,
                    dropout=dropout, rng=rng, max_range=scan_range)
                w.write_cloud_xyz(float(mid_stamp), pts, tau)
                gt[scan_i, :3, :3] = mid_r
                gt[scan_i, :3, 3] = mid_t
                scan_i += 1
            w.write_imu(float(t),
                        acc + ba + rng.normal(scale=acc_noise, size=3),
                        gyro + bg + rng.normal(scale=gyro_noise, size=3))
    return gt


def record_synthetic(path: str, n_frames: int = 20, dt: float = 0.1,
                     speed: float = 1.5, seed: int = 5, n_points: int = 4000,
                     extent: float = 40.0, ramp_seconds: float = 1.0,
                     with_time_field: bool = True) -> np.ndarray:
    """Write a synthetic world trajectory as an SVNL log (demo/CI data
    source; returns the [n_frames,4,4] ground-truth poses)."""
    from svnicp_tpu_torch.core.imu import GRAVITY
    from svnicp_tpu_torch.io import datasets

    world = datasets.SyntheticWorld(extent=extent, seed=seed)
    times, rots, trans = datasets.synthetic_trajectory(
        n_frames, dt=dt, speed=speed, seed=seed, ramp_seconds=ramp_seconds)
    rng = np.random.default_rng(seed)
    imu = list(datasets.synthetic_imu(times, rots, trans, GRAVITY))
    with open(path, "wb") as f:
        w = StreamWriter(f)
        scan_i = 0
        for t, acc, gyro in imu:
            while scan_i < n_frames and times[scan_i] <= t:
                pts = world.scan_at(rng, rots[scan_i], trans[scan_i],
                                    n_points=n_points, noise=0.01)
                if with_time_field:
                    ts = rng.uniform(0.0, 1.0, len(pts)).astype(np.float32)
                    w.write_cloud_xyz(float(times[scan_i]), pts, ts)
                else:
                    w.write_cloud_xyz(float(times[scan_i]), pts)
                scan_i += 1
            w.write_imu(float(t), acc, gyro)
        while scan_i < n_frames:     # scans after the last IMU sample
            pts = world.scan_at(rng, rots[scan_i], trans[scan_i],
                                n_points=n_points, noise=0.01)
            if with_time_field:
                ts = rng.uniform(0.0, 1.0, len(pts)).astype(np.float32)
                w.write_cloud_xyz(float(times[scan_i]), pts, ts)
            else:
                w.write_cloud_xyz(float(times[scan_i]), pts)
            scan_i += 1
    gt = np.tile(np.eye(4), (n_frames, 1, 1))
    gt[:, :3, :3] = rots
    gt[:, :3, 3] = trans
    return gt
