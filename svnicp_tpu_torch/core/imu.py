"""IMU strapdown mechanization (port of `svnicp_tpu/core/imu.py`).

Two reference behaviors that differ from textbook strapdown are kept, as
the JAX package keeps them (ref: IMU.cpp:20-58):
- the gravity increment of the velocity is rotated into the body-derived
  frame (`R g dt`) while the one of the position is not;
- the attitude increment composes as Euler RzRyRx of (gyro dt), not the
  exponential map.
The pipeline interpolates a sample at the LiDAR stamp on the host, in
`runtime/ingest.py`, as the JAX package's LIOPipeline does; `interpolate`
is the reference's own form of that interpolation.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svnicp_tpu_torch.core import geometry as geo

# ref: svn-icp/include/sensor/IMU.h:24
GRAVITY = 9.782940329221166


class IMUSample(NamedTuple):
    """One IMU measurement."""

    dt: torch.Tensor     # [] seconds since the previous sample
    acc: torch.Tensor    # [3] linear acceleration (body)
    gyro: torch.Tensor   # [3] angular velocity (body)


class NavState(NamedTuple):
    """Pose + velocity (ref: gtsam::NavState in data/DataTypes.h:56-122)."""

    r: torch.Tensor   # [3,3] body-to-nav rotation
    t: torch.Tensor   # [3] position
    v: torch.Tensor   # [3] velocity

    @staticmethod
    def identity(dtype=torch.float32, device=None) -> "NavState":
        return NavState(torch.eye(3, dtype=dtype, device=device),
                        torch.zeros(3, dtype=dtype, device=device),
                        torch.zeros(3, dtype=dtype, device=device))


def compensate(sample: IMUSample, bias_acc: torch.Tensor,
               bias_gyro: torch.Tensor) -> IMUSample:
    """Subtract the estimated biases (ref: IMUCompensation, IMU.cpp:60-63)."""
    return IMUSample(sample.dt, sample.acc - bias_acc, sample.gyro - bias_gyro)


def propagate(state: NavState, imu_start: IMUSample,
              imu_finish: IMUSample) -> NavState:
    """One strapdown step (ref: IMUPropagation, IMU.cpp:20-58)."""
    g = torch.tensor([0.0, 0.0, -GRAVITY], dtype=state.t.dtype,
                     device=state.t.device)
    d_vfn = state.r @ (imu_start.acc * imu_start.dt)
    d_vgn = (state.r @ g) * imu_finish.dt          # reference quirk: rotated g
    vel = state.v + d_vfn + d_vgn
    dt = imu_finish.dt
    t_new = state.t + state.v * dt + 0.5 * g * dt * dt + 0.5 * d_vfn * dt
    rot_vec = imu_start.gyro * dt
    d_r = geo.euler_zyx_to_matrix(rot_vec[0], rot_vec[1], rot_vec[2])
    return NavState(state.r @ d_r, t_new, vel)


def interpolate(lidar_offset: torch.Tensor, imu_gap: torch.Tensor,
                imu_pre: IMUSample, imu_current: IMUSample
                ) -> tuple[IMUSample, IMUSample, IMUSample]:
    """Linear interpolation of an IMU sample at the LiDAR stamp, from the
    offset of the stamp after `imu_pre` and the gap between the two
    samples -> (pre', mid, cur') with the reference's dt bookkeeping (ref:
    IMUInterpolation, IMU.cpp:65-79): pre'.dt = the pre->lidar gap,
    cur'.dt = the lidar->cur gap, and mid.dt = 0 (the reference leaves the
    interpolated sample's dt default-initialised, DataTypes.h:132)."""
    ratio = lidar_offset / torch.clamp_min(imu_gap, 1e-9)
    mid = IMUSample(torch.zeros_like(lidar_offset),
                    (1.0 - ratio) * imu_pre.acc + ratio * imu_current.acc,
                    (1.0 - ratio) * imu_pre.gyro + ratio * imu_current.gyro)
    pre = IMUSample(lidar_offset, imu_pre.acc, imu_pre.gyro)
    cur = IMUSample(imu_gap - lidar_offset, imu_current.acc, imu_current.gyro)
    return pre, mid, cur
