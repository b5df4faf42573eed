"""Fixed-capacity padded point clouds: crop, uniform downsample, deskew.

Port of `svnicp_tpu/core/pointcloud.py`. These are integer and sort
decisions, so the kept points and their order equal the JAX package's
exactly:
- `hash32` wraps uint32 arithmetic; here it runs in int64 with
  `& 0xFFFFFFFF` after every step (multiplications split in 16-bit halves
  so no int64 product overflows) and maps back to signed int32;
- JAX's variadic `lax.sort(num_keys=2, is_stable=True)` becomes two stable
  `torch.sort` passes, the secondary key first, then one gather;
- `INVALID_KEY` = 2^31-1 sorts last, and selected ranks are forced even so
  validity falls out of the sorted rank's parity.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from svnicp_tpu_torch.core import geometry as geo

_BITS = 10
_MASK = (1 << _BITS) - 1
_HALF = 1 << (_BITS - 1)

INVALID_KEY = 2**31 - 1
INT32_MAX = 2**31 - 1
_U32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) without int64 overflow."""
    lo = x & 0xFFFF
    hi = x >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & _U32


def to_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding a uint32 bit pattern -> the same bits as int32."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """uint32 product of int32 bit patterns, returned as int32 bits."""
    return to_int32(_mul32(x.to(torch.int64) & _U32, c))


def hash32(x: torch.Tensor) -> torch.Tensor:
    """Avalanche integer hash with uint32 wrapping -> int32 (the JAX
    package's `hash32`, bit for bit)."""
    x = x.to(torch.int64) & _U32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return to_int32(x)


def compaction_order(keep: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """Permutation putting kept entries first, ordered by hash(key) so a
    capacity truncation drops a spatially uniform subset; a stable sort, so
    ties keep their order (the JAX package's `compaction_order`)."""
    rank = torch.where(keep, hash32(key), torch.full_like(key, INT32_MAX))
    return torch.argsort(rank, stable=True)


class PaddedCloud(NamedTuple):
    points: torch.Tensor   # [N,3]
    valid: torch.Tensor    # [N] bool

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def count(self) -> torch.Tensor:
        return self.valid.sum()


def from_numpy(points, capacity: int, dtype=torch.float32, device=None
               ) -> PaddedCloud:
    """Pad or truncate a host [N,3] array into a cloud of `capacity` rows."""
    n = min(len(points), capacity)
    pts = torch.zeros((capacity, 3), dtype=dtype)
    pts[:n] = torch.as_tensor(points[:n]).to(dtype)
    return PaddedCloud(pts.to(device), (torch.arange(capacity) < n).to(device))


def _pack(v: torch.Tensor) -> torch.Tensor:
    v = v.to(torch.int64)
    vx = (v[:, 0] + _HALF) & _MASK
    vy = (v[:, 1] + _HALF) & _MASK
    vz = (v[:, 2] + _HALF) & _MASK
    return ((vx << (2 * _BITS)) | (vy << _BITS) | vz).to(torch.int32)


def voxel_coords(points: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """points / voxel_size as the JAX package's compiled code computes it: a
    product with the reciprocal of the voxel size rounded to the working
    dtype, on the CPU and on the card alike. (A true division differs on
    points that sit on a voxel edge: 6 floor and 12 trunc keys of
    1,000,000 float32 points at 0.2 m.)"""
    if points.dtype == torch.float32:
        inv = float(np.float32(1.0) / np.float32(voxel_size))
    else:
        inv = 1.0 / voxel_size
    return points * inv


def voxel_key(points: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """[N,3] -> packed int32 voxel ids, truncating toward zero like the
    reference's `(p / voxel).cast<int>()` (the map's keys)."""
    return _pack(torch.trunc(voxel_coords(points, voxel_size)).to(torch.int32))


def floor_voxel_key(points: torch.Tensor, voxel_size: float) -> torch.Tensor:
    """[N,3] -> packed int32 voxel ids on the floor grid (downsampling)."""
    return _pack(torch.floor(voxel_coords(points, voxel_size)).to(torch.int32))


def sq_norm3(v: torch.Tensor) -> torch.Tensor:
    """x*x + y*y + z*z in that order (the order numpy and XLA sum a length-3
    axis), so distance decisions round like the JAX package's."""
    return v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1] + v[..., 2] * v[..., 2]


def crop(cloud: PaddedCloud, min_range: float, max_range: float) -> PaddedCloud:
    """Range gate: keep min_range < |p| < max_range."""
    d2 = sq_norm3(cloud.points)
    ok = (d2 < max_range * max_range) & (d2 > min_range * min_range)
    return PaddedCloud(cloud.points, cloud.valid & ok)


def deskew(points: torch.Tensor, valid: torch.Tensor, timestamps: torch.Tensor,
           delta_xi: torch.Tensor) -> torch.Tensor:
    """Motion-compensate a scan: p <- exp((tau - 0.5) delta_xi) p, with tau
    the per-point time min-max normalised over the valid rows and delta_xi
    [6] the last relative motion log(T_{k-2}^-1 T_{k-1}) (ref:
    OdometryPipeline.cpp:414-445). A scan whose valid times are all equal,
    and every invalid row, passes through unchanged."""
    big = torch.finfo(timestamps.dtype).max
    tmin = torch.where(valid, timestamps, torch.full_like(timestamps, big)).min()
    tmax = torch.where(valid, timestamps, torch.full_like(timestamps, -big)).max()
    span = tmax - tmin
    tau = (timestamps - tmin) / torch.where(span > 0, span, torch.ones_like(span))
    r, t = geo.se3_exp((tau - 0.5)[:, None] * delta_xi[None, :])
    out = (r @ points[:, :, None])[:, :, 0] + t
    return torch.where((span > 0) & valid[:, None], out, points)


def stable_sort_by(keys: tuple[torch.Tensor, ...]) -> torch.Tensor:
    """Permutation sorting lexicographically by `keys` (first key major),
    stable: one stable pass per key, least significant first."""
    perm = torch.argsort(keys[-1], stable=True)
    for key in reversed(keys[:-1]):
        perm = perm[torch.argsort(key[perm], stable=True)]
    return perm


def compact_by_rank(rank: torch.Tensor, points: torch.Tensor, capacity: int
                    ) -> PaddedCloud:
    """Stable sort by an int32 rank whose selected entries are even
    (INT32_MAX, odd, marks the rest); keep the first `capacity` rows and
    read validity from the sorted rank's parity."""
    srank, order = torch.sort(rank, stable=True)
    keep = (srank[:capacity] & 1) == 0
    pts = points[order[:capacity]]
    return PaddedCloud(torch.where(keep[:, None], pts, torch.zeros_like(pts)),
                       keep)


def downsample_uniform(cloud: PaddedCloud, voxel_size: float, capacity: int
                       ) -> PaddedCloud:
    """Keep one point per voxel, the one nearest the voxel centre (PCL
    UniformSampling); compact the kept points first in hash order."""
    pts = cloud.points
    key = torch.where(cloud.valid, floor_voxel_key(pts, voxel_size),
                      torch.full_like(cloud.valid, INVALID_KEY, dtype=torch.int32))
    center = (torch.floor(voxel_coords(pts, voxel_size)) + 0.5) * voxel_size
    d_center = sq_norm3(pts - center)
    d_center = torch.where(cloud.valid, d_center,
                           torch.full_like(d_center, float("inf")))
    order = stable_sort_by((key, d_center))
    skey = key[order]
    first = torch.ones_like(skey, dtype=torch.bool)
    first[1:] = skey[1:] != skey[:-1]
    keep = first & (skey != INVALID_KEY)
    rank = torch.where(keep, hash32(skey) & -2,
                       torch.full_like(skey, INT32_MAX))
    return compact_by_rank(rank, pts[order], capacity)


def kitti_vertical_correction(points: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """KITTI raw-scan fixes (ref: OdometryPipeline.cpp:385-400): rotate each
    point 0.205 deg about p x z, and azimuth pseudo-times in [0,1] for
    deskewing -> (corrected points [N,3], times [N])."""
    z = torch.tensor([0.0, 0.0, 1.0], dtype=points.dtype, device=points.device)
    axis = torch.linalg.cross(points, z.expand_as(points))
    axis = axis / torch.clamp_min(torch.linalg.vector_norm(axis, dim=-1, keepdim=True),
                                  1e-12)
    rot = geo.so3_exp((0.205 * np.pi / 180.0) * axis)
    corrected = (rot @ points[:, :, None])[:, :, 0]
    yaw = -torch.atan2(corrected[:, 1], corrected[:, 0])
    return corrected, 0.5 * (yaw / np.pi + 1.0)
