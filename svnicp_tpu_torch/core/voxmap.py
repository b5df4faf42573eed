"""Device-resident voxel-hash local map, a key-sorted fixed-capacity table.

Port of `svnicp_tpu/core/voxmap.py` (`create`, `insert`, `query_radius`,
`voxel_candidates`).
The reference semantics it keeps, with the same sorts and therefore the
same rows in the same order as the JAX package:
- a stable merge of old and new points by voxel key (old points first), a
  per-voxel cap, first come first kept;
- whole-voxel eviction by the distance of the voxel's first point, and
  radius queries gated the same way (each row gathers its run's first
  row's flag, the run start found by binary search on the sorted keys,
  where the JAX package takes a cummax over run-start indices);
- at capacity, a spatially uniform subset is shed by a per-row hash
  threshold, `sort(shed)[capacity-1]`;
- a radius that selects nothing returns the whole map;
- `voxel_candidates` reads the 27-voxel neighbourhood of each query point
  by binary search on the sorted keys (`torch.searchsorted`, whose
  `right=False` / `right=True` are JAX's `side="left"` / `"right"`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svnicp_tpu_torch.core import geometry as geo
from svnicp_tpu_torch.core.pointcloud import (
    INT32_MAX, INVALID_KEY, PaddedCloud, _pack, compact_by_rank, hash32,
    mul_u32, sq_norm3, voxel_coords, voxel_key)
from svnicp_tpu_torch.runtime.profiling import count


class VoxelMap(NamedTuple):
    """Sorted-by-key padded point table; invalid slots carry INVALID_KEY and
    sort to the end."""

    points: torch.Tensor   # [C,3] world-frame points
    key: torch.Tensor      # [C] int32 packed voxel id, ascending
    valid: torch.Tensor    # [C] bool

    @property
    def capacity(self) -> int:
        return self.points.shape[0]

    def count(self) -> torch.Tensor:
        return self.valid.sum()


def create(capacity: int, dtype=torch.float32, device=None) -> VoxelMap:
    return VoxelMap(
        points=torch.zeros((capacity, 3), dtype=dtype, device=device),
        key=torch.full((capacity,), INVALID_KEY, dtype=torch.int32,
                       device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )


def get_all(vmap: VoxelMap) -> PaddedCloud:
    """The whole map as a padded cloud (ref: GetMap(), VoxelHashMap.cpp:43-49)."""
    return PaddedCloud(vmap.points, vmap.valid)


def _run_start(sorted_key: torch.Tensor) -> torch.Tensor:
    """Index of the first row holding each row's key (int64), by binary
    search on the ascending keys: no scan, no read-back. The INVALID_KEY
    tail is one run."""
    count("svnicp.map.run_searches")
    return torch.searchsorted(sorted_key, sorted_key, right=False)


def insert(vmap: VoxelMap, scan: PaddedCloud, pose_r: torch.Tensor,
           pose_t: torch.Tensor, voxel_size: float, max_points_per_voxel: int,
           max_range: float) -> tuple[VoxelMap, torch.Tensor]:
    """Transform the scan to world, merge with per-voxel caps, evict voxels
    whose first point lies beyond `max_range` of the pose, shed to capacity.
    Returns (new map, number of rows shed for capacity)."""
    c = vmap.capacity
    world = geo.transform_points(pose_r, pose_t, scan.points)
    new_key = torch.where(scan.valid, voxel_key(world, voxel_size),
                          torch.full_like(scan.valid, INVALID_KEY,
                                          dtype=torch.int32))
    all_pts = torch.cat([vmap.points, world], dim=0)
    all_key = torch.cat([vmap.key, new_key], dim=0)
    skey, order = torch.sort(all_key, stable=True)
    spts = all_pts[order]

    start = _run_start(skey)
    rank = (torch.arange(skey.shape[0], device=skey.device)
            - start).to(torch.int32)
    keep = (skey != INVALID_KEY) & (rank < max_points_per_voxel)
    d2 = sq_norm3(spts - pose_t)
    keep &= (d2 <= max_range * max_range)[start]
    kept_total = keep.sum()

    # capacity shedding: keep the rows whose per-row hash is at most the
    # c-th smallest; with no overflow the threshold is INT32_MAX filler
    shed = hash32(skey ^ mul_u32(rank, 0x9E3779B9))
    shed = torch.where(keep, shed, torch.full_like(shed, INT32_MAX))
    thresh = torch.sort(shed).values[c - 1]
    keep &= shed <= thresh

    fkey, forder = torch.sort(
        torch.where(keep, skey, torch.full_like(skey, INVALID_KEY)),
        stable=True)
    fkey = fkey[:c]
    fkeep = fkey != INVALID_KEY
    pts = spts[forder[:c]]
    pts = torch.where(fkeep[:, None], pts, torch.zeros_like(pts))
    return VoxelMap(pts, fkey, fkeep), (kept_total - c).clamp_min(0)


def query_radius(vmap: VoxelMap, center: torch.Tensor, radius: float,
                 target_capacity: int) -> tuple[PaddedCloud, torch.Tensor]:
    """All map points whose voxel's first point lies within `radius` of
    `center`, compacted in hash order into `target_capacity` rows; the whole
    map when the radius selects nothing. Returns (target cloud, number of
    selected points that did not fit)."""
    d2 = sq_norm3(vmap.points - center)
    in_radius = vmap.valid & (d2 <= radius * radius)[_run_start(vmap.key)]
    selected = torch.where(in_radius.any(), in_radius, vmap.valid)
    rank = torch.where(selected, hash32(vmap.key) & -2,
                       torch.full_like(vmap.key, INT32_MAX))
    cloud = compact_by_rank(rank, vmap.points, target_capacity)
    overflow = (selected.sum() - target_capacity).clamp_min(0)
    return cloud, overflow


def _neighbour_offsets(device) -> torch.Tensor:
    """The 27 offsets (dx, dy, dz) in {-1, 0, 1}^3, dz fastest."""
    r = torch.arange(-1, 2, device=device)
    return torch.cartesian_prod(r, r, r)


def voxel_candidates(vmap: VoxelMap, query_pts: torch.Tensor,
                     query_valid: torch.Tensor, voxel_size: float,
                     per_voxel_cap: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Correspondence candidates from the voxel hash itself: the first
    `per_voxel_cap` points of each of the 27 voxels around every query
    point (world frame, at the guess) -> (cand_pts [B, 27*cap, 3],
    cand_valid [B, 27*cap]). Any map point within one voxel of the query
    lies in the neighbourhood; farther matches fall to the outlier gate."""
    b, c = query_pts.shape[0], vmap.capacity
    v = torch.trunc(voxel_coords(query_pts, voxel_size)).to(torch.int64)
    neigh = v[:, None, :] + _neighbour_offsets(query_pts.device)[None]
    keys27 = _pack(neigh.reshape(-1, 3)).reshape(b, 27)
    start = torch.searchsorted(vmap.key, keys27, right=False)
    end = torch.searchsorted(vmap.key, keys27, right=True)
    take = start[..., None] + torch.arange(per_voxel_cap, device=query_pts.device)
    in_run = take < end[..., None]                              # [B,27,cap]
    take = take.clamp(0, c - 1)
    cand = vmap.points[take]
    valid = in_run & vmap.valid[take] & query_valid[:, None, None]
    k = 27 * per_voxel_cap
    return cand.reshape(b, k, 3), valid.reshape(b, k)
