"""The voxel map partitioned in key-range blocks over the mesh point axis.

Port of `svnicp_tpu/parallel/voxmap_sharded.py`: each point shard owns one
contiguous range of packed voxel keys (an x-slab), so a voxel's rows never
straddle shards and every per-voxel rule of `core/voxmap.py` applies to a
block unchanged; the particle axis holds copies of the blocks. The global
map is the blocks one after another, C/S rows each.
- `sharded_insert`: each block takes the scan rows it owns and runs the
  ordinary insert; the shed counts are summed.
- `rebalance`: when the fullest block holds more than 1.5x the mean,
  new boundaries are weighted quantiles of a strided sample of resident
  keys (all-gathered), and the rows move to their new owners by one ring
  pass (`_ring_redistribute`); `sharded_reanchor` moves the points rigidly,
  re-keys them and moves rows by the same pass.
- `sharded_register_with_map`: candidates from every block by a ring of
  `ppermute`s (each block's full K, then the union's K nearest), then the
  mesh-parallel align of `parallel/sharding.py` on the plain route.
Keys, split keys, row order and drop counts equal the JAX package's
exactly: stable sorts where JAX sorts stably (`lax.sort`, `jnp.argsort`),
a stable sort for `lax.top_k`, int32 counters, and the quantiles' float32
running sum added in XLA's order on the CPU (`xla_cumsum`).
"""

from __future__ import annotations

import torch

from svnicp_tpu_torch.config import SteinICPConfig
from svnicp_tpu_torch.core import geometry as geo
from svnicp_tpu_torch.core import residuals, svn
from svnicp_tpu_torch.core import voxmap as vm
from svnicp_tpu_torch.core.pointcloud import (INVALID_KEY, PaddedCloud,
                                              compaction_order, stable_sort_by,
                                              voxel_key)
from svnicp_tpu_torch.kernels import knn
from svnicp_tpu_torch.parallel import sharding
from svnicp_tpu_torch.parallel.mesh import PARTICLE_AXIS, POINT_AXIS

KEY_SPACE = 1 << 30     # packed keys live in [0, 2^30)
_BLOCK = (POINT_AXIS, POINT_AXIS, POINT_AXIS)
_SCAN_BASE = 16         # XLA's reduce-window scan rewrite: 16-element chunks


def shard_bounds(shard_idx: int, n_shards: int) -> tuple[int, int]:
    """[lo, hi) packed-key range a shard owns under the uniform split."""
    width = KEY_SPACE // n_shards
    lo = shard_idx * width
    return lo, KEY_SPACE if shard_idx == n_shards - 1 else lo + width


def uniform_split_keys(n_shards: int, device=None) -> torch.Tensor:
    """[S-1] int32 upper boundaries of the uniform split: shard s owns keys
    in [splits[s-1], splits[s]), with splits[-1] = 0 and splits[S-1] = inf."""
    width = KEY_SPACE // n_shards
    return torch.arange(1, n_shards, dtype=torch.int32, device=device) * width


def owner_of(keys: torch.Tensor, split_keys: torch.Tensor) -> torch.Tensor:
    """The shard owning each packed key under the boundaries."""
    return torch.searchsorted(split_keys, keys, right=True).to(torch.int32)


def xla_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive float running sum of a 1-D tensor, rounded as the JAX
    package's compiled CPU code rounds `jnp.cumsum`: XLA rewrites the
    reduce-window into 16-element chunks, each summed left to right, plus
    the running sum of the chunk totals before it (the same rewrite,
    recursively), padded with zeros."""
    n = x.shape[0]
    m = -(-n // _SCAN_BASE) * _SCAN_BASE
    if n > _SCAN_BASE:
        x = torch.cat([x, x.new_zeros(m - n)])
    chunks = x.reshape(-1, min(n, _SCAN_BASE))
    cols = [chunks[:, 0]]
    for j in range(1, chunks.shape[1]):
        cols.append(cols[-1] + chunks[:, j])
    within = torch.stack(cols, dim=1)
    if n <= _SCAN_BASE:
        return within.reshape(-1)
    before = torch.cat([x.new_zeros(1), xla_cumsum(within[:, -1])[:-1]])
    return (within + before[:, None]).reshape(-1)[:n]


def sharded_insert(mesh, vmap_global: vm.VoxelMap, scan: PaddedCloud, pose_r,
                   pose_t, voxel_size: float, max_points_per_voxel: int,
                   max_range: float, split_keys: torch.Tensor | None = None
                   ) -> tuple[vm.VoxelMap, torch.Tensor]:
    """Insert a (replicated) scan into the sharded map: each block masks
    the scan to its key range and runs the ordinary insert -> (map, rows
    shed over all blocks)."""
    if split_keys is None:
        split_keys = uniform_split_keys(mesh.shape[POINT_AXIS], pose_t.device)

    def body(coll, points_l, key_l, valid_l, scan_pts, scan_valid, r, t, splits):
        me = coll.axis_index(POINT_AXIS)
        keys = voxel_key(geo.transform_points(r, t, scan_pts), voxel_size)
        mine = scan_valid & (owner_of(keys, splits) == me)
        new, dropped = vm.insert(vm.VoxelMap(points_l, key_l, valid_l),
                                 PaddedCloud(scan_pts, mine), r, t, voxel_size,
                                 max_points_per_voxel, max_range)
        return (new.points, new.key, new.valid,
                coll.psum(dropped.to(torch.int32), POINT_AXIS))

    pts, key, valid, dropped = mesh.run(
        body, (*vmap_global, scan.points, scan.valid, pose_r, pose_t, split_keys),
        _BLOCK + (None,) * 5, _BLOCK + (None,))
    return vm.VoxelMap(pts, key, valid), dropped


def _ring_redistribute(coll, points_l, key_l, valid_l, splits, me: int,
                       n_shards: int):
    """One ring pass moving rows to the shard that owns their key under
    `splits`: each shard keeps an accumulator of its capacity and absorbs
    the rows it owns from every block that visits (hash-ordered truncation
    on overflow, as `voxmap.insert` sheds). Rows carry their global rank
    before the pass (shard * capacity + row) and the result is sorted by
    (key, rank), so the row order is the replicated table's whatever the
    ring's arrival order. -> (points, key, valid, dropped int32)."""
    cl = key_l.shape[0]
    dev = key_l.device
    pts, key, valid = points_l, key_l, valid_l
    rank = me * cl + torch.arange(cl, dtype=torch.int32, device=dev)
    acc_pts = torch.zeros_like(points_l)
    acc_key = torch.full_like(key_l, INVALID_KEY)
    acc_valid = torch.zeros_like(valid_l)
    acc_rank = torch.zeros_like(key_l)
    dropped = torch.zeros((), dtype=torch.int32, device=dev)
    for step in range(n_shards):
        mine = valid & (owner_of(key, splits) == me)
        cat_key = torch.cat([acc_key, torch.where(mine, key, torch.full_like(key, INVALID_KEY))])
        cat_pts = torch.cat([acc_pts, pts])
        cat_valid = torch.cat([acc_valid, mine])
        cat_rank = torch.cat([acc_rank, rank])
        kept_total = cat_valid.sum(dtype=torch.int32)
        korder = compaction_order(cat_valid, cat_key)[:cl]
        k_keep = cat_valid[korder]
        k_key = torch.where(k_keep, cat_key[korder], torch.full_like(acc_key, INVALID_KEY))
        k_pts = torch.where(k_keep[:, None], cat_pts[korder], torch.zeros_like(acc_pts))
        k_rank = cat_rank[korder]
        order = stable_sort_by((k_key, k_rank))
        acc_key, acc_rank, acc_pts = k_key[order], k_rank[order], k_pts[order]
        acc_valid = acc_key != INVALID_KEY
        dropped = dropped + (kept_total - cl).clamp_min(0)
        if step < n_shards - 1:     # the JAX scan's last shift returns unused blocks
            pts = coll.ppermute(pts, POINT_AXIS)
            key = coll.ppermute(key, POINT_AXIS)
            valid = coll.ppermute(valid, POINT_AXIS)
            rank = coll.ppermute(rank, POINT_AXIS)
    return acc_pts, acc_key, acc_valid, dropped


def rebalance(mesh, vmap_global: vm.VoxelMap, split_keys: torch.Tensor,
              sample_per_shard: int = 512, imbalance_threshold: float = 1.5
              ) -> tuple[vm.VoxelMap, torch.Tensor, torch.Tensor]:
    """Occupancy rebalance: when the fullest block holds more than
    `imbalance_threshold` x the mean occupancy, the boundaries become
    weighted quantiles of `sample_per_shard` strided keys of each block
    (one all_gather), and rows move to their owners by one ring pass.
    Below the threshold the boundaries stay and the pass changes nothing,
    so the call is safe every K frames. -> (map, split keys, rows shed)."""

    def body(coll, points_l, key_l, valid_l, splits):
        me, n = coll.axis_index(POINT_AXIS), coll.axis_size(POINT_AXIS)
        cnt = valid_l.sum(dtype=torch.int32)
        counts = coll.all_gather(cnt, POINT_AXIS)                # [S]
        total = counts.sum(dtype=torch.int32)
        mean_occ = total.to(torch.float32) / n
        need = bool((counts.max().to(torch.float32)
                     > imbalance_threshold * torch.clamp_min(mean_occ, 1.0))
                    & (total > 0))
        # the block is key-sorted with its valid rows first: a strided index
        # over the first `cnt` rows samples its resident keys uniformly
        m = sample_per_shard
        idx = (torch.arange(m, dtype=torch.int32, device=key_l.device)
               * cnt.clamp_min(1)) // m
        has = cnt > 0
        samp = torch.where(has, key_l[idx.long()], torch.full_like(idx, KEY_SPACE))
        w = torch.where(has, cnt.to(torch.float32) / m,
                        torch.zeros((), dtype=torch.float32, device=key_l.device))
        samp_all = coll.all_gather(samp, POINT_AXIS).reshape(-1)
        w_all = torch.repeat_interleave(coll.all_gather(w, POINT_AXIS), m)
        order = torch.argsort(samp_all, stable=True)
        sk, cum = samp_all[order], xla_cumsum(w_all[order])
        targets = (torch.arange(1, n, dtype=torch.float32, device=key_l.device)
                   * (total.to(torch.float32) / n))
        pos = torch.searchsorted(cum, targets).clamp(0, sk.shape[0] - 1)
        # the boundary after the quantile key, so equal keys stay together
        new_splits = torch.cummax(sk[pos] + 1, dim=0).values if n > 1 else splits
        if not need:
            new_splits = splits
        acc = _ring_redistribute(coll, points_l, key_l, valid_l, new_splits, me, n)
        return (*acc[:3], new_splits, coll.psum(acc[3], POINT_AXIS))

    pts, key, valid, new_splits, dropped = mesh.run(
        body, (*vmap_global, split_keys), _BLOCK + (None,), _BLOCK + (None, None))
    return vm.VoxelMap(pts, key, valid), new_splits, dropped


def sharded_reanchor(mesh, vmap_global: vm.VoxelMap, split_keys: torch.Tensor,
                     delta_r, delta_t, voxel_size: float
                     ) -> tuple[vm.VoxelMap, torch.Tensor]:
    """Rigid world-frame move of the sharded map (the pose-graph re-anchor):
    each block moves and re-keys its points, and the rows whose key left
    the block's range migrate to their owner by the rebalance ring pass.
    The boundaries stay. -> (map, rows shed)."""

    def body(coll, points_l, key_l, valid_l, splits, dr, dt):
        me, n = coll.axis_index(POINT_AXIS), coll.axis_size(POINT_AXIS)
        pts = points_l @ dr.T + dt[None, :]
        key = torch.where(valid_l, voxel_key(pts, voxel_size),
                          torch.full_like(key_l, INVALID_KEY))
        pts = torch.where(valid_l[:, None], pts, torch.zeros_like(pts))
        acc = _ring_redistribute(coll, pts, key, valid_l, splits, me, n)
        return (*acc[:3], coll.psum(acc[3], POINT_AXIS))

    pts, key, valid, dropped = mesh.run(
        body, (*vmap_global, split_keys, delta_r, delta_t), _BLOCK + (None,) * 3,
        _BLOCK + (None,))
    return vm.VoxelMap(pts, key, valid), dropped


def _ring_candidates(coll, source_l, src_valid_l, blk_pts, blk_valid, k: int,
                     method: str = "bucketed"):
    """K candidates from every map block by a point-axis ring, then the K
    nearest of the S*K union (lower slot first at ties, as `lax.top_k`):
    per block the exact top-K with "topk" (whose union's top-K is the exact
    global KNN), else the blocked-cyclic group minima. The composed set
    does not depend on how the map is split. -> (cand_pts [Bl,K,3],
    cand_valid [Bl,K])."""
    n = coll.axis_size(POINT_AXIS)
    bl = source_l.shape[0]
    pts, valid = blk_pts, blk_valid
    got_pts, got_d2 = [], []
    for step in range(n):
        if method == "topk":
            idx, d2 = knn.knn_candidates(source_l, pts, src_valid_l, valid, k)
        else:
            idx, d2 = knn.knn_candidates_bucketed(source_l, pts, src_valid_l, valid, k)
        got_pts.append(pts[idx.clamp(0, pts.shape[0] - 1)])   # JAX clamps the gather
        got_d2.append(d2)
        if step < n - 1:
            pts = coll.ppermute(pts, POINT_AXIS)
            valid = coll.ppermute(valid, POINT_AXIS)
    acc_pts = torch.stack(got_pts, dim=1).reshape(bl, n * k, 3)
    acc_d2 = torch.stack(got_d2, dim=1).reshape(bl, n * k)
    top_d2, sel = torch.sort(acc_d2, dim=1, stable=True)
    sel = sel[:, :k]
    cand_pts = torch.gather(acc_pts, 1, sel[..., None].expand(-1, -1, 3))
    return cand_pts, torch.isfinite(top_d2[:, :k])


def sharded_register_with_map(mesh, cfg: SteinICPConfig, source, src_valid,
                              vmap_global: vm.VoxelMap, r0, t0, init_particles,
                              history: bool = False):
    """Distributed registration against the sharded map: ring-gathered
    candidates at the guess (the exact global KNN under candidate_method
    "topk"), then the mesh-parallel SVN loop on the plain route (no
    kernel). With history, (result, [iters,P,6])."""

    def body(coll, source_l, src_valid_l, map_pts_l, map_key_l, map_valid_l,
             r0_l, t0_l, init_l):
        at_guess = geo.transform_points(r0_l, t0_l, source_l)
        cand_pts, cand_valid = _ring_candidates(coll, at_guess, src_valid_l, map_pts_l,
                                                map_valid_l, cfg.knn_count,
                                                method=cfg.candidate_method)
        feat, bias = svn.correspondence_features(source_l, cand_pts, cand_valid)
        normals = None
        if cfg.residual == "point_to_plane":
            normals = residuals.plane_normals(cand_pts, cand_valid)
        prep = svn.AlignPrep(cand_pts, cand_valid, normals, feat, bias, None)
        return sharding._align_shard(coll, cfg, source_l, src_valid_l, prep, r0_l,
                                     t0_l, init_l, history)

    outs = mesh.run(body, (source, src_valid, *vmap_global, r0, t0, init_particles),
                    (POINT_AXIS,) * 5 + (None, None, PARTICLE_AXIS),
                    sharding.RESULT_SPECS)
    return sharding.to_result(outs, history)
