"""Constraint-aware source selection: LOAM-style range-image feature picks.

Port of `svnicp_tpu/core/features.py`. On the range image of the raw
sweep (`segmentation.project`), each ring is compacted so its valid cells
form a prefix in azimuth order; the LOAM smoothness (relative curvature)
over +-window of those neighbours marks edge picks (curvature maxima) and
planar picks (minima), a quota of each per (ring, sector); cells at a
depth discontinuity are excluded; ground (the inter-ring angle test over
all rings, or a height within 0.25 m of a robust floor estimate) is kept
out of both and readmitted under its own quota, ordered by a hash of the
cell index. Per-point sweep times ride through the projection.

Tie order is the JAX package's: `lax.top_k` returns equal values lower
index first, so a quota is the first k of a stable descending sort, and
boolean keys sort as integers. `_sector_topk` drops the trailing
`horizon % sectors` columns as the JAX package does (every preset divides
evenly). Curvature runs on the image's float32 ranges in float64 runs too.
On the card the selection is replayed as one CUDA graph (`core/cuda_graph.py`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import torch

from svnicp_tpu_torch.core import cuda_graph
from svnicp_tpu_torch.core import segmentation as seg
from svnicp_tpu_torch.core.pointcloud import PaddedCloud, _mul32


class SelectedFeatures(NamedTuple):
    points: torch.Tensor      # [cap,3] selected points (zeros at invalid slots)
    valid: torch.Tensor       # [cap] bool
    timestamps: torch.Tensor  # [cap] sweep times of the selected points
    n_edge: torch.Tensor      # scalar int64 diagnostics
    n_planar: torch.Tensor
    n_ground: torch.Tensor


def _compact_rows(img: seg.RangeImage):
    """Sort each row so valid cells form a prefix in azimuth order ->
    (order, rng, pts, ts, valid), each [R,C] (pts [R,C,3])."""
    order = torch.argsort((~img.valid).to(torch.int8), dim=1, stable=True)
    rng_c = torch.gather(img.rng, 1, order)
    ts_c = torch.gather(img.ts, 1, order)
    valid_c = torch.gather(img.valid, 1, order)
    pts_c = torch.gather(img.pts, 1, order[..., None].expand(*order.shape, 3))
    return order, rng_c, pts_c, ts_c, valid_c


def _curvature(rng_c: torch.Tensor, valid_c: torch.Tensor, window: int):
    """LOAM smoothness |sum_j (r_j - r_0)| / (2 window r_0) over the +-window
    in-prefix neighbours; cells without a full window score -1 and are not
    eligible -> (curv, eligible)."""
    c = rng_c.shape[1]
    acc = torch.zeros_like(rng_c)
    all_ok = valid_c
    for j in range(1, window + 1):
        for sgn in (-1, 1):
            shifted = torch.roll(rng_c, -sgn * j, 1)
            ok = torch.roll(valid_c, -sgn * j, 1)
            acc = acc + torch.where(ok, shifted - rng_c, torch.zeros_like(rng_c))
            all_ok = all_ok & ok
    idx = torch.arange(c, device=rng_c.device)[None, :]
    n_valid = valid_c.sum(1, keepdim=True)
    eligible = all_ok & (idx >= window) & (idx < n_valid - window)
    denom = (2.0 * window) * torch.clamp_min(rng_c, 1e-6)
    curv = torch.abs(acc) / denom
    return torch.where(eligible, curv, torch.full_like(curv, -1.0)), eligible


def _occlusion_free(rng_c: torch.Tensor, valid_c: torch.Tensor, rel_thr: float):
    """Immediate-neighbour relative range jump below rel_thr on both sides
    (LOAM's occluded-boundary exclusion)."""
    nxt = torch.roll(rng_c, -1, 1)
    prv = torch.roll(rng_c, 1, 1)
    lim = rel_thr * rng_c
    return valid_c & (torch.abs(nxt - rng_c) < lim) & (torch.abs(prv - rng_c) < lim)


def _topk_first(x: torch.Tensor, k: int):
    """`lax.top_k` over the last axis: the k largest, equal values lower
    index first -> (values, indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _sector_topk(score: torch.Tensor, sectors: int, k: int):
    """Top-k score per (row, sector) over the compacted azimuth axis ->
    (column within the row [R, sectors*k], keep mask: score > 0)."""
    r, c = score.shape
    cs = c // sectors
    sc = score[:, : sectors * cs].reshape(r, sectors, cs)
    top, idx = _topk_first(sc, k)
    base = (torch.arange(sectors, device=score.device) * cs)[None, :, None]
    cols = (idx + base).reshape(r, sectors * k)
    return cols, (top > 0.0).reshape(r, sectors * k)


def select_features(points: torch.Tensor, valid: torch.Tensor,
                    timestamps: torch.Tensor, sensor: seg.SensorModel,
                    capacity: int, **options) -> SelectedFeatures:
    """`select_features_ops`, which the card replays as one CUDA graph."""
    fn = functools.partial(select_features_ops, sensor=sensor, capacity=capacity,
                           **options)
    key = ("select_features", sensor, capacity, *sorted(options.items()))
    return SelectedFeatures(*cuda_graph.replay(key, fn, points, valid, timestamps))


def select_features_ops(
    points: torch.Tensor,       # [N,3] raw scan (skewed ok)
    valid: torch.Tensor,        # [N] bool
    timestamps: torch.Tensor,   # [N] per-point sweep time (zeros if absent)
    sensor: seg.SensorModel,
    capacity: int,
    *,
    max_range: float = 80.0,
    sectors: int = 18,
    edge_k: int = 2,
    planar_k: int = 4,
    ground_cap: int = 512,
    edge_threshold: float = 0.05,
    planar_threshold: float = 0.02,
    occlusion_threshold: float = 0.3,
    window: int = 5,
) -> SelectedFeatures:
    """Select a constraint-balanced source cloud from a raw sweep, op by op.
    Output order is [edges, planars, ground], truncated at `capacity`: on
    overflow the ground quota goes first, then planar tails."""
    assert sensor.horizon % sectors == 0, (sensor.horizon, sectors)
    img = seg.project(points, valid, sensor, timestamps)
    in_range = img.valid & (img.rng <= max_range)
    img = img._replace(valid=in_range, rng=torch.where(
        in_range, img.rng, torch.full_like(img.rng, seg.INVALID)))
    # the inter-ring angle test over all rings, not the preset's ground_rows
    ground_angle = seg.ground_mask(
        img, dataclasses.replace(sensor, ground_rows=sensor.n_scan - 1))

    order, rng_c, pts_c, ts_c, valid_c = _compact_rows(img)
    # floor height: cell heights box-averaged over +-2 in-prefix neighbours
    # (at least 3 of them), the minimum over the image as the floor
    z = pts_c[..., 2]
    z_c = torch.where(valid_c, z, torch.full_like(z, float("inf")))
    zsum = torch.zeros_like(z)
    zcnt = torch.zeros_like(z)
    for j in range(-2, 3):
        zj = torch.roll(z_c, j, 1)
        ok = torch.isfinite(zj)
        zsum = zsum + torch.where(ok, zj, torch.zeros_like(zj))
        zcnt = zcnt + ok.to(z.dtype)
    zmean = torch.where(zcnt >= 3, zsum / torch.clamp_min(zcnt, 1.0),
                        torch.full_like(z, float("inf")))
    floor_est = zmean.min()
    ground_z = valid_c & (z < floor_est + 0.25)
    ground_c = torch.gather(ground_angle, 1, order) | ground_z

    curv, eligible = _curvature(rng_c, valid_c, window)
    pickable = eligible & _occlusion_free(rng_c, valid_c, occlusion_threshold) & ~ground_c
    none = torch.full_like(curv, -1.0)
    edge_score = torch.where(pickable & (curv > edge_threshold), curv, none)
    planar_score = torch.where(pickable & (curv < planar_threshold) & (curv >= 0),
                               planar_threshold - curv + 1e-6, none)

    r, c = rng_c.shape
    e_cols, e_keep = _sector_topk(edge_score, sectors, edge_k)
    p_cols, p_keep = _sector_topk(planar_score, sectors, planar_k)

    def gather(cols, keep):
        pts = torch.gather(pts_c, 1, cols[..., None].expand(*cols.shape, 3))
        ts = torch.gather(ts_c, 1, cols)
        return pts.reshape(-1, 3), ts.reshape(-1), keep.reshape(-1)

    e_pts, e_ts, e_valid = gather(e_cols, e_keep)
    p_pts, p_ts, p_valid = gather(p_cols, p_keep)

    # ground quota: the cells of largest hash priority (cell * 2654435761
    # mod 2^32) >> 8, a scattered deterministic sample
    g_flat = (ground_c & valid_c).reshape(-1)
    cell = torch.arange(r * c, device=points.device)
    prio = torch.where(g_flat, _mul32(cell, 2654435761) >> 8, 0)
    _, g_idx = _topk_first(prio, ground_cap)
    g_valid = g_flat[g_idx]
    g_pts = pts_c.reshape(-1, 3)[g_idx]
    g_pts = torch.where(g_valid[:, None], g_pts, torch.zeros_like(g_pts))
    g_ts = ts_c.reshape(-1)[g_idx]
    g_ts = torch.where(g_valid, g_ts, torch.zeros_like(g_ts))

    all_pts = torch.cat([e_pts, p_pts, g_pts])
    all_ts = torch.cat([e_ts, p_ts, g_ts])
    all_valid = torch.cat([e_valid, p_valid, g_valid])
    sel = torch.argsort((~all_valid).to(torch.int8), stable=True)[:capacity]
    out_valid = all_valid[sel]
    out_pts = torch.where(out_valid[:, None], all_pts[sel], torch.zeros_like(all_pts[sel]))
    out_ts = torch.where(out_valid, all_ts[sel], torch.zeros_like(all_ts[sel]))
    return SelectedFeatures(out_pts, out_valid, out_ts, e_valid.sum(),
                            p_valid.sum(), g_valid.sum())


def as_cloud(sel: SelectedFeatures) -> PaddedCloud:
    return PaddedCloud(sel.points, sel.valid)
