"""Range-image segmentation: projection, ground removal, connected components.

Port of `svnicp_tpu/core/segmentation.py` (the reference's LeGO-LOAM
`ImageProjection`): the scan is scattered into a fixed [n_scan, horizon]
range image, the nearest point winning a cell; ground is the inter-ring
angle test over the lowest rings; components are labelled by min-label
propagation with pointer jumping (each label the flat index of its
component's smallest cell), in a host loop that stops when no label
changes; valid segments plus every 5th ground column form the output cloud.

Copied as the JAX package computes it, quirks included:
- `project` scatters the range into a float32 image and tests each point
  against it in the working dtype. In float64 a point whose range rounds
  up in float32 loses to its own rounding and the cell stays empty (about
  half the cells); the image's ranges stay float32 in float64 runs.
- The angle constants are computed in the working dtype and rounded to
  float32 where they meet the float32 ranges, as JAX's weak types do.
- The rays of a spinning sensor lie on its ring angles, so a point's row
  (the floor of its elevation over the ring spacing) sits on a rounding
  edge, and one unit in the last place of atan2 moves it. In float32,
  `atan2f` is the function the JAX package's CPU backend calls (glibc's,
  from fdlibm) written out in torch operations, so the CPU and the card
  round alike; torch's own atan2 differs from it in about a quarter of
  these points. XLA also contracts a product and a sum into one fused
  multiply-add (`fma`, exact here in float32 on either device) and divides
  by a constant as a product with its reciprocal (`div`). torch's CPU
  square root is not correctly rounded (a fraction of a percent of float32
  inputs come out one unit off), so float32 roots are taken in float64
  there; the card's float32 root is correctly rounded (`sqrt`).

Written out, the float32 steps are a few hundred small operations a sweep.
On the card `segment_cloud` replays its projection and ground test, and
`features.select_features` its whole selection, as one CUDA graph
(`core/cuda_graph.py`): the constants are made on the device by fills, and
nothing on those paths waits for the host.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import torch

from svnicp_tpu_torch.core import cuda_graph
from svnicp_tpu_torch.core.pointcloud import PaddedCloud


@dataclasses.dataclass(frozen=True)
class SensorModel:
    """Scan-pattern geometry (ref: ImageProjection.h:46-111 presets)."""

    n_scan: int = 64
    horizon: int = 2250
    ang_res_y: float = 26.8 / 63.0
    ang_bottom: float = 24.8
    ground_rows: int = 7          # groundScanInd
    min_range: float = 1.0
    mount_angle: float = 0.0

    @property
    def ang_res_x(self) -> float:
        return 360.0 / self.horizon


HDL64 = SensorModel()
VLP16 = SensorModel(n_scan=16, horizon=1800, ang_res_y=2.0, ang_bottom=15.1, ground_rows=7)
HDL32 = SensorModel(n_scan=32, horizon=1800, ang_res_y=41.33 / 31.0, ang_bottom=30.67,
                    ground_rows=20)
SENSORS = {"hdl64": HDL64, "hdl32": HDL32, "vlp16": VLP16}

SEGMENT_THETA = 60.0 / 180.0 * 3.141592653589793
MIN_SEGMENT_CELLS = 30
MIN_SEGMENT_POINTS = 5
MIN_SEGMENT_LINES = 3
INVALID = -1.0
_DEG = 180.0 / math.pi


class RangeImage(NamedTuple):
    rng: torch.Tensor     # [R,C] float32 range (INVALID where empty)
    pts: torch.Tensor     # [R,C,3] the winning point per cell
    valid: torch.Tensor   # [R,C] bool
    ts: torch.Tensor      # [R,C] the winning point's sweep time (zeros
                          # without timestamps)


def _const(v, dtype, device) -> torch.Tensor:
    """A 0-d tensor of v rounded to dtype, made on the device by a fill (a
    copy from the host would wait for it, and a CUDA graph cannot hold it)."""
    if isinstance(v, torch.Tensor):
        return v.to(dtype)
    return torch.full((), v, dtype=dtype, device=device)


def fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c rounded once in float32 (a float32), as XLA's CPU backend
    contracts it: the exact sum of the float64 product and c, rounded to
    odd in float64 (TwoSum's error decides the last bit) and then to
    float32, which rounds as one rounding would. Other dtypes: a * b + c."""
    if a.dtype != torch.float32:
        return a * b + c
    b = _const(b, torch.float32, a.device)
    c = _const(c, torch.float32, a.device)
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    bb = s - p
    err = (p - (s - bb)) + (cd - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Square root, correctly rounded in float32 on every device (through
    float64 on the CPU, whose float32 root is not)."""
    if x.dtype != torch.float32 or x.device.type != "cpu":
        return torch.sqrt(x)
    return torch.sqrt(x.double()).float()


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as XLA compiles it: times the reciprocal of c rounded to x's
    dtype (its algebraic simplifier rewrites a division by a constant)."""
    return x * (1.0 / _const(c, x.dtype, x.device))


# fdlibm's atanf: atan(0.5), atan(1), atan(1.5), atan(inf) as hi + lo, and
# the odd polynomial's coefficients
_ATAN_HI = (4.6364760399e-01, 7.8539812565e-01, 9.8279368877e-01, 1.5707962513e+00)
_ATAN_LO = (5.0121582440e-09, 3.7748947079e-08, 3.4473217170e-08, 7.5497894159e-08)
_AT = (3.3333334327e-01, -2.0000000298e-01, 1.4285714924e-01, -1.1111110449e-01,
       9.0908870101e-02, -7.6918758452e-02, 6.6610731184e-02, -5.8335702866e-02,
       4.9768779427e-02, -3.6531571299e-02, 1.6285819933e-02)
_PI, _PI_LO, _PI_O_2 = 3.1415927410e+00, -8.7422776573e-08, 1.5707963705e+00


def _atanf_abs(x: torch.Tensor) -> torch.Tensor:
    """fdlibm's atanf for x >= 0 (finite or +inf), every step in float32."""
    def f(v):
        return _const(v, torch.float32, x.device)

    one = f(1.0)
    bits = x.view(torch.int32)
    # argument reduction by |x| < 7/16, 11/16, 19/16, 39/16, else 1/x
    ids = ((bits >= 0x3ee00000).to(torch.int64) + (bits >= 0x3f300000)
           + (bits >= 0x3f980000) + (bits >= 0x401c0000)) - 1
    red = torch.stack([
        x,
        (f(2.0) * x - one) / (f(2.0) + x),
        (x - one) / (x + one),
        (x - f(1.5)) / (one + f(1.5) * x),
        -one / x,
    ])
    xr = torch.gather(red, 0, (ids + 1)[None])[0]
    z = xr * xr
    w = z * z
    at = [f(a) for a in _AT]
    s1 = z * (at[0] + w * (at[2] + w * (at[4] + w * (at[6] + w * (at[8] + w * at[10])))))
    s2 = w * (at[1] + w * (at[3] + w * (at[5] + w * (at[7] + w * at[9]))))
    small = xr - xr * (s1 + s2)
    hi = torch.stack([f(v) for v in _ATAN_HI])
    lo = torch.stack([f(v) for v in _ATAN_LO])
    safe = ids.clamp_min(0)
    big = hi[safe] - ((xr * (s1 + s2) - lo[safe]) - xr)
    out = torch.where(ids < 0, small, big)
    # |x| >= 2^25 (inf included): atan(inf)
    return torch.where(bits >= 0x4c000000, hi[3] + lo[3], out)


def atan2f(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """atan2 of float32 tensors as glibc's atan2f (fdlibm's __ieee754_atan2f)
    computes it, for finite inputs."""
    def f(v):
        return _const(v, torch.float32, x.device)

    hx, hy = x.view(torch.int32), y.view(torch.int32)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    pi, pi_lo, pi_o_2 = f(_PI), f(_PI_LO), f(_PI_O_2)
    k = (iy - ix) >> 23
    z = _atanf_abs(torch.abs(y / x))
    z = torch.where(k > 60, pi_o_2 + f(0.5) * pi_lo, z)
    z = torch.where((hx < 0) & (k < -60), torch.zeros_like(z), z)
    neg_y, neg_x = hy < 0, hx < 0
    out = torch.where(neg_x, torch.where(neg_y, (z - pi_lo) - pi, pi - (z - pi_lo)),
                      torch.where(neg_y, -z, z))
    # x == 1: atanf(y) itself; y == 0 and x == 0 as fdlibm's special cases
    one_x = hx == 0x3F800000
    out = torch.where(one_x, torch.where(neg_y, -_atanf_abs(torch.abs(y)),
                                         _atanf_abs(torch.abs(y))), out)
    out = torch.where(iy == 0, torch.where(neg_x, torch.where(neg_y, -pi, pi), y), out)
    out = torch.where((ix == 0) & (iy != 0), torch.where(neg_y, -pi_o_2, pi_o_2), out)
    return out


def _atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return atan2f(y, x) if y.dtype == torch.float32 else torch.atan2(y, x)


def project(points: torch.Tensor, valid: torch.Tensor, sensor: SensorModel,
            timestamps: torch.Tensor | None = None) -> RangeImage:
    """Scatter a scan into the range image (ref: projectPointCloud :281-326):
    row from the vertical angle, column from the azimuth, the nearest range
    wins a cell, then the lowest point index among the winners."""
    r, c = sensor.n_scan, sensor.horizon
    n = points.shape[0]
    dev = points.device
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    h2 = fma(x, x, y * y)
    rng_ = sqrt(fma(z, z, h2))
    # the elevation and azimuth in degrees, offset
    vert = fma(_atan2(z, sqrt(h2)), _DEG, sensor.ang_bottom)
    row = torch.floor(div(vert, sensor.ang_res_y)).to(torch.int64)
    horiz = fma(_atan2(x, y), _DEG, -90.0)
    col = (-torch.round(div(horiz, sensor.ang_res_x))).to(torch.int32)
    col = col.to(torch.int64) + c // 2
    col = torch.where(col >= c, col - c, col)
    ok = (valid & (row >= 0) & (row < r) & (col >= 0) & (col < c)
          & (rng_ >= sensor.min_range))
    flat = torch.where(ok, row * c + col, torch.full_like(row, r * c))

    cell_rng = torch.full((r * c + 1,), 1e30, dtype=torch.float32, device=dev)
    cell_rng = cell_rng.scatter_reduce(
        0, flat, torch.where(ok, rng_, torch.full_like(rng_, 1e30)).to(torch.float32),
        "amin", include_self=True)
    wins = ok & (rng_ <= cell_rng[flat])
    idx = torch.arange(n, device=dev)
    cell_idx = torch.full((r * c + 1,), n, dtype=torch.int64, device=dev)
    cell_idx = cell_idx.scatter_reduce(
        0, torch.where(wins, flat, torch.full_like(flat, r * c)),
        torch.where(wins, idx, torch.full_like(idx, n)), "amin", include_self=True)
    cell_idx = cell_idx[: r * c]
    cell_ok = cell_idx < n
    pts_pad = torch.cat([points, points.new_zeros((1, 3))])
    img_pts = pts_pad[cell_idx].reshape(r, c, 3)
    img_rng = torch.where(cell_ok, cell_rng[: r * c],
                          torch.full_like(cell_rng[: r * c], INVALID)).reshape(r, c)
    if timestamps is None:
        img_ts = points.new_zeros((r, c))
    else:
        ts_pad = torch.cat([timestamps.to(points.dtype), points.new_zeros(1)])
        img_ts = ts_pad[cell_idx].reshape(r, c)
    return RangeImage(img_rng, img_pts, cell_ok.reshape(r, c), img_ts)


def ground_mask(img: RangeImage, sensor: SensorModel) -> torch.Tensor:
    """[R,C] bool ground map (ref: groundRemoval :329-377): a cell and the one
    above it are ground when their inter-ring elevation angle is <= 10 deg."""
    gr = sensor.ground_rows
    dv = img.pts[1: gr + 1] - img.pts[:gr]
    a = _atan2(dv[..., 2], sqrt(fma(dv[..., 0], dv[..., 0], dv[..., 1] * dv[..., 1])))
    both = img.valid[:gr] & img.valid[1: gr + 1]
    is_g = both & (torch.abs(fma(a, _DEG, -sensor.mount_angle)) <= 10.0)
    g = torch.zeros_like(img.valid)
    g[:gr] = is_g
    g[1: gr + 1] |= is_g
    return g


def _angle_consts(deg: float, dtype, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(sin, cos) of `deg` degrees, the radians computed in `dtype`, rounded
    to float32 (the sine and cosine correctly rounded, as libm's are)."""
    a = float(torch.tensor(deg, dtype=dtype) * (math.pi / 180.0))
    return (_const(math.sin(a), torch.float32, device),
            _const(math.cos(a), torch.float32, device))


def _edge_angle(d_from, d_to, sin_a, cos_a) -> torch.Tensor:
    d1 = torch.maximum(d_from, d_to)
    d2 = torch.minimum(d_from, d_to)
    return _atan2(d2 * sin_a, fma(-d2, cos_a, d1))


def _shift_rows(a: torch.Tensor, step: int, fill) -> torch.Tensor:
    """Row i takes row i+step (step = +-1), `fill` past the edge."""
    out = torch.full_like(a, fill)
    if step > 0:
        out[:-1] = a[1:]
    else:
        out[1:] = a[:-1]
    return out


def label_components(img: RangeImage, segmentable: torch.Tensor,
                     sensor: SensorModel) -> torch.Tensor:
    """Connected components under the LeGO-LOAM angle criterion -> [R,C]
    int64 labels: the flat index of each component's root cell, -1 for cells
    that are not segmentable. The angle steps' sines and cosines are taken
    in the points' dtype."""
    r, c = img.rng.shape
    dev = img.rng.device
    sx, cx = _angle_consts(sensor.ang_res_x, img.pts.dtype, dev)
    sy, cy = _angle_consts(sensor.ang_res_y, img.pts.dtype, dev)
    rngm = img.rng
    theta = _const(SEGMENT_THETA, torch.float32, dev)
    # (shift with its fill past the edge, the step's sin and cos) for the
    # right, left, lower and upper neighbour
    neighbours = (
        (lambda a, f: torch.roll(a, -1, 1), (sx, cx)),
        (lambda a, f: torch.roll(a, 1, 1), (sx, cx)),
        (lambda a, f: _shift_rows(a, 1, f), (sy, cy)),
        (lambda a, f: _shift_rows(a, -1, f), (sy, cy)),
    )
    edges = [segmentable & shift(segmentable, False)
             & (_edge_angle(rngm, shift(rngm, INVALID), *sc) > theta)
             for shift, sc in neighbours]

    n = r * c
    flat_idx = torch.arange(n, device=dev).reshape(r, c)
    lbl = torch.where(segmentable, flat_idx, torch.full_like(flat_idx, n)).reshape(-1)
    sentinel = torch.full((1,), n, dtype=lbl.dtype, device=dev)
    while True:
        lbl2 = lbl.reshape(r, c)
        cand = lbl2
        for (shift, _), e in zip(neighbours, edges):
            cand = torch.minimum(cand, torch.where(e, shift(lbl2, n), n))
        new = cand.reshape(-1)
        # pointer jumping: label <- label[label] twice (path halving)
        new = torch.cat([new, sentinel])[new]
        new = torch.cat([new, sentinel])[new]
        changed = bool((new != lbl).any())
        lbl = new
        if not changed:
            break
    return torch.where(lbl == n, -1, lbl).reshape(r, c)


def _project_ground(points, valid, timestamps, *, sensor):
    img = project(points, valid, sensor, timestamps)
    return (*img, ground_mask(img, sensor))


def segment_cloud(points: torch.Tensor, valid: torch.Tensor, sensor: SensorModel,
                  capacity: int, timestamps: torch.Tensor | None = None):
    """Full segmentation -> the odometry cloud (ref: cloudHandler flow,
    ImageProjection.h:251-267 + cloudSegmentation :379-433): cells of
    components with >= 30 cells, or >= 5 cells over >= 3 rings, plus every
    5th ground column and the first and last columns, compacted in cell
    order into `capacity` rows. With `timestamps`, returns (cloud, times)
    with the winning points' times carried through the projection."""
    r, c = sensor.n_scan, sensor.horizon
    dev = points.device
    ts = points.new_zeros(points.shape[0]) if timestamps is None else timestamps
    *fields, ground = cuda_graph.replay(
        ("project_ground", sensor), functools.partial(_project_ground, sensor=sensor),
        points, valid, ts)
    img = RangeImage(*fields)
    labels = label_components(img, img.valid & ~ground, sensor)

    n = r * c
    flat_labels = labels.reshape(-1)
    lbl_ok = flat_labels >= 0
    safe_lbl = torch.where(lbl_ok, flat_labels, n)
    counts = torch.zeros(n + 1, dtype=torch.int64, device=dev).index_add_(
        0, safe_lbl, lbl_ok.to(torch.int64))
    # distinct rings per component: a (label, ring) presence bitmap
    rows = torch.arange(r, device=dev)[:, None].expand(r, c).reshape(-1)
    present = torch.zeros((n + 1) * r, dtype=torch.int8, device=dev)
    present[(safe_lbl * r + rows)[lbl_ok]] = 1
    ring_counts = present.reshape(n + 1, r).sum(1)

    seg_ok = (counts >= MIN_SEGMENT_CELLS) | (
        (counts >= MIN_SEGMENT_POINTS) & (ring_counts >= MIN_SEGMENT_LINES))
    cell_in_segment = lbl_ok & seg_ok[safe_lbl]
    cols = torch.arange(c, device=dev)[None, :].expand(r, c).reshape(-1)
    keep_ground = ground.reshape(-1) & ((cols % 5 == 0) | (cols <= 5) | (cols >= c - 5))
    keep = (cell_in_segment | keep_ground) & img.valid.reshape(-1)

    order = torch.argsort((~keep).to(torch.int8), stable=True)[:capacity]
    out_keep = keep[order]
    pts = img.pts.reshape(-1, 3)[order]
    cloud = PaddedCloud(torch.where(out_keep[:, None], pts, torch.zeros_like(pts)),
                        out_keep)
    if timestamps is None:
        return cloud
    ts = img.ts.reshape(-1)[order]
    return cloud, torch.where(out_keep, ts, torch.zeros_like(ts))
