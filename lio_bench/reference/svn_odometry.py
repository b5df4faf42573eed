"""Plain reference of SVN-ICP odometry: staging, the voxel map, stage-1
candidates, the Stein variational Newton registration and the error-state
Kalman filter, written from the upstream method's description in plain
PyTorch, for any dtype and device.

It imports nothing of the program (`svnicp_tpu_torch`) and nothing of JAX.
Its semantics are the upstream reference's, with the choices the
configuration files state (LIS-TU-Berlin/SVN-ICP: OdometryPipeline.cpp for
staging and the frame, VoxelHashMap.cpp for the map, SVNICP.cpp for the
registration, ESEKF.cpp and IMU.cpp for the filter), and with the integer
choices that make a fixed-capacity map reproducible: packed 10-bit voxel
ids, a 32-bit avalanche hash that orders compaction and capacity shedding,
stable sorts throughout. Distances, products and sums are written the
straightforward way; the only precision knob is `Precision`:

- `Precision(torch.float64)`: the reference the judge compares against;
- `Precision(torch.float32, tf32=True)`: the control, every product
  (matrix products, the distance cross terms, the moment sums) taking its
  operands rounded to TF32's 10-bit mantissa, as the card's tensor cores do
  with `allow_tf32`.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

# the options this reference implements, at the only values it implements
# (the judge refuses a configuration that sets another: `check_supported`)
SUPPORTED = {
    "icp": {"method": "svn", "residual": "point_to_point", "candidate_method": "bucketed",
            "match_count": 0, "prior_information": False, "stein_kernel": True,
            "svn_full_grad": False, "convergence_metric": "grad_norm",
            "adaptive_prior": False, "use_minibatch": False},
    "preprocess": {"deskew": False, "use_segmentation": False, "feature_select": False,
                   "host_downsample": False, "quantize_upload": False},
    "lio": {"cov_filter": "none", "use_const_cov": False, "init_from_motion": False,
            "textbook_phi": False},
    "map": {"sharded": False},
}

INVALID_KEY = 2**31 - 1
INT32_MAX = 2**31 - 1
_U32 = 0xFFFFFFFF
_JITTER = 1e-6
MIN_CONSTRAINT_POINTS = 6


@dataclasses.dataclass(frozen=True)
class Precision:
    dtype: torch.dtype = torch.float64
    tf32: bool = False


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to TF32 (10 explicit mantissa bits), to nearest
    with ties to even; other dtypes pass through."""
    if x.dtype != torch.float32:
        return x
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    bits = torch.where(bits >= 2**31, bits - 2**32, bits)
    return bits.to(torch.int32).view(torch.float32).reshape(x.shape)


class Ops:
    """Products in the reference's precision."""

    def __init__(self, prec: Precision, device):
        self.prec = prec
        self.dtype = prec.dtype
        self.device = torch.device(device)

    def r(self, x):
        return tf32_round(x) if self.prec.tf32 else x

    def mm(self, a, b):
        return self.r(a) @ self.r(b)

    def ein(self, eq, *ops):
        return torch.einsum(eq, *(self.r(o) for o in ops))

    def t(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(dtype=self.dtype, device=self.device)
        return torch.as_tensor(np.asarray(x), dtype=self.dtype, device=self.device)


# ----------------------------------------------------------------- SO(3), SE(3)

def skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _coeffs(a2):
    small = a2 < 1e-6
    a = torch.sqrt(torch.where(small, torch.ones_like(a2), a2))
    s = torch.where(small, 1.0 - a2 / 6.0, torch.sin(a) / a)
    c = torch.where(small, 0.5 - a2 / 24.0, (1.0 - torch.cos(a)) / (a * a))
    s3 = torch.where(small, 1.0 / 6.0 - a2 / 120.0, (a - torch.sin(a)) / (a * a * a))
    return s, c, s3


def so3_exp(w):
    """Rodrigues: I + sin(a)/a W + (1-cos a)/a^2 W^2."""
    s, c, _ = _coeffs((w * w).sum(-1))
    wx = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + s[..., None, None] * wx + c[..., None, None] * (wx @ wx)


def left_jacobian(w):
    _, c, s3 = _coeffs((w * w).sum(-1))
    wx = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + c[..., None, None] * wx + s3[..., None, None] * (wx @ wx)


def so3_log(r):
    tr = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos_a = torch.clamp(0.5 * (tr - 1.0), -1.0, 1.0)
    vee = 0.5 * torch.stack([r[..., 2, 1] - r[..., 1, 2], r[..., 0, 2] - r[..., 2, 0],
                             r[..., 1, 0] - r[..., 0, 1]], -1)
    sin_a = torch.linalg.vector_norm(vee, dim=-1)
    angle = torch.atan2(sin_a, cos_a)
    small = sin_a < 1e-9
    factor = torch.where(small, 1.0 + (1.0 - cos_a) / 3.0,
                         angle / torch.where(small, torch.ones_like(sin_a), sin_a))
    return factor[..., None] * vee


def se3_log(r, t):
    w = so3_log(r)
    rho = torch.linalg.solve(left_jacobian(w), t[..., None])[..., 0]
    return torch.cat([rho, w], -1)


def se3_exp(xi):
    return so3_exp(xi[..., 3:]), (left_jacobian(xi[..., 3:]) @ xi[..., :3, None])[..., 0]


def compose(ra, ta, rb, tb):
    return ra @ rb, ra @ tb + ta


def euler_zyx(v):
    """R = Rz(v2) Ry(v1) Rx(v0): the IMU attitude increment of IMU.cpp."""
    cr, sr = torch.cos(v[0]), torch.sin(v[0])
    cp, sp = torch.cos(v[1]), torch.sin(v[1])
    cy, sy = torch.cos(v[2]), torch.sin(v[2])
    return torch.stack([
        torch.stack([cp * cy, sr * sp * cy - cr * sy, sr * sy + cr * sp * cy]),
        torch.stack([cp * sy, cr * cy + sr * sp * sy, cr * sp * sy - sr * cy]),
        torch.stack([-sp, sr * cp, cr * cp])])


# ------------------------------------------------------------- keys and hashes

def to_signed32(x):
    return torch.where(x >= 2**31, x - 2**32, x)


def mul32(x, c: int):
    """(x * c) mod 2^32 for x in [0, 2^32), without an int64 overflow."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + ((hi * (c & 0xFFFF)) << 16)) & _U32


def hash32(x):
    """The 32-bit avalanche hash (x ^= x>>16; x *= 0x7FEB352D; x ^= x>>15;
    x *= 0x846CA68B; x ^= x>>16) of int32 bit patterns, as signed int64."""
    x = x.to(torch.int64) & _U32
    x = x ^ (x >> 16)
    x = mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return to_signed32(x)


def pack(v):
    """Integer voxel coordinates [N,3] -> packed ids, 10 bits an axis."""
    v = v.to(torch.int64)
    return ((((v[:, 0] + 512) & 1023) << 20) | (((v[:, 1] + 512) & 1023) << 10)
            | ((v[:, 2] + 512) & 1023))


def stable_order(*keys):
    """Permutation sorting by keys (first major), stable."""
    perm = torch.argsort(keys[-1], stable=True)
    for k in reversed(keys[:-1]):
        perm = perm[torch.argsort(k[perm], stable=True)]
    return perm


def run_first(sorted_key):
    """Index of the first row of each row's run of equal keys."""
    n = sorted_key.shape[0]
    start = torch.ones(n, dtype=torch.bool, device=sorted_key.device)
    start[1:] = sorted_key[1:] != sorted_key[:-1]
    idx = torch.arange(n, device=sorted_key.device)
    return torch.cummax(torch.where(start, idx, torch.zeros_like(idx)), 0).values


# ---------------------------------------------------------------------- staging

def crop(pts, valid, lo: float, hi: float):
    d2 = (pts * pts).sum(-1)
    return valid & (d2 > lo * lo) & (d2 < hi * hi)


def downsample(pts, valid, voxel: float, capacity: int):
    """One uniform-sampling stage: per voxel (floor grid) the point nearest
    the voxel centre (the first at equal distance), the voxels compacted in
    ascending (hash(id) & -2) order, the first `capacity` kept."""
    vox = torch.floor(pts / voxel)
    key = torch.where(valid, pack(vox), torch.full_like(valid, INVALID_KEY, dtype=torch.int64))
    d = ((pts - (vox + 0.5) * voxel) ** 2).sum(-1)
    d = torch.where(valid, d, torch.full_like(d, math.inf))
    order = stable_order(key, d)
    skey, spts = key[order], pts[order]
    first = torch.ones_like(skey, dtype=torch.bool)
    first[1:] = skey[1:] != skey[:-1]
    keep = first & (skey != INVALID_KEY)
    rank = torch.where(keep, hash32(skey) & -2, torch.full_like(skey, INT32_MAX))
    sel = torch.argsort(rank, stable=True)[:capacity]
    out_valid = (rank[sel] & 1) == 0
    out = torch.where(out_valid[:, None], spts[sel], torch.zeros_like(spts[sel]))
    return out, out_valid


def stage(ops: Ops, scan: np.ndarray, cfg: dict):
    """A raw scan (float32, sensor frame; a 4th column of sweep times, where
    there is one, is not read: with deskew off the times are ignored) ->
    (cropped, to_map, source), each (points, valid): the extrinsic, the
    range crop, the 0.5-voxel stage (twice the source capacity) and the
    1.5-voxel stage of that."""
    pp, icp, lio = cfg["preprocess"], cfg["icp"], cfg["lio"]
    scan = scan[:, :3]
    pts = ops.t(scan)
    r_ext = np.asarray(lio.get("extrinsic_R", np.eye(3).ravel()), float).reshape(3, 3)
    t_ext = np.asarray(lio.get("extrinsic_t", [0.0, 0.0, 0.0]), float)
    if not (np.allclose(r_ext, np.eye(3)) and np.allclose(t_ext, 0.0)):
        # the lidar-to-IMU extrinsic on the sensor's float32 points, as the
        # upstream node applies it to its float clouds (OdometryPipeline.cpp:349)
        f32 = Ops(Precision(torch.float32, ops.prec.tf32), ops.device)
        pts = ops.t(f32.mm(f32.t(scan), f32.t(r_ext).T) + f32.t(t_ext))
    valid = crop(pts, torch.ones(len(pts), dtype=torch.bool, device=pts.device),
                 pp["min_range"], pp["max_range"])
    pts = torch.where(valid[:, None], pts, torch.zeros_like(pts))
    v, cap = pp["voxel_size"], icp["source_capacity"]
    to_map = downsample(pts, valid, 0.5 * v, 2 * cap)
    source = downsample(*to_map, 1.5 * v, cap)
    return (pts, valid), to_map, source


# ------------------------------------------------------------------------ map

@dataclasses.dataclass
class VoxelMap:
    points: torch.Tensor   # [C,3]
    key: torch.Tensor      # [C] int64, ascending, INVALID_KEY past the end
    valid: torch.Tensor    # [C]

    @staticmethod
    def empty(capacity: int, ops: Ops) -> "VoxelMap":
        return VoxelMap(torch.zeros((capacity, 3), dtype=ops.dtype, device=ops.device),
                        torch.full((capacity,), INVALID_KEY, dtype=torch.int64,
                                   device=ops.device),
                        torch.zeros(capacity, dtype=torch.bool, device=ops.device))


def map_insert(ops: Ops, vmap: VoxelMap, pts, valid, pose_r, pose_t, mcfg: dict):
    """Merge a cloud at a pose: old rows before new ones in each voxel (ids
    by truncation toward zero), at most max_points_per_voxel per voxel,
    whole voxels evicted whose first row lies beyond max_range of the pose,
    then at capacity the rows whose hash(id ^ rank * golden) exceed the
    capacity-th smallest are shed."""
    c = vmap.points.shape[0]
    world = ops.mm(pts, pose_r.T) + pose_t
    key = torch.where(valid, pack(torch.trunc(world / mcfg["voxel_size"])),
                      torch.full_like(valid, INVALID_KEY, dtype=torch.int64))
    all_pts = torch.cat([vmap.points, world])
    all_key = torch.cat([vmap.key, key])
    order = torch.argsort(all_key, stable=True)
    skey, spts = all_key[order], all_pts[order]
    n = skey.shape[0]
    first = run_first(skey)
    rank = torch.arange(n, device=skey.device) - first
    keep = (skey != INVALID_KEY) & (rank < mcfg["max_points_per_voxel"])
    near = ((spts - pose_t) ** 2).sum(-1) <= mcfg["max_range"] ** 2
    keep &= near[first]
    salt = to_signed32(mul32(rank & _U32, 0x9E3779B9))
    shed = hash32(to_signed32((skey ^ salt) & _U32))
    shed = torch.where(keep, shed, torch.full_like(shed, INT32_MAX))
    keep &= shed <= torch.sort(shed).values[c - 1]
    fkey = torch.where(keep, skey, torch.full_like(skey, INVALID_KEY))
    forder = torch.argsort(fkey, stable=True)[:c]
    fvalid = fkey[forder] != INVALID_KEY
    fpts = torch.where(fvalid[:, None], spts[forder], torch.zeros_like(spts[forder]))
    return VoxelMap(fpts, fkey[forder], fvalid)


def map_query(vmap: VoxelMap, center, radius: float, capacity: int):
    """The rows of every voxel whose first row lies within `radius` of the
    centre (all rows when none does), compacted in ascending (hash(id) & -2)
    order into `capacity` rows."""
    first = run_first(vmap.key)
    near = ((vmap.points - center) ** 2).sum(-1) <= radius * radius
    sel = vmap.valid & near[first]
    if not bool(sel.any()):
        sel = vmap.valid
    rank = torch.where(sel, hash32(vmap.key) & -2, torch.full_like(vmap.key, INT32_MAX))
    order = torch.argsort(rank, stable=True)[:capacity]
    ok = (rank[order] & 1) == 0
    return torch.where(ok[:, None], vmap.points[order], torch.zeros_like(vmap.points[order])), ok


# -------------------------------------------------------------- stage 1

def block_size(nt: int, k: int) -> int:
    b = 8
    while b < 128 and (b * 2) * k * 4 <= max(nt, 1):
        b *= 2
    return b


def candidates(ops: Ops, src_world, src_valid, target, tgt_valid, k: int,
               chunk: int = 512):
    """The target's rows dealt to k groups, blocks of block_size(nt, k)
    consecutive rows round-robin (row (o*k + c)*blk + j to group c); per
    source point and group the nearest valid target (equal minima
    averaged) -> (cand [B,k,3], valid [B,k])."""
    nt = target.shape[0]
    blk = block_size(nt, k)
    pad = (-nt) % (k * blk)
    if pad:
        target = torch.cat([target, target.new_zeros((pad, 3))])
        tgt_valid = torch.cat([tgt_valid, tgt_valid.new_zeros(pad)])
    g = target.shape[0] // k
    # slot-major layout: group c holds rows rows[c]
    rows = torch.arange(target.shape[0], device=target.device).reshape(g // blk, k, blk)
    rows = rows.transpose(0, 1).reshape(k, g)
    tg, tv = target[rows], tgt_valid[rows]                       # [k,g,3], [k,g]
    t2 = (tg * tg).sum(-1)
    outs, oks = [], []
    for b0 in range(0, src_world.shape[0], chunk):
        s = src_world[b0:b0 + chunk]
        d2 = (s * s).sum(-1)[:, None, None] - 2.0 * ops.ein("bd,kgd->bkg", s, tg) + t2[None]
        d2 = d2.masked_fill(~tv[None], math.inf)
        best = d2.amin(-1)
        hit = ((d2 == best[..., None]) & torch.isfinite(d2)).to(s.dtype)
        cnt = hit.sum(-1)
        cand = torch.einsum("bkg,kgd->bkd", hit, tg) / cnt.clamp_min(1.0)[..., None]
        outs.append(cand)
        oks.append(torch.isfinite(best) & src_valid[b0:b0 + chunk, None])
    return torch.cat(outs), torch.cat(oks)


# -------------------------------------------------------------- registration

def _moments(ops: Ops, r_tot, t_tot, src, src_valid, cand, cand_valid, max_dist):
    """Every particle's point-to-point Gauss-Newton system (H [P,6,6],
    b [P,6]) in the local [t, w] parameters: the nearest candidate of each
    transformed point (equal minima averaged), the gate |Ts - q|^2 <
    max_dist (the upstream squared-against-unsquared test), the weight
    (max_dist / (max_dist + 3 |e|))^2, and a gated-out real point kept with
    weight 1 and zero residual and lever arm (SVNICP.cpp:116-160)."""
    ts = ops.ein("pij,bj->pbi", r_tot, src) + t_tot[:, None, :]          # [P,B,3]
    c2 = (cand * cand).sum(-1)                                           # [B,K]
    d2 = ((ts * ts).sum(-1)[..., None] - 2.0 * ops.ein("pbd,bkd->pbk", ts, cand)
          + c2[None])
    d2 = d2.masked_fill(~cand_valid[None], math.inf)
    best = d2.amin(-1)
    hit = ((d2 == best[..., None]) & torch.isfinite(d2)).to(src.dtype)
    q = torch.einsum("pbk,bkd->pbd", hit, cand) / hit.sum(-1).clamp_min(1.0)[..., None]
    gate = ((best.clamp_min(0.0) < max_dist) & torch.isfinite(best)).to(src.dtype)
    e = (ts - q) * gate[..., None]
    w = (max_dist / (max_dist + 3.0 * torch.linalg.vector_norm(e, dim=-1))) ** 2
    w = w * src_valid.to(src.dtype)[None]
    sg = src[None] * gate[..., None]                                     # [P,B,3]
    sw = w.sum(1)
    m1 = ops.ein("pb,pbi->pi", w, sg)
    m2 = ops.ein("pb,pbi,pbj->pij", w, sg, sg)
    eye = torch.eye(3, dtype=src.dtype, device=src.device)
    h_rr = (m2[:, 0, 0] + m2[:, 1, 1] + m2[:, 2, 2])[:, None, None] * eye - m2
    h = torch.cat([torch.cat([sw[:, None, None] * eye, -skew(m1)], 2),
                   torch.cat([skew(m1), h_rr], 2)], 1)
    h = h + _JITTER * torch.eye(6, dtype=src.dtype, device=src.device)
    rte = ops.ein("pji,pbj->pbi", r_tot, w[..., None] * e)              # R^T (w e)
    b = torch.cat([rte.sum(1), torch.linalg.cross(sg, rte, dim=-1).sum(1)], -1)
    return h, b


def _stein_step(ops: Ops, h, b, r, t, max_dist):
    """One SVN update (SVNICP.cpp:164-279): Newton directions, the RBF
    kernel with the lower-median bandwidth / log(P+1), the Hessian-
    preconditioned transport (K (-H^-1 b) + H_mean^-1 grad_k) / sum_j K,
    a norm clip at max_dist, R <- R exp(w), t <- R_new J_l(w) dt + t."""
    p = r.shape[0]
    x = torch.cat([t, so3_log(r)], -1)
    newton = torch.linalg.solve(h, b[..., None])[..., 0]
    if p == 1:
        step = -newton
    else:
        xc = x - x.mean(0, keepdim=True)
        diff = xc[:, None, :] - xc[None, :, :]
        sq = (diff * diff).sum(-1)
        bw = torch.clamp_min(torch.sort(sq.reshape(-1)).values[(p * p - 1) // 2]
                             / math.log(p + 1), 1e-12)
        kern = torch.exp(-sq / bw)
        grad_k = (2.0 / bw) * (xc * kern.sum(1, keepdim=True) - ops.mm(kern, xc))
        repulsion = torch.linalg.solve(h.mean(0), grad_k.T).T
        step = (ops.mm(kern, -newton) + repulsion) / kern.sum(1, keepdim=True)
    norm = torch.linalg.vector_norm(step, dim=-1, keepdim=True)
    step = step * torch.clamp_max(max_dist / norm.clamp_min(1e-30), 1.0)
    r_new = r @ so3_exp(step[:, 3:])
    dt = (left_jacobian(step[:, 3:]) @ step[:, :3, None])[..., 0]
    t_new = (r_new @ dt[..., None])[..., 0] + t
    return r_new, t_new, torch.linalg.vector_norm(step, dim=1).mean()


@dataclasses.dataclass
class Registration:
    mean: np.ndarray          # [6] local correction [t, w]
    var: np.ndarray           # [6]
    iterations: int
    grad_norm: float
    stats: list               # the stop statistic after each iteration run
    followed: "Registration | None" = None   # the state after `follow` iterations


def _summary(r, t, its: int, grad: float, stats: list) -> Registration:
    x = torch.cat([t, so3_log(r)], -1)
    mean = x.mean(0)
    var = ((x - mean) ** 2).mean(0)
    return Registration(mean.cpu().numpy().astype(np.float64),
                        var.cpu().numpy().astype(np.float64), its, grad, stats[:its])


def register(ops: Ops, icp: dict, source, target, guess_r, guess_t, init,
             follow: int | None = None) -> Registration:
    """Stage-1 candidates at the guess, then the SVN loop from the particle
    draws `init` [P,6] ([t, w] around the guess), stopped as the
    configuration says: at the first iteration whose statistic falls under
    `convergence_threshold` (with `early_stop`), else at the cap of
    `iterations`. With `follow` the loop also runs on to that many
    iterations where it stopped sooner, and `followed` holds the state
    after exactly `follow` of them (the judge's reading of another run's
    count), `stats` the statistic of every iteration run."""
    (src, src_valid), (tgt, tgt_valid) = source, target
    at_guess = ops.mm(src, guess_r.T) + guess_t
    cand, cand_valid = candidates(ops, at_guess, src_valid, tgt, tgt_valid,
                                  int(icp["knn_count"]))
    init = ops.t(init)
    r, t = so3_exp(init[:, 3:]), init[:, :3].clone()
    md = float(icp["max_dist"])
    cap, thr = int(icp["iterations"]), float(icp["convergence_threshold"])
    early = bool(icp.get("early_stop", True))
    stats: list = []
    grad = math.inf
    own = followed = None
    if follow is not None and follow == 0:
        followed = _summary(r, t, 0, grad, stats)
    if int((cand_valid.any(1) & src_valid).sum()) >= MIN_CONSTRAINT_POINTS:
        for i in range(1, max(cap, follow or 0) + 1):
            r_tot = guess_r[None] @ r
            t_tot = guess_t[None] + t @ guess_r.T
            h, b = _moments(ops, r_tot, t_tot, src, src_valid, cand, cand_valid, md)
            r, t, g = _stein_step(ops, h, b, r, t, md)
            grad = float(g)
            stats.append(grad)
            if own is None and (i == cap or (early and grad < thr)):
                own = _summary(r, t, i, grad, stats)
            if i == follow:
                followed = _summary(r, t, i, grad, stats)
            if own is not None and (follow is None or followed is not None):
                break
    if own is None:
        own = _summary(r, t, 0, grad, stats)
    if follow is not None and followed is None:
        followed = _summary(r, t, len(stats), grad, stats)
    own.stats = stats
    own.followed = followed
    return own


# -------------------------------------------------------------------- filter

@dataclasses.dataclass
class Filter:
    r: torch.Tensor
    t: torch.Tensor
    v: torch.Tensor
    bg: torch.Tensor
    ba: torch.Tensor
    cov: torch.Tensor


def filter_create(ops: Ops, cfg: dict) -> Filter:
    lio, imu = cfg["lio"], cfg["imu"]
    d2r = math.pi / 180.0
    diag = np.concatenate([np.square(lio.get("init_pos_std", [0.05] * 3)),
                           np.square(lio.get("init_vel_std", [0.05] * 3)),
                           np.square(np.multiply(lio.get("init_rot_std", [0.1] * 3), d2r)),
                           np.square(imu["bg_std"]), np.square(imu["ba_std"])])
    z = torch.zeros(3, dtype=ops.dtype, device=ops.device)
    return Filter(torch.eye(3, dtype=ops.dtype, device=ops.device), z, z.clone(),
                  z.clone(), z.clone(), torch.diag(ops.t(diag)))


GRAVITY = 9.782940329221166


def filter_predict(ops: Ops, f: Filter, prev, cur, noise: dict) -> Filter:
    """One IMU interval (IMU.cpp:20-58, ESEKF.cpp:34-69): `cur` (dt, acc,
    gyro) bias-compensated, the strapdown step from `prev` with the
    upstream's rotated gravity in the velocity and the Euler ZYX attitude
    increment, and the covariance through the upstream's transition."""
    dt = float(cur[0])
    acc = ops.t(cur[1]) - f.ba
    p_acc, p_gyro, p_dt = ops.t(prev[1]), ops.t(prev[2]), float(prev[0])
    g = ops.t([0.0, 0.0, -GRAVITY])
    d_vfn = ops.mm(f.r, (p_acc * p_dt)[:, None])[:, 0]
    vel = f.v + d_vfn + ops.mm(f.r, g[:, None])[:, 0] * dt
    t_new = f.t + f.v * dt + 0.5 * g * dt * dt + 0.5 * d_vfn * dt
    r_new = ops.mm(f.r, euler_zyx(p_gyro * dt))
    ra = ops.mm(f.r, acc[:, None])[:, 0]
    eye = torch.eye(3, dtype=ops.dtype, device=ops.device)
    phi = torch.eye(15, dtype=ops.dtype, device=ops.device)
    phi[0:3, 3:6] = eye * dt
    phi[3:6, 6:9] = so3_exp(ra) * dt
    phi[3:6, 12:15] = f.r * dt
    phi[6:9, 9:12] = -f.r * dt
    q = torch.zeros((15, 15), dtype=ops.dtype, device=ops.device)
    q[3:6, 3:6] = ops.mm(ops.mm(f.r, torch.diag(ops.t(noise["vel_rw"]) ** 2)), f.r.T) * dt
    q[6:9, 6:9] = ops.mm(ops.mm(f.r, torch.diag(ops.t(noise["rot_rw"]) ** 2)), f.r.T) * dt
    q[9:12, 9:12] = 2.0 * torch.diag(ops.t(noise["bg_std"]) ** 2) * dt
    q[12:15, 12:15] = 2.0 * torch.diag(ops.t(noise["ba_std"]) ** 2) * dt
    cov = ops.mm(ops.mm(phi, f.cov), phi.T) + q
    return Filter(r_new, t_new, vel, f.bg, f.ba, cov)


def filter_update(ops: Ops, f: Filter, meas, meas_var) -> Filter:
    """The pose observation (ESEKF.cpp:71-99): H picks dp and dtheta, the
    gain with S's inverse, the pose injected as T exp(error), the velocity
    as R_new dv."""
    h = torch.zeros((6, 15), dtype=ops.dtype, device=ops.device)
    h[0:3, 0:3] = torch.eye(3, dtype=ops.dtype, device=ops.device)
    h[3:6, 6:9] = h[0:3, 0:3]
    s = ops.mm(ops.mm(h, f.cov), h.T) + torch.diag(ops.t(meas_var))
    gain = ops.mm(ops.mm(f.cov, h.T), torch.linalg.inv(s))
    delta = ops.mm(gain, ops.t(meas)[:, None])[:, 0]
    cov = f.cov - ops.mm(ops.mm(gain, h), f.cov)
    r_new = ops.mm(f.r, so3_exp(delta[6:9]))
    t_new = ops.mm(f.r, delta[0:3, None])[:, 0] + f.t
    v_new = f.v + ops.mm(r_new, delta[3:6, None])[:, 0]
    return Filter(r_new, t_new, v_new, f.bg + delta[9:12], f.ba + delta[12:15], cov)


def imu_pairs(window: list):
    """A frame's samples (dt, acc, gyro) -> the (prev, cur) intervals the
    filter steps over: the first sample stands for its own predecessor."""
    out, prev = [], None
    for s in window:
        out.append((s if prev is None else prev, s))
        prev = s
    return out


def constant_velocity_guess(pose_r, pose_t, prev_r, prev_t, t_now, t_pose, t_prev,
                            frame_idx: int):
    """The ICP estimator's prediction (OdometryPipeline.cpp:706-737): the
    last relative motion, scaled by the ratio of the time steps, applied to
    the last pose; none before frame 2."""
    if frame_idx < 2:
        return pose_r, pose_t
    xi = se3_log(*compose(prev_r.T, -prev_r.T @ prev_t, pose_r, pose_t))
    dt_hist = t_pose - t_prev
    ratio = (t_now - t_pose) / max(dt_hist, 1e-9) if dt_hist > 0 else 0.0
    ri, ti = se3_exp(ratio * xi)
    return compose(pose_r, pose_t, ri, ti)
