"""The stage-1 candidate kernel (B1), the plane-moments kernel (B2), the
point-moments kernel (B4) and the 1-NN match kernel (B5).

Each function has a CUDA kernel (`csrc/stage1.cu`, `csrc/plane_moments.cu`,
`csrc/point_moments.cu`, `csrc/nn_match.cu`) and a plain PyTorch version of
the same math beside it. The wrapper runs the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises
(float32, contiguous, one device), and counts its launches in
`<wrapper>.launches`. `moments` picks B2 or B4 from the type of the prep it
is given; B5 (the SVGD loop's match) reads B4's prep.

The kernels average the coordinates (B1, B4, B5) or n.q values (B2) of tied
minima, as the Pallas kernels they replace do
(`svnicp_tpu/kernels/nn_pallas.py`: `bucketed_candidates`,
`fused_moments_plane_kb`, `fused_moments_kb`, `fused_nn_match`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svnicp_tpu_torch.core import geometry as geo
from svnicp_tpu_torch.kernels import _build
from svnicp_tpu_torch.kernels.knn import bucket_block_size, group_scores

_JITTER = 1e-6
_N_MOMENTS = 27
_N_POINT_SUMS = 16   # B4's per-tile sums: the distinct entries of H and b
_POINT_TILE = 16     # B4's source points per block (kTile in point_match.cuh)


# --------------------------------------------------------------- B1 stage-1

def bucketed_candidates_plain(source, target, source_valid, target_valid,
                              k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """For each source point and each of the k blocked-cyclic groups, the
    nearest valid target (tied minima averaged) -> (cand_pts [B,k,3],
    cand_d2 [B,k], +inf where the group is empty or the source invalid)."""
    score, rows = group_scores(source, target, target_valid, k)
    best = score.amin(-1)
    hit = ((score == best[..., None]) & (score < 1e30)).to(source.dtype)
    cnt = hit.sum(-1)
    padded = torch.cat([target, target.new_zeros((rows.numel() - target.shape[0], 3))])
    picked = torch.einsum("bkg,kgd->bkd", hit, padded[rows])
    cand = picked / cnt.clamp_min(1.0)[..., None]
    s2 = (source * source).sum(-1, keepdim=True)
    d2 = (best + s2).clamp_min(0.0)
    inf = torch.full_like(d2, float("inf"))
    d2 = torch.where(best < 1e30, d2, inf)
    d2 = torch.where(source_valid[:, None], d2, inf)
    return cand, d2


def bucketed_candidates(source, target, source_valid, target_valid, k: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Stage-1 candidates as points: (cand_pts [B,k,3], cand_d2 [B,k])."""
    if source.device.type == "cpu":
        return bucketed_candidates_plain(source, target, source_valid,
                                         target_valid, k)
    _build.require_cuda_f32("bucketed_candidates", source, target,
                            source_valid, target_valid)
    b, nt = source.shape[0], target.shape[0]
    if source.shape != (b, 3) or target.shape != (nt, 3):
        raise ValueError("bucketed_candidates: source [B,3] and target [Nt,3]")
    if source_valid.shape != (b,) or target_valid.shape != (nt,):
        raise ValueError("bucketed_candidates: masks must be [B] and [Nt]")
    blk = bucket_block_size(nt, k)
    group = (nt + (-nt) % (k * blk)) // k
    dev = source.device
    cand = torch.empty((b, k, 3), dtype=torch.float32, device=dev)
    d2 = torch.empty((b, k), dtype=torch.float32, device=dev)
    prep = torch.empty((k * group, 4), dtype=torch.float32, device=dev)
    err = _build.library("stage1.cu").svn_stage1_candidates(
        _build.ptr(source), _build.ptr(source_valid), _build.ptr(target),
        _build.ptr(target_valid), b, nt, k, blk, group, _build.ptr(prep), _build.ptr(cand),
        _build.ptr(d2), _build.stream_of(source))
    _build.check(err, "stage1 kernel")
    _build.count_launch(bucketed_candidates)
    return cand, d2


bucketed_candidates.launches = 0



# ----------------------------------------------------- B2 plane moments

class PlanePrep(NamedTuple):
    """Loop-invariant operands of the plane-moments kernel, B innermost so
    neighbouring threads read neighbouring addresses."""

    feat13: torch.Tensor   # [13,K,B]: -2 [vec(c s^T), c] and |c|^2 (+inf invalid)
    ndotc: torch.Tensor    # [K,B] n_b . c_bk
    src_t: torch.Tensor    # [3,B]
    nrm_t: torch.Tensor    # [3,B]
    vmask: torch.Tensor    # [B] 1.0 where the point and its plane fit count

    @property
    def averaged(self) -> torch.Tensor:
        """The operand whose values the tied minima average (K on axis -2)."""
        return self.ndotc


def prepare_moments_plane(feat, bias, cand_pts, source, normals, valid
                          ) -> PlanePrep:
    """Per-frame layout for `plane_moments` (the JAX package's
    `prepare_moments_plane_kb`)."""
    b, k = bias.shape
    feat13 = torch.cat([-2.0 * feat.reshape(b, k, 12), bias[..., None]], dim=-1)
    return PlanePrep(
        feat13=feat13.permute(2, 1, 0).contiguous(),
        ndotc=torch.einsum("bkd,bd->kb", cand_pts, normals).contiguous(),
        src_t=source.T.contiguous(),
        nrm_t=normals.T.contiguous(),
        vmask=valid.to(source.dtype).contiguous(),
    )


def assemble_plane_system(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[P,27] moments (21 upper-triangle H entries row-major, 6 b entries)
    -> (H [P,6,6] symmetric + 1e-6 I, b [P,6])."""
    p = m.shape[0]
    iu, ju = torch.triu_indices(6, 6, device=m.device)
    h = m.new_zeros((p, 6, 6))
    h[:, iu, ju] = m[:, :21]
    h[:, ju, iu] = m[:, :21]
    h = h + _JITTER * torch.eye(6, dtype=m.dtype, device=m.device)
    return h, m[:, 21:27].contiguous()


def plane_moments_plain(params: torch.Tensor, prep: PlanePrep,
                        max_dist: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-particle point-to-plane Gauss-Newton system from the candidate
    sets: params [P,12] = [vec(R_total), t_total] -> (H [P,6,6], b [P,6])."""
    p = params.shape[0]
    params13 = torch.cat([params, params.new_ones((p, 1))], dim=-1)
    score = torch.einsum("pc,ckb->pkb", params13, prep.feat13)
    best = score.amin(1)
    hit = (score == best[:, None, :]).to(params.dtype)
    nq = (hit * prep.ndotc[None]).sum(1) / hit.sum(1).clamp_min(1.0)

    s = [prep.src_t[i][None, :] for i in range(3)]
    n = [prep.nrm_t[i][None, :] for i in range(3)]
    pc = [params[:, i][:, None] for i in range(12)]
    t2 = 0.0
    for i in range(3):
        ti = pc[3 * i] * s[0] + pc[3 * i + 1] * s[1] + pc[3 * i + 2] * s[2] + pc[9 + i]
        t2 = t2 + ti * ti
    d2 = (best + t2).clamp_min(0.0)
    gate = ((d2 < max_dist) & (best < 1e30)).to(params.dtype)
    u = [pc[j] * n[0] + pc[3 + j] * n[1] + pc[6 + j] * n[2] for j in range(3)]
    nts = u[0] * s[0] + u[1] * s[1] + u[2] * s[2]
    ntt = pc[9] * n[0] + pc[10] * n[1] + pc[11] * n[2]
    r = nts + ntt - nq
    w = torch.square(max_dist / (max_dist + 3.0 * torch.abs(r)))
    w = w * gate * prep.vmask[None, :]
    wr = w * r
    g = [u[0], u[1], u[2], s[1] * u[2] - s[2] * u[1],
         s[2] * u[0] - s[0] * u[2], s[0] * u[1] - s[1] * u[0]]
    comps = [(w * g[i] * g[j]).sum(1) for i in range(6) for j in range(i, 6)]
    comps += [(wr * g[i]).sum(1) for i in range(6)]
    return assemble_plane_system(torch.stack(comps, dim=1))


def plane_moments(params: torch.Tensor, prep: PlanePrep, max_dist: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """H [P,6,6], b [P,6] of the point-to-plane residual (kernel B2 on the
    card, the plain version on the CPU)."""
    if params.device.type == "cpu":
        return plane_moments_plain(params, prep, max_dist)
    _build.require_cuda_f32("plane_moments", params, *prep)
    p = params.shape[0]
    _, k, b = prep.feat13.shape
    if (params.shape != (p, 12) or prep.feat13.shape[0] != 13
            or prep.ndotc.shape != (k, b) or prep.src_t.shape != (3, b)
            or prep.nrm_t.shape != (3, b) or prep.vmask.shape != (b,)):
        raise ValueError("plane_moments: shapes do not match [P,12], [13,K,B], "
                         "[K,B], [3,B], [3,B], [B]")
    # the kernel writes the system itself (no assemble_plane_system here)
    partial = torch.empty((-(-b // 32), _N_MOMENTS, p), dtype=torch.float32,
                          device=params.device)
    h = torch.empty((p, 6, 6), dtype=torch.float32, device=params.device)
    bvec = torch.empty((p, 6), dtype=torch.float32, device=params.device)
    err = _build.library("plane_moments.cu").svn_plane_moments(
        *(_build.ptr(t) for t in (params, *prep)), p, k, b, float(max_dist),
        _build.ptr(partial), _build.ptr(h), _build.ptr(bvec), _build.stream_of(params))
    _build.check(err, "plane_moments kernel")
    _build.count_launch(plane_moments)
    return h, bvec


plane_moments.launches = 0


# ----------------------------------------------------- B4 point moments

def pad_candidates(cand_pts, cand_valid, multiple: int = 8):
    """Pad the K axis to a multiple of `multiple` with invalid slots (zero
    points): the JAX package runs its K-on-sublane moments kernels at K
    rounded up to 8, so K=100 becomes 104."""
    b, k = cand_valid.shape
    pad = (-k) % multiple
    if pad == 0:
        return cand_pts, cand_valid
    return (torch.cat([cand_pts, cand_pts.new_zeros((b, pad, 3))], dim=1),
            torch.cat([cand_valid, cand_valid.new_zeros((b, pad))], dim=1))


class PointPrep(NamedTuple):
    """Loop-invariant operands of the point-moments kernel, B innermost."""

    feat13: torch.Tensor   # [13,K,B]: -2 [vec(c s^T), c] and |c|^2 (+inf invalid)
    cand_t: torch.Tensor   # [3,K,B] candidate coordinates
    src_t: torch.Tensor    # [3,B]
    vmask: torch.Tensor    # [B] 1.0 where the source point is real

    @property
    def averaged(self) -> torch.Tensor:
        """The operand whose values the tied minima average (K on axis -2)."""
        return self.cand_t


def prepare_moments_point(feat, bias, cand_pts, source, src_valid) -> PointPrep:
    """Per-frame layout for `point_moments` (the JAX package's
    `prepare_moments_kb`)."""
    b, k = bias.shape
    feat13 = torch.cat([-2.0 * feat.reshape(b, k, 12), bias[..., None]], dim=-1)
    return PointPrep(
        feat13=feat13.permute(2, 1, 0).contiguous(),
        cand_t=cand_pts.permute(2, 1, 0).contiguous(),
        src_t=source.T.contiguous(),
        vmask=src_valid.to(source.dtype).contiguous(),
    )


def assemble_point_system(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[P,19] moments (sw, m1 [3], m2 [3x3 row-major], b_t [3], b_r [3]) ->
    (H [P,6,6], b [P,6]) by the block-moment identity of the JAX package's
    core/residuals.py: H = [[sw I, -[m1]x], [[m1]x, tr(m2) I - m2]] + 1e-6 I."""
    p = m.shape[0]
    eye3 = torch.eye(3, dtype=m.dtype, device=m.device)
    m2 = m[:, 4:13].reshape(p, 3, 3)
    sk = geo.skew(m[:, 1:4])
    h_tt = m[:, 0, None, None] * eye3
    h_rr = torch.diagonal(m2, dim1=1, dim2=2).sum(-1)[:, None, None] * eye3 - m2
    h = torch.cat([torch.cat([h_tt, -sk], dim=2), torch.cat([sk, h_rr], dim=2)],
                  dim=1)
    h = h + _JITTER * torch.eye(6, dtype=m.dtype, device=m.device)
    return h, m[:, 13:19].contiguous()


def point_moments_plain(params: torch.Tensor, prep: PointPrep,
                        max_dist: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-particle point-to-point Gauss-Newton system from the candidate
    sets: params [P,12] = [vec(R_total), t_total] -> (H [P,6,6], b [P,6]).
    The matched point is the mean of the tied minima (`nn_match_plain`); a
    pair outside the gate (squared distance against the unsquared max_dist,
    or no valid candidate) keeps weight 1 with a zero residual and a zero
    source point, so it adds only to H's sw I block; padded points add
    nothing."""
    q, best = nn_match_plain(params, prep)
    matched = [q[..., c] for c in range(3)]

    s = [prep.src_t[i][None, :] for i in range(3)]
    pc = [params[:, i][:, None] for i in range(12)]
    tr = [pc[3 * i] * s[0] + pc[3 * i + 1] * s[1] + pc[3 * i + 2] * s[2] + pc[9 + i]
          for i in range(3)]
    d2 = (best + tr[0] * tr[0] + tr[1] * tr[1] + tr[2] * tr[2]).clamp_min(0.0)
    gate = ((d2 < max_dist) & (best < 1e30)).to(params.dtype)
    e = [(tr[i] - matched[i]) * gate for i in range(3)]
    en = torch.sqrt(e[0] * e[0] + e[1] * e[1] + e[2] * e[2])
    w = torch.square(max_dist / (max_dist + 3.0 * en)) * prep.vmask[None, :]
    we = [w * e[i] for i in range(3)]
    sg = [s[i] * gate for i in range(3)]
    rte = [pc[j] * we[0] + pc[3 + j] * we[1] + pc[6 + j] * we[2] for j in range(3)]
    comps = [w.sum(1)]
    comps += [(w * sg[i]).sum(1) for i in range(3)]
    comps += [(w * sg[i] * sg[j]).sum(1) for i in range(3) for j in range(3)]
    comps += [rte[j].sum(1) for j in range(3)]
    comps += [(sg[1] * rte[2] - sg[2] * rte[1]).sum(1),
              (sg[2] * rte[0] - sg[0] * rte[2]).sum(1),
              (sg[0] * rte[1] - sg[1] * rte[0]).sum(1)]
    return assemble_point_system(torch.stack(comps, dim=1))


def point_moments(params: torch.Tensor, prep: PointPrep, max_dist: float
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """H [P,6,6], b [P,6] of the point-to-point residual (kernel B4 on the
    card, the plain version on the CPU)."""
    if params.device.type == "cpu":
        return point_moments_plain(params, prep, max_dist)
    _build.require_cuda_f32("point_moments", params, *prep)
    p = params.shape[0]
    _, k, b = prep.feat13.shape
    if (params.shape != (p, 12) or prep.feat13.shape[0] != 13
            or prep.cand_t.shape != (3, k, b) or prep.src_t.shape != (3, b)
            or prep.vmask.shape != (b,)):
        raise ValueError("point_moments: shapes do not match [P,12], [13,K,B], "
                         "[3,K,B], [3,B], [B]")
    # the kernel writes the system itself (no assemble_point_system here)
    partial = torch.empty((-(-b // _POINT_TILE), _N_POINT_SUMS, p), dtype=torch.float32,
                          device=params.device)
    h = torch.empty((p, 6, 6), dtype=torch.float32, device=params.device)
    bvec = torch.empty((p, 6), dtype=torch.float32, device=params.device)
    err = _build.library("point_moments.cu").svn_point_moments(
        *(_build.ptr(t) for t in (params, *prep)), p, k, b, float(max_dist),
        _build.ptr(partial), _build.ptr(h), _build.ptr(bvec), _build.stream_of(params))
    _build.check(err, "point_moments kernel")
    _build.count_launch(point_moments)
    return h, bvec


point_moments.launches = 0


# ------------------------------------------------------------ B5 1-NN match

def nn_match_plain(params: torch.Tensor, prep: PointPrep
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per (particle, point) the candidate minimising
    score = params13 . feat13 = |c|^2 - 2 <T_p s_b, c>, tied minima averaged:
    params [P,12] = [vec(R_total), t_total] -> (matched [P,B,3], best [P,B]).
    The caller adds |T_p s_b|^2 to `best` for the squared distance. A point
    with no valid candidate has best = +inf and averages all its slots."""
    p = params.shape[0]
    params13 = torch.cat([params, params.new_ones((p, 1))], dim=-1)
    score = torch.einsum("pc,ckb->pkb", params13, prep.feat13)
    best = score.amin(1)
    hit = (score == best[:, None, :]).to(params.dtype)
    inv = 1.0 / hit.sum(1).clamp_min(1.0)
    matched = [(hit * prep.cand_t[c][None]).sum(1) * inv for c in range(3)]
    return torch.stack(matched, dim=-1), best


def nn_match(params: torch.Tensor, prep: PointPrep
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """matched [P,B,3], best score [P,B] of every particle's 1-NN among the
    candidate sets (kernel B5 on the card, the plain version on the CPU).
    On the card `matched` is a view of a [3,P,B] buffer."""
    if params.device.type == "cpu":
        return nn_match_plain(params, prep)
    _build.require_cuda_f32("nn_match", params, prep.feat13, prep.cand_t)
    p = params.shape[0]
    _, k, b = prep.feat13.shape
    if (params.shape != (p, 12) or prep.feat13.shape[0] != 13
            or prep.cand_t.shape != (3, k, b)):
        raise ValueError("nn_match: shapes do not match [P,12], [13,K,B], [3,K,B]")
    matched = torch.empty((3, p, b), dtype=torch.float32, device=params.device)
    best = torch.empty((p, b), dtype=torch.float32, device=params.device)
    err = _build.library("nn_match.cu").svn_nn_match(
        _build.ptr(params), _build.ptr(prep.feat13), _build.ptr(prep.cand_t),
        p, k, b, _build.ptr(matched), _build.ptr(best), _build.stream_of(params))
    _build.check(err, "nn_match kernel")
    _build.count_launch(nn_match)
    return matched.permute(1, 2, 0), best


nn_match.launches = 0


# ------------------------------------------------------------ either residual

# prep type -> (wrapper, plain version) of its moments function
MOMENTS = {PlanePrep: (plane_moments, plane_moments_plain),
           PointPrep: (point_moments, point_moments_plain)}


def moments(params: torch.Tensor, prep: PlanePrep | PointPrep, max_dist: float
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """H [P,6,6], b [P,6] of the residual `prep` was built for: B2 for a
    PlanePrep, B4 for a PointPrep."""
    return MOMENTS[type(prep)][0](params, prep, max_dist)
