"""Robust weights, candidate-set plane fits, the Gauss-Newton systems and
the unrolled 6x6 solve.

Port of `svnicp_tpu/core/residuals.py`. On the kernel route the moments
kernels (`kernels/nn.py`) assemble the systems; `ensemble_gauss_newton` and
`ensemble_gauss_newton_plane` are the JAX package's XLA route, batched over
the particles, from matched points picked by index.
"""

from __future__ import annotations

import math

import torch

from svnicp_tpu_torch.core import geometry as geo

_JITTER = 1e-6


def robust_weight(err_norm: torch.Tensor, max_dist: float) -> torch.Tensor:
    """Geman-McClure-style M-estimator weight (ref: SVNICP.cpp:122)."""
    return torch.square(max_dist / (max_dist + 3.0 * err_norm))


def ensemble_gauss_newton(source, transformed, target, pair_valid, point_valid,
                          r_total, max_dist: float):
    """Point-to-point (H [P,6,6], b [P,6]) for every particle, by the
    block-moment identity (parameters [translation, rotation]).
    source [B,3] and point_valid [B] are shared; transformed, target
    [P,B,3], pair_valid [P,B] and r_total [P,3,3] are per particle. Real
    points outside the gate add the reference's w=1, s=0 identity damping;
    padded points add nothing."""
    dt = source.dtype
    gate = pair_valid[..., None].to(dt)                       # [P,B,1]
    s = source * gate
    e = (transformed - target) * gate
    w = robust_weight(torch.linalg.vector_norm(e, dim=-1, keepdim=True), max_dist)
    w = w * point_valid[:, None].to(dt)
    we = w * e
    sw = w.sum((1, 2))
    m1 = (w * s).sum(1)                                       # [P,3]
    m2 = torch.einsum("pbi,pbj->pij", w * s, s)
    eye = torch.eye(3, dtype=dt, device=source.device)
    h_tt = sw[:, None, None] * eye
    h_tr = -geo.skew(m1)
    tr = m2[:, 0, 0] + m2[:, 1, 1] + m2[:, 2, 2]
    h_rr = tr[:, None, None] * eye - m2
    h = torch.cat([torch.cat([h_tt, h_tr], dim=2),
                   torch.cat([-h_tr, h_rr], dim=2)], dim=1)
    h = h + _JITTER * torch.eye(6, dtype=dt, device=source.device)
    rte = torch.einsum("pji,pbj->pbi", r_total, we)            # R^T (w e)
    b = torch.cat([rte.sum(1), torch.linalg.cross(s, rte, dim=-1).sum(1)], dim=-1)
    return h, b


def ensemble_gauss_newton_plane(source, transformed, target, normals,
                                pair_valid, r_total, max_dist: float):
    """Point-to-plane (H [P,6,6], b [P,6]) for every particle: residual
    r = n.(T s - q), direction g = [R^T n ; s x R^T n], H = sum w g g^T +
    jitter I, b = sum w r g. source and normals [B,3] are shared;
    pair_valid [P,B] folds in the gate, the plane fit and the point's
    validity (pairs outside simply drop out)."""
    dt = source.dtype
    gate = pair_valid.to(dt)
    r = (normals[None] * (transformed - target)).sum(-1)       # [P,B]
    w = robust_weight(r.abs(), max_dist) * gate
    rtn = torch.einsum("pji,bj->pbi", r_total, normals)        # R^T n
    g = torch.cat([rtn, torch.linalg.cross(source.expand_as(rtn), rtn, dim=-1)],
                  dim=-1)                                      # [P,B,6]
    h = torch.einsum("pb,pbi,pbj->pij", w, g, g)
    h = h + _JITTER * torch.eye(6, dtype=dt, device=source.device)
    b = torch.einsum("pb,pbi->pi", w * r, g)
    return h, b


def plane_normals(cand_pts: torch.Tensor, cand_valid: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-source-point surface normals from the stage-1 candidate sets.

    cand_pts [B,K,3], cand_valid [B,K] -> (unit normals [B,3], valid [B]).
    The closed-form path of the JAX package, step for step: a Gaussian soft
    refit around the candidates' mean, Smith's trigonometric eigenvalues of
    the 3x3 scatter, the smallest eigenvector as the best column of
    (C - lam_hi I)(C - lam_mid I), and the validity gates (>= 3 candidates,
    non-isotropic scatter, middle eigenvalue >= 5% of the largest).
    `torch.linalg.eigh` would pick other (equally valid) signs and
    near-degenerate vectors, so it is not used.
    """
    dt = cand_pts.dtype
    m = cand_valid.to(dt)
    n = m.sum(-1)
    n_safe = n.clamp_min(1.0)
    mean0 = (cand_pts * m[..., None]).sum(1) / n_safe[:, None]

    d0 = cand_pts - mean0[:, None, :]
    r2 = (d0 * d0).sum(-1)
    h = (r2 * m).sum(-1) / n_safe
    w = m * torch.exp(-r2 / h.clamp_min(1e-12)[:, None])
    sw = w.sum(-1).clamp_min(1e-6)
    mean = (cand_pts * w[..., None]).sum(1) / sw[:, None]
    d = (cand_pts - mean[:, None, :]) * torch.sqrt(w)[..., None]
    cov = torch.einsum("bki,bkj->bij", d, d) / sw[:, None, None]

    eye = torch.eye(3, dtype=dt, device=cand_pts.device)
    q = (cov[:, 0, 0] + cov[:, 1, 1] + cov[:, 2, 2]) / 3.0
    a_q = cov - q[:, None, None] * eye
    p2 = (a_q * a_q).sum((-2, -1)) / 6.0
    p = torch.sqrt(p2.clamp_min(0.0))
    bmat = a_q / p.clamp_min(1e-20)[:, None, None]
    detb = torch.linalg.det(bmat)
    phi = torch.arccos(torch.clamp(detb / 2.0, -1.0, 1.0)) / 3.0
    lam_hi = q + 2.0 * p * torch.cos(phi)
    lam_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam_mid = 3.0 * q - lam_hi - lam_lo

    mm = ((cov - lam_hi[:, None, None] * eye)
          @ (cov - lam_mid[:, None, None] * eye))
    col_norm2 = (mm * mm).sum(1)
    best = torch.argmax(col_norm2, dim=-1)
    vec = torch.take_along_dim(mm, best[:, None, None], dim=2)[..., 0]
    norm = torch.linalg.vector_norm(vec, dim=-1, keepdim=True)
    normals = vec / norm.clamp_min(1e-20)
    valid = ((n >= 3.0) & (p > 1e-12) & (norm[..., 0] > 1e-12)
             & (lam_mid > 0.05 * lam_hi))
    return normals, valid


def cholesky_solve6(h: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched SPD 6x6 solve, unrolled, with the JAX package's pivot floor
    max(s, 1e-12 (1 + |a_jj|)) that keeps rank-deficient input finite; on
    well-conditioned input the floor never engages. h [...,6,6] and b [...,6]
    broadcast against each other."""
    a = [[h[..., i, j] for j in range(6)] for i in range(6)]
    lo = [[None] * 6 for _ in range(6)]
    linv = [None] * 6
    for j in range(6):
        s = a[j][j]
        for k in range(j):
            s = s - lo[j][k] * lo[j][k]
        s = torch.maximum(s, 1e-12 * (1.0 + torch.abs(a[j][j])))
        lo[j][j] = torch.sqrt(s)
        linv[j] = 1.0 / lo[j][j]
        for i in range(j + 1, 6):
            s = a[i][j]
            for k in range(j):
                s = s - lo[i][k] * lo[j][k]
            lo[i][j] = s * linv[j]
    y = [None] * 6
    for i in range(6):
        s = b[..., i]
        for k in range(i):
            s = s - lo[i][k] * y[k]
        y[i] = s * linv[i]
    x = [None] * 6
    for i in reversed(range(6)):
        s = y[i]
        for k in range(i + 1, 6):
            s = s - lo[k][i] * x[k]
        x[i] = s * linv[i]
    return torch.stack(torch.broadcast_tensors(*x), dim=-1)


# The JAX package's single-particle names: its ensemble forms vmap these,
# where the port's ensemble forms are batched themselves.
def gauss_newton_system(source, transformed, target, pair_valid, point_valid,
                        r_total, max_dist: float):
    """One particle's point-to-point (H [6,6], b [6]): transformed and
    target [B,3], pair_valid [B], r_total [3,3]."""
    h, b = ensemble_gauss_newton(source, transformed[None], target[None],
                                 pair_valid[None], point_valid, r_total[None], max_dist)
    return h[0], b[0]


def gauss_newton_system_plane(source, transformed, target, normals, pair_valid,
                              r_total, max_dist: float):
    """One particle's point-to-plane (H [6,6], b [6]): transformed and
    target [B,3], pair_valid [B], r_total [3,3]."""
    h, b = ensemble_gauss_newton_plane(source, transformed[None], target[None], normals,
                                       pair_valid[None], r_total[None], max_dist)
    return h[0], b[0]


def solve_newton(h: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The Newton direction H^-1 b of one system (or a batch) by the
    unrolled Cholesky solve."""
    return cholesky_solve6(h, b)


ensemble_solve = cholesky_solve6   # the solve is batched over leading axes
