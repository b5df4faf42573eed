"""Stein Variational Newton ICP: the registration engine.

Port of `svnicp_tpu/core/svn.py` for both residuals and the
Hessian-preconditioned coupling (svn_full_grad off): point-to-plane as in
`configs/tpu_plane.yaml`, point-to-point as in `configs/geode_alpha.yaml`
and `configs/subt_mrs.yaml`. One iteration is two calls: the moments
wrapper of the residual (kernel B2 plane, B4 point, on the card) for every
particle's Gauss-Newton system, then the ensemble-update wrapper (kernel
B3) for the Newton solve, Stein coupling and pose update. For CPU tensors
the wrappers run their plain versions, in float32 or float64. Both
residuals take the candidate sets padded to a multiple of 8 slots, as the
JAX package's kernel path does.

Early stop: JAX stops inside a device `while_loop`. Here the host reads the
stop statistic after every iteration (one device sync per iteration) and
stops when it drops below the threshold, which
gives the same `AlignResult.iterations`: the loop runs while not done and
fewer than `cfg.iterations` have run, and a degenerate correspondence set
(fewer than 6 source points with any candidate) skips the loop with
grad_norm = +inf, which the pipeline reads as a failed alignment.

Reference quirks kept (see the JAX module): the correspondence gate compares
the SQUARED distance against the unsquared max_dist, point-to-point pairs
outside the gate add the identity damping of weight 1 to H, and particle
weights stay uniform.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svnicp_tpu_torch.config import SteinICPConfig
from svnicp_tpu_torch.core import geometry as geo
from svnicp_tpu_torch.core import residuals
from svnicp_tpu_torch.kernels import nn, stein

MIN_CONSTRAINT_POINTS = 6   # a 6-DoF system needs >= 6 constrained points


class AlignResult(NamedTuple):
    """Outputs of one alignment (ref getters: SVNICP.cpp:281-308)."""

    particles: torch.Tensor   # [P,6] local correction per particle: [t, log R]
    weights: torch.Tensor     # [P] uniform
    mean: torch.Tensor        # [6]
    var: torch.Tensor         # [6]
    cov: torch.Tensor         # [6,6]
    iterations: int           # iterations actually run
    grad_norm: torch.Tensor   # scalar: mean |stein step| at exit


def check_supported(cfg: SteinICPConfig) -> None:
    """The options this port implements so far; others raise."""
    unsupported = {
        f"method={cfg.method}": cfg.method not in ("svn", "svgd"),
        "candidate_method": cfg.candidate_method != "bucketed",
        "match_count": cfg.match_count != 0,
        "svn_full_grad": cfg.svn_full_grad,
        "adaptive_prior": cfg.adaptive_prior,
        # the XLA paths these select take the first index at ties; the
        # port's kernels and their plain versions average tied minima
        "use_pallas=false": not cfg.use_pallas,
        "stein_kernel=false": cfg.method == "svn" and not cfg.stein_kernel,
        # JAX draws an SVGD minibatch with its PRNG, off the kernel route
        "use_minibatch": cfg.method == "svgd" and cfg.use_minibatch,
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise NotImplementedError(
            f"svnicp_tpu_torch does not port {bad} yet (it runs method=svn or "
            "svgd, candidate_method=bucketed, use_pallas=true)")


def prior_inverse_variance(cfg: SteinICPConfig, dtype, device) -> torch.Tensor:
    """[6] precision of the particle-box prior N(0, (ub-lb)^2/12)."""
    lb = torch.tensor(cfg.init_lb, dtype=dtype, device=device)
    ub = torch.tensor(cfg.init_ub, dtype=dtype, device=device)
    return 1.0 / torch.clamp_min((ub - lb) ** 2 / 12.0, 1e-12)


def particle_coords(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[P,6] = [t, log R], the coordinates the Stein kernel acts on."""
    return torch.cat([t, geo.so3_log(r)], dim=-1)


def ensemble_result(r, t, iterations: int, grad_norm) -> AlignResult:
    """Uniform-weight mean, variance and covariance of the final particles."""
    particles = particle_coords(r, t)
    p = particles.shape[0]
    weights = torch.full((p,), 1.0 / p, dtype=particles.dtype,
                         device=particles.device)
    mean = (particles * weights[:, None]).sum(0)
    centered = particles - mean[None, :]
    var = (weights[:, None] * centered * centered).sum(0)
    cov = torch.einsum("p,pi,pj->ij", weights, centered, centered)
    return AlignResult(particles, weights, mean, var, cov, iterations,
                       torch.as_tensor(grad_norm, dtype=particles.dtype,
                                       device=particles.device))


def correspondence_features(source, cand_pts, cand_valid):
    """feat [B*K,12] = [vec(c s^T), c] and bias [B,K] = |c|^2 (+inf invalid):
    score[p,b,k] = bias - 2 <[vec(R), t], feat> = |c|^2 - 2 <R s + t, c>."""
    bsz, k = cand_pts.shape[:2]
    outer = torch.einsum("bki,bj->bkij", cand_pts, source).reshape(bsz, k, 9)
    feat = torch.cat([outer, cand_pts], dim=-1)
    bias = (cand_pts * cand_pts).sum(-1)
    bias = torch.where(cand_valid, bias, torch.full_like(bias, float("inf")))
    return feat.reshape(bsz * k, 12), bias


def valid_pair_count(src_valid, cand_valid) -> torch.Tensor:
    """Source points with at least one candidate (the degeneracy statistic)."""
    return (cand_valid.any(1) & src_valid).sum()


def _prepare_align(cfg: SteinICPConfig, source, src_valid, cand_pts,
                   cand_valid) -> nn.PlanePrep | nn.PointPrep:
    """Per-frame, loop-invariant setup: plane normals from the full
    candidate sets (point-to-plane), K padded to a multiple of 8 with
    invalid slots, correspondence features, the kernel's operand layout."""
    plane = cfg.residual == "point_to_plane"
    if plane:
        n_vec, n_valid = residuals.plane_normals(cand_pts, cand_valid)
    cand_pts, cand_valid = nn.pad_candidates(cand_pts, cand_valid, multiple=8)
    feat, bias = correspondence_features(source, cand_pts, cand_valid)
    if plane:
        return nn.prepare_moments_plane(feat, bias, cand_pts, source, n_vec,
                                        n_valid & src_valid)
    return nn.prepare_moments_point(feat, bias, cand_pts, source, src_valid)


def _svn_iteration(cfg: SteinICPConfig, prep, prior, r0, t0, r, t):
    """One SVN epoch -> (r, t, grad_norm, stop statistic)."""
    p = r.shape[0]
    r_total = r0[None] @ r
    t_total = t0[None] + t @ r0.T
    params = torch.cat([r_total.reshape(p, 9), t_total], dim=-1).contiguous()
    hess, b = nn.moments(params, prep, cfg.max_dist)
    if p > 1:
        r_new, t_new, grad_norm, mean_delta = stein.stein_update(
            hess, b, r, t, prior, max_dist=cfg.max_dist)
    else:
        if prior is not None:
            hess = hess + torch.diag_embed(prior[0])
            b = b + particle_coords(r, t) * prior[0]
        step = stein.clip_step(-residuals.cholesky_solve6(hess, b), cfg.max_dist)
        r_new, t_new = stein.pose_update(r, t, step)
        grad_norm = torch.linalg.vector_norm(step, dim=1).mean()
        mean_delta = torch.linalg.vector_norm(step.mean(0))
    stop = mean_delta if cfg.convergence_metric == "mean_delta" else grad_norm
    return r_new, t_new, grad_norm, stop


def align(cfg: SteinICPConfig, source, src_valid, cand_pts, cand_valid, r0, t0,
          init_particles) -> AlignResult:
    """Run the SVN ensemble to convergence from `init_particles` [P,6]
    ([t, w] local corrections around the guess (r0, t0)) and return the
    local correction distribution (ref: SVNICP.cpp:41-114)."""
    check_supported(cfg)
    r = geo.so3_exp(init_particles[:, 3:])
    t = init_particles[:, :3].contiguous()
    if int(valid_pair_count(src_valid, cand_valid)) < MIN_CONSTRAINT_POINTS:
        return ensemble_result(r, t, 0, float("inf"))
    prep = _prepare_align(cfg, source, src_valid, cand_pts, cand_valid)
    prior = None
    if cfg.prior_information:
        inv = prior_inverse_variance(cfg, source.dtype, source.device)
        prior = torch.stack([inv, torch.sqrt(1.0 / inv)])
    it = 0
    grad_norm = torch.tensor(float("inf"), dtype=source.dtype,
                             device=source.device)
    while it < cfg.iterations:
        r, t, grad_norm, stop = _svn_iteration(cfg, prep, prior, r0, t0, r, t)
        it += 1
        if cfg.early_stop and float(stop) < cfg.convergence_threshold:
            break
    return ensemble_result(r, t, it, grad_norm)


def register(cfg: SteinICPConfig, source, src_valid, target, tgt_valid, r0, t0,
             init_particles) -> AlignResult:
    """Stage-1 candidates at the initial guess (kernel B1 on the card), then
    the SVN alignment (ref: SVGDICP.cpp:46-62, 176-215; SVNICP.cpp:41-114)."""
    at_guess = geo.transform_points(r0, t0, source)
    cand_pts, d2 = nn.bucketed_candidates(at_guess, target, src_valid,
                                          tgt_valid, cfg.knn_count)
    return align(cfg, source, src_valid, cand_pts, torch.isfinite(d2), r0, t0,
                 init_particles)
