"""SVGD-ICP: the first-order Stein variational ICP variant.

Port of `svnicp_tpu/core/svgd.py` on its kernel route (use_pallas, full
batch): Euler-angle particles [x,y,z,roll,pitch,yaw], the robust
point-to-point gradient with analytic dR/d(angles) (ref: SVGDICP.cpp:
335-455), plain RBF-kernel SVGD transport (:457-474) and a first-order
optimizer step. Each iteration is one call of the 1-NN match wrapper
(`nn.nn_match`, kernel B5 on the card) on the candidate sets prepared once
per frame, then plain tensor algebra.

The optimizers are written out as optax 0.2.6 defines the JAX package's
choices (`make_optimizer` there), not taken from `torch.optim`, whose
defaults differ (RMSprop's decay, Adagrad's initial accumulator and eps).

Early stop: JAX stops inside a device `while_loop` on the mean pose step
`diff_norm`; here the host reads it after every iteration, which gives the
same iteration count. There is no degeneracy skip, as in the JAX module.
"""

from __future__ import annotations

import torch

from svnicp_tpu_torch.config import SteinICPConfig
from svnicp_tpu_torch.core import geometry as geo
from svnicp_tpu_torch.core import svn
from svnicp_tpu_torch.core.residuals import robust_weight
from svnicp_tpu_torch.kernels import nn
from svnicp_tpu_torch.kernels.stein import median_bandwidth


class Optimizer:
    """A first-order update rule on one [P,6] parameter tensor:
    `update(grad, params)` -> the step to add to params (already scaled by
    -lr), advancing the rule's state (optax's GradientTransformation)."""

    def __init__(self, name: str, lr: float, params: torch.Tensor):
        self.name, self.lr, self.count = name.lower(), lr, 0
        zeros = torch.zeros_like(params)
        if self.name == "adam":
            self.mu, self.nu = zeros, zeros.clone()
        elif self.name == "rmsprop":
            self.nu, self.trace = zeros, zeros.clone()
        elif self.name == "adagrad":
            self.sum_sq = torch.full_like(params, 0.1)
        elif self.name != "sgd":
            raise ValueError(f"unknown optimizer {name!r}")

    def update(self, grad: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
        if self.name == "adam":        # optax.adam(lr, b1=0.9, b2=0.999), eps 1e-8
            b1, b2 = 0.9, 0.999
            self.count += 1
            self.mu = (1 - b1) * grad + b1 * self.mu
            self.nu = (1 - b2) * grad ** 2 + b2 * self.nu
            one = torch.ones((), dtype=grad.dtype, device=grad.device)
            mu_hat = self.mu / (1 - (b1 * one) ** self.count)
            nu_hat = self.nu / (1 - (b2 * one) ** self.count)
            step = mu_hat / (torch.sqrt(nu_hat) + 1e-8)
        elif self.name == "rmsprop":   # add_decayed_weights(1e-8), rmsprop(momentum=0.9)
            g = grad + 1e-8 * params
            self.nu = (1 - 0.9) * g ** 2 + 0.9 * self.nu
            self.trace = -self.lr * (torch.rsqrt(self.nu + 1e-8) * g) + 0.9 * self.trace
            return self.trace
        elif self.name == "adagrad":   # initial accumulator 0.1, eps 1e-7
            self.sum_sq = grad * grad + self.sum_sq
            scale = torch.where(self.sum_sq > 0, torch.rsqrt(self.sum_sq + 1e-7),
                                torch.zeros_like(self.sum_sq))
            step = scale * grad
        else:
            step = grad
        return -self.lr * step


def make_optimizer(name: str, lr: float, params: torch.Tensor) -> Optimizer:
    """The reference's torch::optim choice (ref: SVGDICP.cpp:142-170) with
    the JAX package's optax hyperparameters, initialised for `params`."""
    return Optimizer(name, lr, params)


def svgd_transport(x: torch.Tensor, neg_grad: torch.Tensor) -> torch.Tensor:
    """Plain SVGD update (ref: SVGDICP.cpp:457-462):
    (K @ neg_grad + 2/h sum_j (x_i - x_j) K_ij) / P, h the lower-median
    bandwidth."""
    bw = median_bandwidth(x)
    diff = x[:, None, :] - x[None, :, :]
    kernel = torch.exp(-(diff * diff).sum(-1) / bw)
    repulsion = (2.0 / bw) * torch.einsum("ijd,ij->id", diff, kernel)
    return (kernel @ neg_grad + repulsion) / x.shape[0]


def _sgd_grad(cfg: SteinICPConfig, params, source, transformed, matched,
              pair_valid, r0) -> torch.Tensor:
    """Robust point-to-point gradient in Euler coordinates (ref: sgd_grad,
    SVGDICP.cpp:398-455) -> [P,6]. Reference quirks kept: the denominator
    counts the points whose gated transformed point is non-zero, plus one;
    the result is scaled by the source capacity, not the valid count; the
    translation gradient is sum(we) @ r0 and the partials are r0 @ dR."""
    gate = pair_valid[..., None].to(source.dtype)            # [P,B,1]
    e = (transformed - matched) * gate
    en = torch.linalg.vector_norm(e, dim=-1, keepdim=True)
    we = robust_weight(en, cfg.max_dist) * e                 # [P,B,3]
    nonzero = ((transformed * gate).abs().sum(-1) > 0).to(source.dtype).sum(1)
    denom = (nonzero + 1.0)[:, None]
    grad_t = torch.einsum("pbi,ij->pj", we, r0) / denom
    partials = geo.euler_zyx_partials(params[:, 3], params[:, 4], params[:, 5])
    partials = torch.einsum("ij,pajk->paik", r0, partials)   # [P,3,3,3]
    # sum_b we_b . (dR_a s_b) = sum_ik dR_a[i,k] (sum_b we_b[i] s_b[k]):
    # we is zero wherever the gate is, so s needs no gating of its own here
    moment = torch.einsum("pbi,bk->pik", we, source)
    grad_r = torch.einsum("paik,pik->pa", partials, moment) / denom
    return torch.cat([grad_t, grad_r], dim=-1) * float(source.shape[0])


def prepare(source, src_valid, cand_pts, cand_valid) -> nn.PointPrep:
    """Per-frame, loop-invariant operands of the match: K padded to a
    multiple of 8 with invalid slots, correspondence features, B4's layout."""
    cand_pts, cand_valid = nn.pad_candidates(cand_pts, cand_valid, multiple=8)
    feat, bias = svn.correspondence_features(source, cand_pts, cand_valid)
    return nn.prepare_moments_point(feat, bias, cand_pts, source, src_valid)


def iteration(cfg: SteinICPConfig, prep: nn.PointPrep, source, src_valid,
              r0, t0, params, opt: Optimizer):
    """One SVGD epoch -> (new params [P,6], diff_norm)."""
    p = params.shape[0]
    r_total = r0[None] @ geo.euler_zyx_to_matrix(params[:, 3], params[:, 4],
                                                 params[:, 5])
    t_total = t0[None] + params[:, :3] @ r0.T
    transformed = torch.einsum("pij,bj->pbi", r_total, source) + t_total[:, None, :]
    params12 = torch.cat([r_total.reshape(p, 9), t_total], dim=-1).contiguous()
    matched, best = nn.nn_match(params12, prep)
    nn_d2 = best + (transformed * transformed).sum(-1)
    pair_valid = (nn_d2 < cfg.max_dist) & src_valid[None, :]
    g = _sgd_grad(cfg, params, source, transformed, matched, pair_valid, r0)
    stein = svgd_transport(params, -g) if p > 1 else -g
    # the reference sets grad = -stein and steps: minimise -stein
    new_params = params + opt.update(-stein, params)
    diff_norm = torch.linalg.vector_norm(new_params - params, dim=1).mean()
    return new_params, diff_norm


def align(cfg: SteinICPConfig, source, src_valid, cand_pts, cand_valid, r0, t0,
          init_particles) -> svn.AlignResult:
    """SVGD-ICP from `init_particles` [P,6] (Euler local corrections around
    the guess (r0, t0)) -> the particles, uniform weights, mean, unbiased
    variance, covariance / P, iterations and the last diff_norm as
    grad_norm (ref: stein_align, SVGDICP.cpp:66-140)."""
    svn.check_supported(cfg)
    params = init_particles.to(source.dtype)
    p = params.shape[0]
    prep = prepare(source, src_valid, cand_pts, cand_valid)
    opt = make_optimizer(cfg.optimizer, cfg.lr, params)
    it = 0
    diff_norm = torch.tensor(float("inf"), dtype=source.dtype, device=source.device)
    while it < cfg.iterations:
        params, diff_norm = iteration(cfg, prep, source, src_valid, r0, t0,
                                      params, opt)
        it += 1
        if cfg.early_stop and float(diff_norm) < cfg.convergence_threshold:
            break
    weights = torch.full((p,), 1.0 / p, dtype=params.dtype, device=params.device)
    mean = params.mean(0)
    centered = params - mean[None, :]
    var = (centered * centered).sum(0) / max(p - 1, 1)
    cov = torch.einsum("pi,pj->ij", centered, centered) / p
    return svn.AlignResult(params, weights, mean, var, cov, it, diff_norm)


def register(cfg: SteinICPConfig, source, src_valid, target, tgt_valid, r0, t0,
             init_particles) -> svn.AlignResult:
    """Stage-1 candidates at the initial guess (kernel B1 on the card), then
    the SVGD alignment (ref: SVGDICP.cpp:46-62, 176-215)."""
    at_guess = geo.transform_points(r0, t0, source)
    cand_pts, d2 = nn.bucketed_candidates(at_guess, target, src_valid,
                                          tgt_valid, cfg.knn_count)
    return align(cfg, source, src_valid, cand_pts, torch.isfinite(d2), r0, t0,
                 init_particles)
