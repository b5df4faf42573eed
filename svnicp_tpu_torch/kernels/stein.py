"""The fused SVN ensemble update (B3) and its plain version.

Replaces `svnicp_tpu/kernels/stein_pallas.py:stein_update`: per-particle
6x6 Newton solves, the RBF Stein coupling with the median bandwidth, the
trust-region clip and the right-multiplicative SE(3) update, plus the two
exit statistics, in one launch of `csrc/stein.cu` on the card. The plain
version below is the same math on tensors (dtype-generic, so it runs in
float64 too), with the bandwidth's lower median taken by sorting; the
kernel takes the same order statistic by a radix select on the bit
patterns, which `lower_median_radix` spells out step by step.
"""

from __future__ import annotations

import math

import torch

from svnicp_tpu_torch.core import geometry as geo
from svnicp_tpu_torch.core import residuals
from svnicp_tpu_torch.kernels import _build

MAX_PARTICLES = 512   # one CUDA block, at most one thread per particle


def lower_median_radix(sq: torch.Tensor) -> torch.Tensor:
    """The lower median (element (n-1)//2 in sorted order) of a flat
    non-negative float32 tensor, selected as the B3 kernel selects it: on
    the values' bit patterns, which order like the values, in 4 passes of
    8-bit digits from the top. Each pass counts the values that share the
    digits chosen so far in a 256-bin histogram, and a prefix sum picks the
    bin that holds the wanted rank. Equal to sorting, bit for bit. (The
    kernel counts each unordered pair of its distance matrix once with
    weight 2, and stops early once the chosen bin holds a single pair; both
    give the same value.)"""
    bits = sq.reshape(-1).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    rank = (bits.numel() - 1) // 2
    prefix = 0
    for shift in (24, 16, 8, 0):
        high = 0 if shift == 24 else (0xFFFFFFFF << (shift + 8)) & 0xFFFFFFFF
        match = (bits & high) == prefix
        hist = torch.bincount((bits[match] >> shift) & 0xFF, minlength=256)
        incl = torch.cumsum(hist, 0)
        digit = int(torch.searchsorted(incl, rank, right=True))
        rank -= int(incl[digit] - hist[digit])
        prefix |= digit << shift
    as_i32 = prefix - (1 << 32) if prefix >= 1 << 31 else prefix
    return torch.tensor([as_i32], dtype=torch.int32).view(torch.float32)[0]


def median_bandwidth(x: torch.Tensor) -> torch.Tensor:
    """h = lower median of all P^2 squared distances (zero diagonal
    included) / log(P+1), floored at 1e-12 (ref: SVNICP.cpp:254-266)."""
    p = x.shape[0]
    diff = x[:, None, :] - x[None, :, :]
    sq = (diff * diff).sum(-1)
    med = torch.sort(sq.reshape(-1)).values[(p * p - 1) // 2]
    return torch.clamp_min(med / math.log(p + 1), 1e-12)


def svgd_precond_grad(x: torch.Tensor, neg_newton: torch.Tensor,
                      h_mean: torch.Tensor, kernel_scale=None) -> torch.Tensor:
    """Hessian-preconditioned SVGD transport (ref: SVNICP.cpp:218-227) in the
    centred matmul form of the JAX kernel: grad_k_i = (2/h) (x_i ksum_i -
    (K x)_i) on coordinates centred on the ensemble mean (centring leaves
    the math unchanged and removes the f32 cancellation of x*ksum - K@x)."""
    if kernel_scale is not None:
        x = x / kernel_scale
    x = x - x.mean(0, keepdim=True)
    bw = median_bandwidth(x)
    diff = x[:, None, :] - x[None, :, :]
    kernel = torch.exp(-(diff * diff).sum(-1) / bw)
    ksum = kernel.sum(1)
    grad_k = (2.0 / bw) * (x * ksum[:, None] - kernel @ x)
    if kernel_scale is not None:
        grad_k = grad_k / kernel_scale
    repulsion = residuals.cholesky_solve6(h_mean, grad_k)
    return (kernel @ neg_newton + repulsion) / ksum[:, None]


def clip_step(step: torch.Tensor, max_dist: float) -> torch.Tensor:
    """Per-particle trust region: norm-clip each step at max_dist."""
    norm = torch.linalg.vector_norm(step, dim=-1, keepdim=True)
    return step * torch.clamp_max(max_dist / norm.clamp_min(1e-30), 1.0)


def pose_update(r: torch.Tensor, t: torch.Tensor, step: torch.Tensor):
    """R <- R exp(w^), t <- R_new (J_l(w) dt) + t (ref: SVNICP.cpp:268-279)."""
    dt, omega = step[:, :3], step[:, 3:]
    r_new = r @ geo.so3_exp(omega)
    dt_l = (geo.so3_left_jacobian(omega) @ dt[..., None])[..., 0]
    return r_new, (r_new @ dt_l[..., None])[..., 0] + t


def stein_update_plain(hess, b, r, t, prior=None, *, max_dist: float):
    """One ensemble update -> (r_new [P,3,3], t_new [P,3], mean |step|,
    |mean step|). `prior` [2,6] = (inverse variance, kernel scale) turns on
    the MAP prior and the kernel whitening."""
    coords = torch.cat([t, geo.so3_log(r)], dim=-1)
    kernel_scale = None
    if prior is not None:
        hess = hess + torch.diag_embed(prior[0])[None]
        b = b + coords * prior[0]
        kernel_scale = prior[1]
    newton = residuals.cholesky_solve6(hess, b)
    step = svgd_precond_grad(coords, -newton, hess.mean(0), kernel_scale)
    step = clip_step(step, max_dist)
    r_new, t_new = pose_update(r, t, step)
    grad_norm = torch.linalg.vector_norm(step, dim=1).mean()
    mean_delta = torch.linalg.vector_norm(step.mean(0))
    return r_new, t_new, grad_norm, mean_delta


def stein_update(hess, b, r, t, prior=None, *, max_dist: float):
    """The ensemble update (kernel B3 on the card, the plain version on the
    CPU). hess [P,6,6], b [P,6], r [P,3,3], t [P,3], prior [2,6] or None."""
    if hess.device.type == "cpu":
        return stein_update_plain(hess, b, r, t, prior, max_dist=max_dist)
    args = (hess, b, r, t) + (() if prior is None else (prior,))
    _build.require_cuda_f32("stein_update", *args)
    p = hess.shape[0]
    if not 1 <= p <= MAX_PARTICLES:
        raise ValueError(f"stein_update: 1 <= P <= {MAX_PARTICLES}, got {p}")
    if (hess.shape != (p, 6, 6) or b.shape != (p, 6) or r.shape != (p, 3, 3)
            or t.shape != (p, 3) or (prior is not None and prior.shape != (2, 6))):
        raise ValueError("stein_update: shapes must be [P,6,6], [P,6], "
                         "[P,3,3], [P,3] and [2,6]")
    r_new = torch.empty_like(r)
    t_new = torch.empty_like(t)
    stats = torch.empty((2,), dtype=torch.float32, device=hess.device)
    err = _build.library("stein.cu").svn_stein_update(
        _build.ptr(hess), _build.ptr(b), _build.ptr(r), _build.ptr(t),
        None if prior is None else _build.ptr(prior), p, float(max_dist),
        _build.ptr(r_new), _build.ptr(t_new), _build.ptr(stats),
        _build.stream_of(hess))
    _build.check(err, "stein kernel")
    _build.count_launch(stein_update)
    return r_new, t_new, stats[0], stats[1]


stein_update.launches = 0
