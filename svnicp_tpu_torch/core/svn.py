"""Stein Variational Newton ICP: the registration engine.

Port of `svnicp_tpu/core/svn.py` for both residuals, both couplings and
both routes, chosen by the configuration where the JAX package chooses
them:
- the kernel route (`use_pallas`): the moments wrapper of the residual
  (kernel B2 plane, B4 point, on the card) for every particle's
  Gauss-Newton system, then the ensemble-update wrapper (kernel B3) for
  the Newton solve, Stein coupling and pose update. Both take the
  candidate sets padded to a multiple of 8 slots and average tied minima,
  as the Pallas kernels do. With `stein_kernel: false`, `svn_full_grad` or
  one particle the update is the plain one below in place of B3;
- the XLA route (`use_pallas: false`): the 1-NN by index among the
  candidates (one [P,12] x [12,B*K] product, the first index at ties), the
  Gauss-Newton systems of `core/residuals.py` and the plain update: prior
  information, the Cholesky solves, the Hessian-preconditioned coupling
  (or `svn_full_update`), the trust-region clip and the SE(3) update.
For CPU tensors the kernel wrappers run their plain versions, in float32
or float64. `match_count` keeps the nearest-at-guess candidates of each
point after the plane fit on the full set.

Early stop: JAX stops inside a device `while_loop`. Here one driver,
`align_loop`, runs every SVN loop (the mesh's too) in rounds of m passes,
each pass's update kept or dropped on the device: kept while the loop has
not converged (the statistic compared in float64) and fewer than
`cfg.iterations` passes were kept. After each round the host reads (done,
it) once and stops when the loop converged or reached the cap, which
gives the same result as a read after every pass. m is `ALIGN_CHUNK` on
the card and 1 on the CPU and on a mesh; `align_with_history` runs one
round of every pass. On the card's kernel route with B3 (P > 1) a round
of `align` is one CUDA graph of its m passes, captured once per
configuration and shapes (`core/cuda_graph.py`), so the host issues one
launch a round in place of each pass's operations. A degenerate
correspondence set (fewer than 6 source points with any candidate) skips
the loop with grad_norm = +inf, which the pipeline reads as a failed
alignment.

Reference quirks kept (see the JAX module): the correspondence gate compares
the SQUARED distance against the unsquared max_dist, point-to-point pairs
outside the gate add the identity damping of weight 1 to H, and particle
weights stay uniform.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from svnicp_tpu_torch.config import SteinICPConfig
from svnicp_tpu_torch.core import cuda_graph
from svnicp_tpu_torch.core import geometry as geo
from svnicp_tpu_torch.core import residuals
from svnicp_tpu_torch.kernels import knn, nn, stein
from svnicp_tpu_torch.runtime.profiling import count, span

MIN_CONSTRAINT_POINTS = 6   # a 6-DoF system needs >= 6 constrained points
# passes a round of the align loop runs on the card before the host reads
# its stop flags: a frozen pass after the stop costs the card ~35-65 us,
# a read ~30-50 us of the host's wait; chosen by
# tools/torch_align_chunk_sweep.py (PERF.md, Findings)
ALIGN_CHUNK = 10


class AlignResult(NamedTuple):
    """Outputs of one alignment (ref getters: SVNICP.cpp:281-308)."""

    particles: torch.Tensor   # [P,6] local correction per particle: [t, log R]
    weights: torch.Tensor     # [P] uniform
    mean: torch.Tensor        # [6]
    var: torch.Tensor         # [6]
    cov: torch.Tensor         # [6,6]
    iterations: int           # iterations actually run
    grad_norm: torch.Tensor   # scalar: mean |stein step| at exit


class AlignPrep(NamedTuple):
    """Per-frame, loop-invariant operands of the align loop."""

    cand_pts: torch.Tensor    # [B,K,3] (K padded to 8 on the kernel route)
    cand_valid: torch.Tensor  # [B,K]
    normals: tuple | None     # (unit normals [B,3], fit valid [B]) or None
    feat: torch.Tensor        # [B*K,12] correspondence features
    bias: torch.Tensor        # [B,K]
    kernel: nn.PlanePrep | nn.PointPrep | None   # the kernel route's layout


def init_particles_uniform(generator: torch.Generator, count: int, lb, ub,
                           dtype=torch.float32, device=None) -> torch.Tensor:
    """A uniform particle prior in the box [lb, ub), [P,6], drawn from
    `generator` (the JAX package draws from a PRNG key); one particle is
    the zero pose (ref: svn-icp/src/core/ICPUtils.cpp:45-58)."""
    if count == 1:
        return torch.zeros((1, 6), dtype=dtype, device=device)
    lb = torch.as_tensor(lb, dtype=dtype, device=device)
    ub = torch.as_tensor(ub, dtype=dtype, device=device)
    u = torch.rand((count, 6), generator=generator, dtype=dtype, device=device)
    return lb + (ub - lb) * u


def init_particles_gaussian(generator: torch.Generator, count: int, std,
                            dtype=torch.float32, device=None) -> torch.Tensor:
    """A zero-mean Gaussian particle prior clamped at 3 sigma, [P,6], drawn
    from `generator` (ref: svn-icp/src/core/ICPUtils.cpp:60-75)."""
    if count == 1:
        return torch.zeros((1, 6), dtype=dtype, device=device)
    std = torch.as_tensor(std, dtype=dtype, device=device)
    z = torch.randn((count, 6), generator=generator, dtype=dtype, device=device) * std
    return torch.clamp(z, -3.0 * std, 3.0 * std)


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


def nearest_at_guess(cand_pts, cand_valid, at_guess, m: int):
    """The m candidates of each point nearest its position at the guess,
    nearest first and the lower slot first at equal distance (JAX's
    `lax.top_k` of the negated distances)."""
    d2 = ((cand_pts - at_guess[:, None, :]) ** 2).sum(-1)
    d2 = torch.where(cand_valid, d2, torch.full_like(d2, float("inf")))
    idx = torch.sort(d2, dim=1, stable=True).indices[:, :m]
    return (torch.gather(cand_pts, 1, idx[..., None].expand(-1, -1, 3)),
            torch.gather(cand_valid, 1, idx))


def _prepare_align(cfg: SteinICPConfig, source, src_valid, cand_pts,
                   cand_valid, r0, t0) -> AlignPrep:
    """Plane normals from the full candidate sets (point-to-plane), the
    match_count cut, K padded to a multiple of 8 with invalid slots on the
    kernel route, the correspondence features and the kernel's layout."""
    plane = cfg.residual == "point_to_plane"
    normals = residuals.plane_normals(cand_pts, cand_valid) if plane else None
    if 0 < cfg.match_count < cand_pts.shape[1]:
        cand_pts, cand_valid = nearest_at_guess(
            cand_pts, cand_valid, geo.transform_points(r0, t0, source),
            cfg.match_count)
    if cfg.use_pallas:
        cand_pts, cand_valid = nn.pad_candidates(cand_pts, cand_valid, multiple=8)
    feat, bias = correspondence_features(source, cand_pts, cand_valid)
    kernel = None
    if cfg.use_pallas and plane:
        kernel = nn.prepare_moments_plane(feat, bias, cand_pts, source,
                                          normals[0], normals[1] & src_valid)
    elif cfg.use_pallas:
        kernel = nn.prepare_moments_point(feat, bias, cand_pts, source, src_valid)
    return AlignPrep(cand_pts, cand_valid, normals, feat, bias, kernel)


def xla_moments(cfg: SteinICPConfig, prep: AlignPrep, source, src_valid,
                r_total, t_total):
    """Every particle's 1-NN among the candidates by index (first index at
    ties), then its Gauss-Newton system (H [P,6,6], b [P,6])."""
    p = r_total.shape[0]
    bsz, k = prep.cand_pts.shape[:2]
    transformed = (torch.einsum("pij,bj->pbi", r_total, source)
                   + t_total[:, None, :])
    params = torch.cat([r_total.reshape(p, 9), t_total], dim=-1)
    score = (params @ prep.feat.T).mul_(-2.0).add_(prep.bias.reshape(1, -1))
    score = score.reshape(p, bsz, k)
    nn_idx = torch.argmin(score, dim=-1)
    best = torch.gather(score, 2, nn_idx[..., None])[..., 0]
    del score
    matched = prep.cand_pts[torch.arange(bsz, device=source.device)[None, :], nn_idx]
    nn_d2 = (best + (transformed * transformed).sum(-1)).clamp_min(0.0)
    # reference quirk: the gate compares the squared distance with max_dist
    pair_valid = (nn_d2 < cfg.max_dist) & torch.isfinite(best)
    if prep.normals is not None:
        n_vec, n_valid = prep.normals
        return residuals.ensemble_gauss_newton_plane(
            source, transformed, matched, n_vec,
            pair_valid & (n_valid & src_valid)[None, :], r_total, cfg.max_dist)
    return residuals.ensemble_gauss_newton(source, transformed, matched,
                                           pair_valid, src_valid, r_total,
                                           cfg.max_dist)


# the JAX package's names for two steps of the update, which the port keeps
# beside the Stein kernel's plain version
median_bandwidth = stein.median_bandwidth
clip_step = stein.clip_step


def prior_kernel_scale(cfg: SteinICPConfig, dtype, device=None) -> torch.Tensor:
    """[6] kernel whitening scale under cfg.prior_information: the prior std
    of the particle box."""
    return torch.sqrt(1.0 / prior_inverse_variance(cfg, dtype, device))


def add_prior_information(cfg: SteinICPConfig, hess, b, coords):
    """The MAP prior term: the particle box as a Gaussian N(0, P) in local
    [t, log R] coordinates, P = (ub-lb)^2/12; H += P^-1, b += P^-1 x."""
    inv = prior_inverse_variance(cfg, coords.dtype, coords.device)
    return hess + torch.diag(inv)[None], b + coords * inv[None, :]


def rbf_kernel_block(x_rows: torch.Tensor, x_full: torch.Tensor, bw):
    """RBF kernel rows K[i,j] = exp(-|x_i - x_j|^2 / bw) of the rows x_rows
    [Pl,6] against x_full [P,6] -> (K [Pl,P], diff [Pl,P,6] = x_i - x_j)."""
    diff = x_rows[:, None, :] - x_full[None, :, :]
    return torch.exp(-(diff * diff).sum(-1) / bw), diff


def rbf_kernel(x: torch.Tensor, x_rows: torch.Tensor | None = None):
    """RBF kernel K[i,j] = exp(-|x_i - x_j|^2 / h) with the lower-median
    bandwidth h of the full set x -> (K, h, diff = x_i - x_j), [P,P] and
    [P,P,6]; with `x_rows` [Pl,6] (a particle shard's rows) only those
    rows, [Pl,P] and [Pl,P,6]."""
    bw = median_bandwidth(x)
    kernel, diff = rbf_kernel_block(x if x_rows is None else x_rows, x, bw)
    return kernel, bw, diff


def svgd_precond_grad(x, neg_newton, h_mean, kernel_scale=None,
                      x_rows=None) -> torch.Tensor:
    """Hessian-preconditioned SVGD transport (ref: SVNICP.cpp:218-227) in
    the JAX package's XLA form: (K (-H^-1 b) + H_mean^-1 grad_k) / rowsum K,
    on coordinates whitened by `kernel_scale` [6] when it is given; with
    `x_rows` the rows of those particles only (x and neg_newton are then
    the gathered full set)."""
    if kernel_scale is not None:
        x = x / kernel_scale[None, :]
        if x_rows is not None:
            x_rows = x_rows / kernel_scale[None, :]
    kernel, bw, diff = rbf_kernel(x, x_rows)
    grad_k = (2.0 / bw) * torch.einsum("ijd,ij->id", diff, kernel)
    if kernel_scale is not None:
        grad_k = grad_k / kernel_scale[None, :]
    repulsion = residuals.cholesky_solve6(h_mean, grad_k)
    return (kernel @ neg_newton + repulsion) / kernel.sum(1, keepdim=True)


def svn_full_update(x, hess, neg_b, lr: float, x_rows=None) -> torch.Tensor:
    """Full second-order Stein-Newton update (ref: SVNICP.cpp:229-252):
    lr * H_bar^-1 (K (-b) + sum_j grad_k) / P, H_bar = (sum_j K^2 H_j +
    grad_k grad_k^T) / P; with `x_rows` the rows of those particles only
    (x, hess and neg_b the gathered full set)."""
    p = x.shape[0]
    kernel, bw, diff = rbf_kernel(x, x_rows)
    grad_k = (2.0 / bw) * diff * kernel[..., None]                # [P,P,6]
    grad2 = torch.einsum("ijk,ijl->ikl", grad_k, grad_k)
    k2h = torch.einsum("ij,jkl->ikl", kernel * kernel, hess)
    h_bar = (k2h + grad2) / p
    drive = (kernel @ neg_b + grad_k.sum(1)) / p
    return lr * residuals.cholesky_solve6(h_bar, drive)


def ensemble_update(cfg: SteinICPConfig, hess, b, r, t):
    """The plain ensemble update (the JAX package's XLA route) -> (r, t,
    mean |step|, stop statistic): prior information, the Newton solves,
    the Stein coupling (one particle: the Newton step alone), the
    trust-region clip and the SE(3) update."""
    p = r.shape[0]
    coords = particle_coords(r, t)
    kernel_scale = None
    if cfg.prior_information:
        hess, b = add_prior_information(cfg, hess, b, coords)
        kernel_scale = prior_kernel_scale(cfg, coords.dtype, coords.device)
    newton = residuals.cholesky_solve6(hess, b)
    if p == 1:
        step = -newton
    elif cfg.svn_full_grad:
        step = svn_full_update(coords, hess, -b, cfg.lr)
    else:
        step = svgd_precond_grad(coords, -newton, hess.mean(0), kernel_scale)
    step = clip_step(step, cfg.max_dist)
    r_new, t_new = stein.pose_update(r, t, step)
    grad_norm = torch.linalg.vector_norm(step, dim=1).mean()
    if cfg.convergence_metric == "mean_delta":
        return r_new, t_new, grad_norm, torch.linalg.vector_norm(step.mean(0))
    return r_new, t_new, grad_norm, grad_norm


def _svn_iteration(cfg: SteinICPConfig, prep: AlignPrep, source, src_valid,
                   prior, r0, t0, r, t):
    """One SVN epoch -> (r, t, grad_norm, stop statistic)."""
    p = r.shape[0]
    r_total = r0[None] @ r
    t_total = t0[None] + t @ r0.T
    if prep.kernel is None:
        hess, b = xla_moments(cfg, prep, source, src_valid, r_total, t_total)
    else:
        params = torch.cat([r_total.reshape(p, 9), t_total], dim=-1).contiguous()
        hess, b = nn.moments(params, prep.kernel, cfg.max_dist)
    if prep.kernel is None or not cfg.stein_kernel or cfg.svn_full_grad or p == 1:
        return ensemble_update(cfg, hess, b, r, t)
    r_new, t_new, grad_norm, mean_delta = stein.stein_update(
        hess, b, r, t, prior, max_dist=cfg.max_dist)
    stop = mean_delta if cfg.convergence_metric == "mean_delta" else grad_norm
    return r_new, t_new, grad_norm, stop


def _start(cfg: SteinICPConfig, source, src_valid, cand_pts, cand_valid, r0,
           t0, init_particles):
    """Initial poses, the degeneracy test (one host read), the frame's
    operands and B3's prior -> (r, t, degenerate, prep, prior)."""
    r = geo.so3_exp(init_particles[:, 3:])
    t = init_particles[:, :3].contiguous()
    with span("svnicp.sync.degenerate"):
        pairs = int(valid_pair_count(src_valid, cand_valid))
    if pairs < MIN_CONSTRAINT_POINTS:
        return r, t, True, None, None
    prep = _prepare_align(cfg, source, src_valid, cand_pts, cand_valid, r0, t0)
    prior = None
    if cfg.prior_information:
        inv = prior_inverse_variance(cfg, source.dtype, source.device)
        prior = torch.stack([inv, torch.sqrt(1.0 / inv)])
    return r, t, False, prep, prior


def _chunk(device: torch.device) -> int:
    """Passes a round: ALIGN_CHUNK on the card, where a read waits for the
    device; 1 on the CPU, where a read costs nothing and a frozen pass
    would."""
    return ALIGN_CHUNK if device.type == "cuda" else 1


def _step(cfg: SteinICPConfig, prep: AlignPrep, source, src_valid, prior, r0, t0):
    """The frame's SVN pass as `step(r, t) -> (r, t, grad_norm, stop
    statistic)`; it calls the module's `_svn_iteration` of the moment."""
    return lambda r, t: _svn_iteration(cfg, prep, source, src_valid, prior,
                                       r0, t0, r, t)


def loop_state(r, t) -> tuple:
    """The align loop's state before its first pass: (r, t, grad_norm =
    +inf, done = False, passes kept = 0)."""
    dev = t.device
    return (r, t, torch.full((), float("inf"), dtype=t.dtype, device=dev),
            torch.zeros((), dtype=torch.bool, device=dev),
            torch.zeros((), dtype=torch.int64, device=dev))


def _frozen_passes(cfg: SteinICPConfig, m: int, step, r, t, grad_norm, done, it,
                   record=None):
    """m passes of `step`, each kept only while the loop runs (not done,
    and fewer than cfg.iterations passes kept); a dropped pass leaves the
    state as it was. `record(r, t)` is called after every pass -> (r, t,
    grad_norm, done, it)."""
    for _ in range(m):
        r_new, t_new, g, stop = step(r, t)
        keep = ~done & (it < cfg.iterations)
        r = torch.where(keep, r_new, r)
        t = torch.where(keep, t_new, t)
        grad_norm = torch.where(keep, g, grad_norm)
        it = it + keep
        if cfg.early_stop:
            # in float64: float32 would round the threshold (a Python float)
            done = done | (keep & (stop.double() < cfg.convergence_threshold))
        if record is not None:
            record(r, t)
    return r, t, grad_norm, done, it


def _stop_flags(state) -> torch.Tensor:
    """(done, it) of a loop state, packed for one read."""
    return torch.stack([state[3].to(state[4].dtype), state[4]])


def align_loop(cfg: SteinICPConfig, m: int, step, state, graph=None, record=None):
    """The driver of every SVN align loop, on one device or on a mesh shard:
    rounds of m `_frozen_passes` of `step` from `state` (`loop_state`), or
    of the `graph`'s replays (`_graph_round`), until the loop converged or
    kept cfg.iterations passes, with one read of the stop flags a round;
    `record` as in `_frozen_passes` -> (r, t, grad_norm, iterations as an
    int). Spans: each round, and inside it the round's read of the stop
    flags."""
    it, done = 0, False
    while not done and it < cfg.iterations:
        with span("svnicp.align.iter"):
            if graph is not None:
                state, flags = graph()
            else:
                state = _frozen_passes(cfg, m, step, *state, record=record)
                flags = _stop_flags(state) if cfg.early_stop else None
                count("svnicp.align.eager_rounds")
            it = min(it + m, cfg.iterations)
            if cfg.early_stop:
                with span("svnicp.sync.stop"):
                    done, it = flags.tolist()
    return (*state[:3], it)


def _graphed(cfg: SteinICPConfig, prep: AlignPrep, source, particles: int) -> bool:
    """Whether a round runs as a CUDA graph: on the card's kernel route with
    B3, outside any other capture."""
    return (source.is_cuda and prep.kernel is not None and cfg.stein_kernel
            and not cfg.svn_full_grad and particles > 1
            and not torch.cuda.is_current_stream_capturing())


# the kernel wrappers a round launches, whose counts a replay advances
_ROUND_KERNELS = (nn.plane_moments, nn.point_moments, stein.stein_update)


def _graph_round(cfg: SteinICPConfig, m: int, prep: AlignPrep, source,
                 src_valid, prior, r0, t0, state):
    """The round's m passes as one CUDA graph, captured at the first frame
    of each configuration and shapes; this frame's loop-invariant operands
    (the kernel's prep, source, r0, t0, B3's prior) and initial state are
    copied into its static inputs -> a function that runs one round and
    returns (the state, held in the graph's buffers, and its packed stop
    flags). The captured pass is the module's `_svn_iteration` of the
    moment, which the key names."""
    kernel = prep.kernel
    inputs = [source, src_valid, r0, t0, *state, *kernel]
    inputs += [] if prior is None else [prior]

    def passes(source, src_valid, r0, t0, r, t, grad_norm, done, it, *rest):
        # the static copies; the other fields of the prep are not read here
        kprep = AlignPrep(None, None, None, None, None,
                          type(kernel)(*rest[:len(kernel)]))
        step = _step(cfg, kprep, source, src_valid,
                     rest[len(kernel)] if prior is not None else None, r0, t0)
        out = _frozen_passes(cfg, m, step, r, t, grad_norm, done, it)
        for buf, v in zip((r, t, grad_norm, done, it), out):
            buf.copy_(v)
        return [_stop_flags(out)]

    entry, new = cuda_graph.capture(
        ("svnicp.align", cfg, m, _svn_iteration, type(kernel)), passes, *inputs,
        counted=_ROUND_KERNELS)
    if new:
        count("svnicp.align.graph_captures")
    for s, a in zip(entry.static, inputs):
        s.copy_(a)
    bufs = tuple(entry.static[4:9])

    def run():
        cuda_graph.launch(entry)
        count("svnicp.align.graph_replays")
        return bufs, entry.out[0]
    return run


def align(cfg: SteinICPConfig, source, src_valid, cand_pts, cand_valid, r0, t0,
          init_particles) -> AlignResult:
    """Run the SVN ensemble to convergence from `init_particles` [P,6]
    ([t, w] local corrections around the guess (r0, t0)) and return the
    local correction distribution (ref: SVNICP.cpp:41-114). Spans: the
    whole call, and the loop's (`align_loop`)."""
    with span("svnicp.align", on=source):
        r, t, degenerate, prep, prior = _start(cfg, source, src_valid, cand_pts,
                                               cand_valid, r0, t0, init_particles)
        if degenerate:
            return ensemble_result(r, t, 0, float("inf"))
        m, state = _chunk(source.device), loop_state(r, t)
        graph = None
        if _graphed(cfg, prep, source, r.shape[0]):
            graph = _graph_round(cfg, m, prep, source, src_valid, prior, r0, t0, state)
        r, t, grad_norm, it = align_loop(
            cfg, m, _step(cfg, prep, source, src_valid, prior, r0, t0), state, graph)
        return ensemble_result(r, t, it, grad_norm.clone())


def align_with_history(cfg: SteinICPConfig, source, src_valid, cand_pts,
                       cand_valid, r0, t0, init_particles
                       ) -> tuple[AlignResult, torch.Tensor]:
    """`align` that also returns the particle stack [iterations,P,6] after
    every epoch (ref: particle_stack_ logging, SVNICP.cpp:103-107). It runs
    one round of all `cfg.iterations` epochs, frozen on the device after
    convergence, so later rows repeat the final particles."""
    r, t, degenerate, prep, prior = _start(cfg, source, src_valid, cand_pts,
                                           cand_valid, r0, t0, init_particles)
    if degenerate:
        coords = particle_coords(r, t)
        return (ensemble_result(r, t, 0, float("inf")),
                coords.expand(cfg.iterations, -1, -1).clone())
    history = []
    r, t, grad_norm, it = align_loop(
        cfg, cfg.iterations, _step(cfg, prep, source, src_valid, prior, r0, t0),
        loop_state(r, t), record=lambda r, t: history.append(particle_coords(r, t)))
    return ensemble_result(r, t, it, grad_norm), torch.stack(history)


def _candidates(cfg: SteinICPConfig, source, src_valid, target, tgt_valid, r0, t0):
    """Stage-1 candidates at the initial guess (`knn.find_candidate_points`:
    kernel B1 on the kernel route, by index otherwise). Counters, from the
    shapes: `svnicp.candidates.scores`, the (source, target) pairs scored,
    padding rows included, and `svnicp.candidates.target_rows`."""
    with span("svnicp.candidates", on=source):
        count("svnicp.candidates.scores", source.shape[0] * target.shape[0])
        count("svnicp.candidates.target_rows", target.shape[0])
        at_guess = geo.transform_points(r0, t0, source)
        return knn.find_candidate_points(cfg, at_guess, target, src_valid, tgt_valid)


def register(cfg: SteinICPConfig, source, src_valid, target, tgt_valid, r0, t0,
             init_particles) -> AlignResult:
    """Stage-1 candidates at the initial guess, then the SVN alignment
    (ref: SVGDICP.cpp:46-62, 176-215; SVNICP.cpp:41-114)."""
    cand_pts, cand_valid = _candidates(cfg, source, src_valid, target,
                                       tgt_valid, r0, t0)
    return align(cfg, source, src_valid, cand_pts, cand_valid, r0, t0,
                 init_particles)


def register_with_history(cfg: SteinICPConfig, source, src_valid, target,
                          tgt_valid, r0, t0, init_particles
                          ) -> tuple[AlignResult, torch.Tensor]:
    """`register` returning the particle stack [iterations,P,6] beside the
    result (ref: SVNICP.cpp:103-107, OdometryPipeline.cpp:966-985)."""
    cand_pts, cand_valid = _candidates(cfg, source, src_valid, target,
                                       tgt_valid, r0, t0)
    return align_with_history(cfg, source, src_valid, cand_pts, cand_valid,
                              r0, t0, init_particles)
