"""The SVN-ICP hot loop sharded over a ("particle", "point") mesh.

Port of `svnicp_tpu/parallel/sharding.py`, the same math and the same
collectives, with each shard-local body written once against the
collectives object of `parallel/mesh.py` (in one process or over
`torch.distributed` ranks, `parallel/distributed.py`):
- the particle ensemble is sharded over "particle" and the source points
  over "point";
- each shard's partial Gauss-Newton system (H, b) is summed over the point
  axis, less the jitter identity the other point shards added, then the
  MAP prior is added once;
- the Stein coupling gathers the [P,6] coordinates and the [P,6] Newton
  directions (or, with svn_full_grad, the [P,6,6] Hessians and [P,6]
  gradients) over the particle axis and computes its own kernel rows;
- the stop statistic is a particle-axis pmean, identical on every shard,
  and the loop is `core/svn.py`'s driver with one pass a round: the host
  reads the stop flags after every pass, and all shards leave the loop on
  the same pass.

Routes, copied from the JAX package as they are: stage 1 runs by index on
each point shard (`knn.find_candidates`, never kernel B1); the Newton
solve and the coupling are plain ops between the collectives (never B3);
the moments are kernel B2 or B4 on each shard when `use_pallas` is set and
the shard's rows are a multiple of 128 (their plain versions for CPU
tensors), else the 1-NN by index and the plain Gauss-Newton sums. The
JAX package ignores `match_count` here, and so does this module.
"""

from __future__ import annotations

import torch

from svnicp_tpu_torch.config import SteinICPConfig
from svnicp_tpu_torch.core import geometry as geo
from svnicp_tpu_torch.core import residuals, svn
from svnicp_tpu_torch.kernels import knn, nn, stein
from svnicp_tpu_torch.parallel.mesh import PARTICLE_AXIS, POINT_AXIS, Mesh

_JITTER = 1e-6


def make_mesh(particle_shards: int, point_shards: int, devices=None,
              kind: str | None = None):
    """A ("particle", "point") mesh over the given devices (which may repeat
    one device), or over every visible device of type `kind` (default: the
    cards when there are any, else the CPU); raises when there are too few.
    After `distributed.initialize` with devices=None, the mesh spans the
    ranks, one shard each."""
    from svnicp_tpu_torch.parallel import distributed

    if devices is None and distributed.is_multiprocess():
        return distributed.DistMesh(particle_shards, point_shards, kind=kind)
    if devices is None:
        kind = kind or ("cuda" if torch.cuda.is_available() else "cpu")
        devices = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                   if kind == "cuda" else [torch.device("cpu")])
    n = particle_shards * point_shards
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    return Mesh(list(devices)[:n], particle_shards, point_shards)


def auto_axes(n_devices: int, particle_count: int) -> tuple[int, int]:
    """Factor n_devices into (particle, point) shards: as many particle
    shards as divide the ensemble, the rest on the point axis."""
    particle = 1
    while (particle * 2 <= n_devices and n_devices % (particle * 2) == 0
           and particle_count % (particle * 2) == 0):
        particle *= 2
    return particle, n_devices // particle


def _sharded_iteration(coll, cfg: SteinICPConfig, source, src_valid,
                       prep: svn.AlignPrep, r0, t0, r, t):
    """One SVN epoch on a (particle, point) shard: source/prep are the
    local point shard, r/t the local particles [Pl,...]. Returns the
    updated local particles, the global mean |step| and stop statistic."""
    p_local = r.shape[0]
    r_total = r0[None] @ r
    t_total = t0[None] + t @ r0.T
    if prep.kernel is not None:
        params = torch.cat([r_total.reshape(p_local, 9), t_total], dim=-1).contiguous()
        hess, b = nn.moments(params, prep.kernel, cfg.max_dist)
    else:
        # (JAX's sharded body also masks the pairs with the source mask:
        # the same sums, as a padded point's weight is zero either way)
        hess, b = svn.xla_moments(cfg, prep, source, src_valid, r_total, t_total)
    # each point shard added the jitter identity: keep one after the sum
    n_point = coll.axis_size(POINT_AXIS)
    hess = coll.psum(hess, POINT_AXIS) - (n_point - 1) * _JITTER * torch.eye(
        6, dtype=hess.dtype, device=hess.device)
    b = coll.psum(b, POINT_AXIS)
    coords = svn.particle_coords(r, t)                         # [Pl,6]
    kernel_scale = None
    if cfg.prior_information:
        # the MAP prior, once, after the point sum
        hess, b = svn.add_prior_information(cfg, hess, b, coords)
        kernel_scale = svn.prior_kernel_scale(cfg, coords.dtype, coords.device)
    newton = residuals.cholesky_solve6(hess, b)
    coords_full = coll.all_gather(coords, PARTICLE_AXIS, tiled=True)
    if cfg.svn_full_grad:
        hess_full = coll.all_gather(hess, PARTICLE_AXIS, tiled=True)
        negb_full = coll.all_gather(-b, PARTICLE_AXIS, tiled=True)
        step = svn.svn_full_update(coords_full, hess_full, negb_full, cfg.lr,
                                   x_rows=coords)
    else:
        h_mean = coll.pmean(hess.mean(0), PARTICLE_AXIS)
        neg_newton_full = coll.all_gather(-newton, PARTICLE_AXIS, tiled=True)
        step = svn.svgd_precond_grad(coords_full, neg_newton_full, h_mean,
                                     kernel_scale, x_rows=coords)
    step = svn.clip_step(step, cfg.max_dist)
    r_new, t_new = stein.pose_update(r, t, step)
    grad_norm = coll.pmean(torch.linalg.vector_norm(step, dim=1).mean(), PARTICLE_AXIS)
    if cfg.convergence_metric == "mean_delta":
        # drift of the FULL ensemble mean: pmean of the local mean step
        stop = torch.linalg.vector_norm(coll.pmean(step.mean(0), PARTICLE_AXIS))
    else:
        stop = grad_norm
    return r_new, t_new, grad_norm, stop


def ensemble_outputs(coll, r, t, it: int, grad_norm, hist) -> tuple:
    """The replicated AlignResult fields (as the JAX sharded bodies reduce
    them: mean over the gathered particles, population variance and
    covariance), then the history (or an empty placeholder)."""
    particles = coll.all_gather(svn.particle_coords(r, t), PARTICLE_AXIS, tiled=True)
    p = particles.shape[0]
    weights = torch.full((p,), 1.0 / p, dtype=particles.dtype, device=particles.device)
    mean = particles.mean(0)
    centered = particles - mean[None, :]
    var = (centered * centered).mean(0)
    cov = torch.einsum("pi,pj->ij", centered, centered) / p
    if hist is None:
        hist = particles.new_zeros((0, p, 6))
    return particles, weights, mean, var, cov, it, grad_norm, hist


RESULT_SPECS = (None,) * 8


def to_result(outs: tuple, history: bool):
    """The run's outputs -> AlignResult, or (AlignResult, [iters,P,6])."""
    result = svn.AlignResult(*outs[:7])
    return (result, outs[7]) if history else result


def shard_prep(cfg: SteinICPConfig, source_l, src_valid_l, cand_l, cand_valid_l
               ) -> svn.AlignPrep:
    """A point shard's loop-invariant operands: the plane fit on its own
    candidates (no communication), and with `use_pallas` at a row count
    that is a multiple of 128 the candidates padded to 8 slots and the
    kernel's (B2 or B4) layout."""
    normals = None
    if cfg.residual == "point_to_plane":
        normals = residuals.plane_normals(cand_l, cand_valid_l)
    kernel = None
    if cfg.use_pallas and source_l.shape[0] % 128 == 0:
        cand_l, cand_valid_l = nn.pad_candidates(cand_l, cand_valid_l, multiple=8)
        feat, bias = svn.correspondence_features(source_l, cand_l, cand_valid_l)
        if normals is not None:
            kernel = nn.prepare_moments_plane(feat, bias, cand_l, source_l, normals[0],
                                              normals[1] & src_valid_l)
        else:
            kernel = nn.prepare_moments_point(feat, bias, cand_l, source_l, src_valid_l)
    else:
        feat, bias = svn.correspondence_features(source_l, cand_l, cand_valid_l)
    return svn.AlignPrep(cand_l, cand_valid_l, normals, feat, bias, kernel)


def _align_shard(coll, cfg: SteinICPConfig, source_l, src_valid_l,
                 prep: svn.AlignPrep, r0, t0, init_l, history: bool) -> tuple:
    """Every sharded body's align loop, on its shard's operands `prep`:
    svn's driver (`svn.align_loop`) with `_sharded_iteration` as the pass,
    then the replicated statistics. Without history one pass a round (a
    mesh pass is collectives the host waits for, so a frozen pass would
    cost it what a live one does); with history one round of every pass,
    each recording the FULL particles by a particle-axis all_gather, the
    single-device history on every shard. A degenerate set (the same on
    every shard) runs no pass, and its history repeats the initial
    particles, as the JAX package's frozen scan does."""
    r = geo.so3_exp(init_l[:, 3:])
    t = init_l[:, :3].contiguous()

    def gathered(r_, t_):
        return coll.all_gather(svn.particle_coords(r_, t_), PARTICLE_AXIS, tiled=True)

    def step(r_, t_):
        return _sharded_iteration(coll, cfg, source_l, src_valid_l, prep, r0, t0, r_, t_)

    state = svn.loop_state(r, t)
    # svn's degeneracy test on the pair count summed over the point shards
    pairs = coll.psum(int(svn.valid_pair_count(src_valid_l, prep.cand_valid)), POINT_AXIS)
    if pairs < svn.MIN_CONSTRAINT_POINTS:
        hist = gathered(r, t).expand(cfg.iterations, -1, -1).clone() if history else None
        return ensemble_outputs(coll, r, t, 0, state[2], hist)   # grad_norm +inf
    if not history:
        r, t, gn, it = svn.align_loop(cfg, 1, step, state)
        return ensemble_outputs(coll, r, t, it, gn, None)
    hist = []
    r, t, gn, it = svn.align_loop(cfg, cfg.iterations, step, state,
                                  record=lambda r_, t_: hist.append(gathered(r_, t_)))
    return ensemble_outputs(coll, r, t, it, gn, torch.stack(hist))


def sharded_align(mesh, cfg: SteinICPConfig, source, src_valid, cand_pts,
                  cand_valid, r0, t0, init_particles, history: bool = False):
    """Distributed `svn.align`: the same math, mesh-parallel. The source
    rows and candidates [B,...] are split over the point axis, the particles
    [P,6] over the particle axis; the result is replicated. With history,
    (result, [iters,P,6] particle stack)."""
    def body(coll, source_l, src_valid_l, cand_l, cand_valid_l, r0_l, t0_l, init_l):
        prep = shard_prep(cfg, source_l, src_valid_l, cand_l, cand_valid_l)
        return _align_shard(coll, cfg, source_l, src_valid_l, prep, r0_l, t0_l,
                            init_l, history)

    outs = mesh.run(body, (source, src_valid, cand_pts, cand_valid, r0, t0, init_particles),
                    (POINT_AXIS,) * 4 + (None, None, PARTICLE_AXIS), RESULT_SPECS)
    return to_result(outs, history)


def sharded_register(mesh, cfg: SteinICPConfig, source, src_valid, target,
                     tgt_valid, r0, t0, init_particles, history: bool = False):
    """Distributed `svn.register`: each point shard searches the replicated
    target for its own rows' stage-1 candidates by index
    (`knn.find_candidates` at the guess) and gathers them, then the
    mesh-parallel align. With history, (result, [iters,P,6])."""

    def body(coll, source_l, src_valid_l, target_r, tgt_valid_r, r0_l, t0_l, init_l):
        at_guess = geo.transform_points(r0_l, t0_l, source_l)
        idx, d2 = knn.find_candidates(cfg, at_guess, target_r, src_valid_l, tgt_valid_r)
        cand_pts, cand_valid = knn.gather_candidates(target_r, idx, d2)
        prep = shard_prep(cfg, source_l, src_valid_l, cand_pts, cand_valid)
        return _align_shard(coll, cfg, source_l, src_valid_l, prep, r0_l, t0_l,
                            init_l, history)

    outs = mesh.run(body, (source, src_valid, target, tgt_valid, r0, t0, init_particles),
                    (POINT_AXIS, POINT_AXIS, None, None, None, None, PARTICLE_AXIS),
                    RESULT_SPECS)
    return to_result(outs, history)
