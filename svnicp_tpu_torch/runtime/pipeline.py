"""The odometry pipeline: one step per LiDAR frame and a host driver.

Port of `svnicp_tpu/runtime/pipeline.py` for both estimators: the
constant-velocity ICP estimator and the error-state Kalman filter. A frame:
in KF mode propagate the ESKF over the frame's IMU window; derive the
stage-B source cloud on the device (`pointcloud.downsample_uniform` of the
host's stage-A cloud, deskewed first when it carries sweep times; or from
the raw scan: LOAM feature selection or range-image segmentation, deskew,
crop and both stages);
predict the pose (constant velocity, or the ESKF's nav pose); draw a fresh
particle prior (the uniform box, or with `adaptive_prior` a Gaussian from
the last two variances); cut the local map (`voxmap.query_radius`) and
register by the configured method (`svn.register`, `svgd.register` or
`icp_svd.register`: stage-1 candidates, then the align loop, on the kernel
route or the XLA route as `use_pallas` says), or with SVN's
`candidate_method: voxel` take the candidates from the map's voxels
(`voxmap.voxel_candidates`) and align; with `save_particles` SVN also
returns its particle stack per iteration; contain failures; push the
variance rings; compose the pose (ICP) or fuse the ensemble mean and
covariance into the ESKF (KF); insert the scan into the map.

With a device mesh (`cfg.sharding`, `parallel/`) the registration runs
mesh-parallel, as the JAX step does: with `map.sharded` the map lives in
key-range blocks over the point axis, candidates come from a ring over the
blocks and inserts go to the owning block
(`parallel/voxmap_sharded.py`); otherwise the map stays whole and each
point shard searches the local map by index (`parallel/sharding.py`). The
mesh branch comes before the SVGD, SVD and voxel-candidate branches, so a
mesh runs the sharded SVN math whatever `icp.method` says.

The state is a NamedTuple of tensors plus a few host values (frame index,
ring fill count, the particle generator); steps return a new state and
leave the old one intact except for the generator, which advances. Where
the JAX step selects with `where(align_ok, ...)` on the device, this one
reads `align_ok` on the host (the align loop reads it once a round of
its passes anyway) and branches. A per-frame step returns a FrameOutput of tensors on the
device. With `dispatch_batch` > 1 the driver stages F frames, uploads them
with one copy, runs them through the same per-frame step in order
(`odometry_steps_packed`, `odometry_steps_packed_pre`) and returns their
small fields packed (`runtime/packing.py`), read back with one copy per
batch and served by `HostFrameOutput`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from svnicp_tpu_torch.config import PipelineConfig
from svnicp_tpu_torch.core import eskf as eskf_mod
from svnicp_tpu_torch.core import features
from svnicp_tpu_torch.core import geometry as geo
from svnicp_tpu_torch.core import imu as imu_mod
from svnicp_tpu_torch.core import pointcloud as pc
from svnicp_tpu_torch.core import segmentation as seg
from svnicp_tpu_torch.core import icp_svd, smoother, svgd, svn, voxmap
from svnicp_tpu_torch.device import resolve_device
from svnicp_tpu_torch.kernels import eskf as eskf_kernel
from svnicp_tpu_torch.runtime import packing, profiling
from svnicp_tpu_torch.runtime.ingest import ImuWindow, IngestDriver
from svnicp_tpu_torch.runtime.posegraph import PoseGraph
from svnicp_tpu_torch.runtime.posegraph_driver import PoseGraphDriver
from svnicp_tpu_torch.runtime.profiling import StageTimer, span


class OdometryState(NamedTuple):
    """Everything that persists across frames."""

    vmap: voxmap.VoxelMap
    eskf: eskf_mod.ESKFState
    pose_r: torch.Tensor       # [3,3] latest pose (T_{k-1})
    pose_t: torch.Tensor       # [3]
    prev_r: torch.Tensor       # [3,3] T_{k-2} (constant-velocity prediction)
    prev_t: torch.Tensor       # [3]
    pose_time: torch.Tensor    # scalar: stamp of T_{k-1}
    prev_time: torch.Tensor    # scalar: stamp of T_{k-2}
    rings: smoother.VarianceRings
    rng: torch.Generator       # per-frame particle draws
    frame_idx: int
    split_keys: torch.Tensor   # [S-1] int32 map-block key boundaries with
                               # map.sharded over S point shards, else [0]


class FrameOutput(NamedTuple):
    """Per-frame observables (the reference's 13 topics,
    OdometryPipeline.cpp:89-103)."""

    pose_r: torch.Tensor
    pose_t: torch.Tensor
    guess_r: torch.Tensor      # prediction before the ICP update
    guess_t: torch.Tensor
    velocity: torch.Tensor
    particles: torch.Tensor    # [P,6] final local particles
    weights: torch.Tensor      # [P]
    var_icp: torch.Tensor      # [6] raw ICP variance
    var_mean: torch.Tensor     # [6] mean-window filtered
    var_max_sliding: torch.Tensor
    var_random_walk: torch.Tensor
    cov: torch.Tensor          # [6,6]
    icp_iterations: int
    icp_grad_norm: torch.Tensor
    align_ok: bool
    map_points: torch.Tensor
    map_dropped: torch.Tensor
    target_overflow: torch.Tensor
    imu_dropped: int
    kf_gain: torch.Tensor      # [15,6] last Kalman gain (zeros in ICP mode)
    kf_cov_diag: torch.Tensor  # [15]
    history: torch.Tensor      # [iterations,P,6] with save_particles (SVN), else [0,P,6]
    # (n_edge, n_planar, n_ground) of preprocess.feature_select, else None
    feature_counts: torch.Tensor | None = None


def _dtype(cfg: PipelineConfig) -> torch.dtype:
    return {"float32": torch.float32, "float64": torch.float64}[cfg.dtype]


def _map_shards(cfg: PipelineConfig) -> int:
    return cfg.sharding.point_axis if cfg.map.sharded else 1


def init_state(cfg: PipelineConfig, device) -> OdometryState:
    dtype = _dtype(cfg)
    s = _map_shards(cfg)
    if s > 1:
        from svnicp_tpu_torch.parallel import voxmap_sharded as vms

        if cfg.map.capacity % s:
            raise ValueError(
                f"map.capacity ({cfg.map.capacity}) must divide evenly over "
                f"{s} point shards for map.sharded")
        split_keys = vms.uniform_split_keys(s, device)
    else:
        split_keys = torch.zeros((0,), dtype=torch.int32, device=device)
    eye = torch.eye(3, dtype=dtype, device=device)
    zero3 = torch.zeros(3, dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    rng = torch.Generator(device=device)
    rng.manual_seed(cfg.seed)
    return OdometryState(
        vmap=voxmap.create(cfg.map.capacity, dtype, device),
        eskf=eskf_mod.create(cfg.lio, cfg.imu, dtype, device),
        pose_r=eye, pose_t=zero3, prev_r=eye.clone(), prev_t=zero3.clone(),
        pose_time=zero, prev_time=zero.clone(),
        rings=smoother.create(dtype=dtype, device=device),
        rng=rng, frame_idx=0, split_keys=split_keys)


def _imu_scan_predict(ekf: eskf_mod.ESKFState, imu: ImuWindow | None, noise,
                     textbook_phi: bool = False) -> eskf_mod.ESKFState:
    """ESKF predict over the window's valid samples, each the finish sample
    of one interval; the previous sample starts as the window's first
    sample itself (the JAX package's `_imu_scan_predict`, whose scan over
    all padded slots leaves the state unchanged at invalid ones). A state
    on the card propagates in one launch of F1 (`kernels/eskf.propagate`),
    elsewhere by `eskf.predict` per sample (`propagate_plain`)."""
    if imu is None or imu.count == 0:
        return ekf
    with span("svnicp.filter.predict", on=ekf.cov):
        with span("svnicp.upload"):
            rows = torch.as_tensor(imu.buf[:imu.count]).to(device=ekf.cov.device,
                                                           dtype=ekf.cov.dtype)
        profiling.count("svnicp.imu_samples", imu.count)
        if rows.is_cuda:
            profiling.count("svnicp.filter.kernel_windows", 1)
            return eskf_kernel.propagate(ekf, rows, noise, textbook_phi)
        return eskf_kernel.propagate_plain(ekf, rows, noise, textbook_phi)


def _predict_pose(cfg: PipelineConfig, state: OdometryState, time: torch.Tensor):
    """Initial guess: the ESKF's nav pose in KF mode (ref: ESEKF.cpp:68),
    else constant-velocity extrapolation of the last two poses
    (ref: OdometryPipeline.cpp:706-737), inside the layer span
    `svnicp.predict`."""
    if cfg.lio.estimator == "kf":
        return state.eskf.nav.r, state.eskf.nav.t
    with span("svnicp.predict", on=state.pose_t):
        rd, td = geo.transform_compose(
            *geo.transform_inverse(state.prev_r, state.prev_t),
            state.pose_r, state.pose_t)
        xi = geo.se3_log(rd, td)
        dt_hist = state.pose_time - state.prev_time
        ratio = torch.where(dt_hist > 0,
                            (time - state.pose_time) / dt_hist.clamp_min(1e-9),
                            torch.zeros_like(dt_hist))
        xi = ratio * xi if state.frame_idx >= 2 else torch.zeros_like(xi)
        ri, ti = geo.se3_exp(xi)
        return geo.transform_compose(state.pose_r, state.pose_t, ri, ti)


def _deskew_motion(state: OdometryState) -> torch.Tensor:
    """The motion deskew undoes: log(T_{k-2}^-1 T_{k-1}), zero before frame 2
    (ref: OdometryPipeline.cpp:425-432)."""
    if state.frame_idx < 2:
        return state.pose_t.new_zeros(6)
    return geo.se3_log(*geo.transform_compose(
        *geo.transform_inverse(state.prev_r, state.prev_t),
        state.pose_r, state.pose_t))


def _segment(cfg: PipelineConfig, points, valid, timestamps):
    """preprocess.use_segmentation: the segmented cloud -> (points, valid,
    timestamps), the times carried through the projection when deskewing."""
    pp = cfg.preprocess
    sensor = seg.SENSORS[pp.sensor_model]
    if pp.deskew and timestamps is not None:
        cloud, timestamps = seg.segment_cloud(points, valid, sensor,
                                              pp.raw_capacity, timestamps=timestamps)
    else:
        cloud = seg.segment_cloud(points, valid, sensor, pp.raw_capacity)
    return cloud.points, cloud.valid, timestamps


def selection_options(cfg: PipelineConfig) -> dict:
    """The keywords of `features.select_features` that the config sets."""
    pp = cfg.preprocess
    return dict(
        sensor=seg.SENSORS[pp.sensor_model], capacity=cfg.icp.source_capacity,
        max_range=pp.max_range, sectors=pp.feature_sectors,
        edge_k=pp.feature_edge_per_sector, planar_k=pp.feature_planar_per_sector,
        ground_cap=pp.feature_ground_cap, edge_threshold=pp.feature_edge_threshold,
        planar_threshold=pp.feature_planar_threshold,
        occlusion_threshold=pp.feature_occlusion_threshold)


def select_features(cfg: PipelineConfig, points, valid, timestamps=None
                    ) -> features.SelectedFeatures:
    """preprocess.feature_select: the configured LOAM selection of a raw
    sweep, `source_capacity` picks at most (times zero when absent)."""
    ts = points.new_zeros(points.shape[0]) if timestamps is None else timestamps
    return features.select_features(points, valid, ts, **selection_options(cfg))


def _preprocess(cfg: PipelineConfig, state: OdometryState, points, valid,
                timestamps=None):
    """The raw route's preprocessing on the device, in the JAX package's
    order (ref: OdometryPipeline.cpp:549-560) -> (cropped, to_map, source,
    selected features or None):
    - with preprocess.feature_select, LOAM features selected on the raw
      (skewed) sweep, which become the source;
    - with preprocess.use_segmentation, the segmented cloud replaces the
      scan;
    - with preprocess.deskew and per-point times, the scan and, apart, the
      selection (with its own times and validity) deskewed;
    - crop; to_map the 0.5-voxel downsample; the source the 1.5-voxel
      downsample of to_map, or the cropped selection."""
    pp = cfg.preprocess
    sel = None
    if pp.feature_select:
        sel = select_features(cfg, points, valid, timestamps)
    if pp.use_segmentation:
        points, valid, timestamps = _segment(cfg, points, valid, timestamps)
    if pp.deskew and timestamps is not None:
        delta_xi = _deskew_motion(state)
        points = pc.deskew(points, valid, timestamps, delta_xi)
        if sel is not None:
            sel = sel._replace(points=pc.deskew(sel.points, sel.valid,
                                                sel.timestamps, delta_xi))
    cropped = pc.crop(pc.PaddedCloud(points, valid), pp.min_range, pp.max_range)
    to_map = pc.downsample_uniform(cropped, 0.5 * pp.voxel_size,
                                   cfg.icp.source_capacity * 2)
    if sel is not None:
        source = pc.crop(features.as_cloud(sel), pp.min_range, pp.max_range)
    else:
        source = pc.downsample_uniform(to_map, 1.5 * pp.voxel_size,
                                       cfg.icp.source_capacity)
    return cropped, to_map, source, sel


def _zeros_output(cfg, state, guess_r, guess_t, map_points, map_dropped,
                  imu_dropped: int) -> FrameOutput:
    p = cfg.icp.particle_count
    kw = dict(dtype=guess_t.dtype, device=guess_t.device)
    zero6 = torch.zeros(6, **kw)
    return FrameOutput(
        pose_r=guess_r, pose_t=guess_t, guess_r=guess_r, guess_t=guess_t,
        velocity=state.eskf.nav.v, particles=torch.zeros((p, 6), **kw),
        weights=torch.full((p,), 1.0 / p, **kw), var_icp=zero6,
        var_mean=zero6, var_max_sliding=zero6, var_random_walk=zero6,
        cov=1e-4 * torch.eye(6, **kw), icp_iterations=0,
        icp_grad_norm=torch.zeros((), **kw), align_ok=True,
        map_points=map_points, map_dropped=map_dropped,
        target_overflow=torch.zeros((), dtype=torch.int64, device=guess_t.device),
        imu_dropped=imu_dropped, kf_gain=state.eskf.gain,
        kf_cov_diag=torch.diagonal(state.eskf.cov),
        history=torch.zeros((cfg.icp.iterations if cfg.save_particles else 0,
                             p, 6), **kw))


def _insert(cfg: PipelineConfig, state: OdometryState, cloud, pose_r, pose_t,
            mesh=None):
    """The map insert: the ordinary one, or with a mesh and map.sharded the
    key-range block insert (`voxmap_sharded.sharded_insert`)."""
    m = cfg.map
    with span("svnicp.map.insert", on=pose_t):
        if mesh is not None and m.sharded:
            from svnicp_tpu_torch.parallel import voxmap_sharded as vms

            return vms.sharded_insert(mesh, state.vmap, cloud, pose_r, pose_t,
                                      m.voxel_size, m.max_points_per_voxel,
                                      m.max_range, split_keys=state.split_keys)
        return voxmap.insert(state.vmap, cloud, pose_r, pose_t, m.voxel_size,
                             m.max_points_per_voxel, m.max_range)


def bootstrap(cfg: PipelineConfig, state: OdometryState, points, valid,
              time: torch.Tensor, imu: ImuWindow | None = None,
              timestamps=None, mesh=None):
    """First frame: crop the raw (or segmented) scan and seed the map at the
    predicted pose, no alignment and no IMU predict: the frame's window is
    consumed unused (ref: OdometryPipeline.cpp:583-591). Deskew is the
    identity before frame 2, and a feature selection would go unused."""
    pp = cfg.preprocess
    if pp.use_segmentation:
        points, valid, _ = _segment(cfg, points, valid, timestamps)
    cropped = pc.crop(pc.PaddedCloud(points, valid), pp.min_range, pp.max_range)
    guess_r, guess_t = _predict_pose(cfg, state, time)
    new_map, dropped = _insert(cfg, state, cropped, guess_r, guess_t, mesh)
    state = state._replace(
        vmap=new_map, prev_r=state.pose_r, prev_t=state.pose_t,
        prev_time=state.pose_time, pose_r=guess_r, pose_t=guess_t,
        pose_time=time, frame_idx=state.frame_idx + 1)
    return state, _zeros_output(cfg, state, guess_r, guess_t, new_map.count(),
                                dropped, _dropped(imu))


def _dropped(imu: ImuWindow | None) -> int:
    return 0 if imu is None else imu.dropped


def _kf_update(cfg: PipelineConfig, state: OdometryState, result, raw_var,
               scaled_var, var_mean, var_max, align_ok: bool, guess_r, guess_t,
               time: torch.Tensor) -> eskf_mod.ESKFState:
    """Fuse the ensemble into the ESKF (the KF branch of the JAX step): the
    measurement covariance, the update kept only for an aligned frame, and
    the `init_from_motion` bootstrap on frame 1."""
    lio = cfg.lio
    dtype, device = raw_var.dtype, raw_var.device
    if not align_ok:
        return state.eskf
    if lio.use_const_cov or cfg.icp.particle_count == 1:
        ct, cr = lio.const_cov
        meas_var = torch.tensor([ct, ct, ct, cr, cr, cr], dtype=dtype, device=device)
    elif lio.cov_filter == "mean":
        # the mean ring holds raw variances: scale after the mean
        meas_var = var_mean * torch.tensor(lio.icp_cov_scales, dtype=dtype,
                                           device=device)
    elif lio.cov_filter == "max_sliding_window":
        meas_var = var_max                  # the max ring holds scaled ones
    else:
        meas_var = scaled_var
    ekf = eskf_mod.update(state.eskf, torch.diag(meas_var), result.mean)
    if not (lio.init_from_motion and state.frame_idx == 1):
        return ekf
    # cold-start bootstrap: adopt the full ICP pose on the first aligned
    # frame when its correction shows motion outside the velocity prior
    tc = result.mean[:3]
    dt_f = torch.clamp_min(time - state.pose_time, 1e-3)
    vel_std = torch.tensor(lio.init_vel_std, dtype=dtype, device=device)
    with span("svnicp.sync.align_ok"):
        moved = bool(torch.linalg.vector_norm(tc)
                     > 3.0 * dt_f * torch.linalg.vector_norm(vel_std))
    if not moved:
        return ekf
    full_r, full_t = geo.transform_compose(guess_r, guess_t,
                                           geo.so3_exp(result.mean[3:]), tc)
    cov = ekf.cov.clone()
    cov[3:6, :] = 0.0
    cov[:, 3:6] = 0.0
    cov[3:6, 3:6] = torch.diag(2.0 * raw_var[:3].clamp_min(1e-6) / (dt_f * dt_f))
    return ekf._replace(
        nav=imu_mod.NavState(full_r, full_t, (full_t - state.pose_t) / dt_f),
        cov=cov)


def prior_particles(cfg: PipelineConfig, rings: smoother.VarianceRings,
                    uniform: torch.Tensor, normal: torch.Tensor | None
                    ) -> torch.Tensor:
    """The frame's particle prior [P,6] from raw draws uniform [P,6] in
    [0,1) and (with adaptive_prior) normal [P,6] (ref:
    OdometryPipeline.cpp:573, ICPUtils.cpp:45-75): the configured box;
    with adaptive_prior, once the rings hold two frames, a zero-mean
    Gaussian clamped at 3 sigma with variance the sum of the last two raw
    ICP variances (the reference's dead variance_prediction, :812-837,
    made live as in the JAX package)."""
    icp = cfg.icp
    kw = dict(dtype=uniform.dtype, device=uniform.device)
    lb = torch.tensor(icp.init_lb, **kw)
    ub = torch.tensor(icp.init_ub, **kw)
    if not icp.adaptive_prior or rings.count < 2:
        return lb + (ub - lb) * uniform
    wm = rings.mean_ring.shape[0]
    cov6 = (rings.mean_ring[(rings.count - 1) % wm]
            + rings.mean_ring[(rings.count - 2) % wm])
    std = torch.sqrt(cov6.clamp_min(1e-12))[None, :]
    return torch.clamp(normal * std, -3.0 * std, 3.0 * std)


def draw_particles(cfg: PipelineConfig, state: OdometryState) -> torch.Tensor:
    """The per-frame particle prior from the state's generator (zeros for a
    single particle)."""
    icp = cfg.icp
    kw = dict(dtype=state.pose_t.dtype, device=state.pose_t.device)
    if icp.particle_count == 1:
        return torch.zeros((1, 6), **kw)
    shape = (icp.particle_count, 6)
    u = torch.rand(shape, generator=state.rng, **kw)
    z = torch.randn(shape, generator=state.rng, **kw) if icp.adaptive_prior else None
    return prior_particles(cfg, state.rings, u, z)


def _register(cfg: PipelineConfig, state: OdometryState, source, guess_r,
              guess_t, init_particles, mesh=None):
    """The frame's registration by the configured method and candidate
    method, or mesh-parallel -> (AlignResult, target overflow, particle
    history or None)."""
    icp = cfg.icp
    hist_on = cfg.save_particles     # the config allows it for SVN only
    args = (source.points, source.valid)
    if mesh is not None and cfg.map.sharded:
        # the map in key-range blocks: ring-gathered candidates, the
        # mesh-parallel align; no radius query
        from svnicp_tpu_torch.parallel import voxmap_sharded as vms
        from svnicp_tpu_torch.parallel.mesh import POINT_AXIS

        if mesh.shape[POINT_AXIS] != cfg.sharding.point_axis:
            raise ValueError(
                f"map.sharded needs mesh point axis == cfg.sharding.point_axis "
                f"({cfg.sharding.point_axis}), got {mesh.shape[POINT_AXIS]}")
        out = vms.sharded_register_with_map(mesh, icp, *args, state.vmap, guess_r,
                                            guess_t, init_particles, history=hist_on)
        overflow = torch.zeros((), dtype=torch.int64, device=guess_t.device)
    elif icp.candidate_method == "voxel" and icp.method == "svn" and mesh is None:
        # candidates from the map's voxels around each point: no radius
        # query, no brute-force stage 1
        src_world = geo.transform_points(guess_r, guess_t, source.points)
        cand_pts, cand_valid = voxmap.voxel_candidates(
            state.vmap, src_world, source.valid, cfg.map.voxel_size,
            icp.voxel_candidate_cap)
        overflow = torch.zeros((), dtype=torch.int64, device=guess_t.device)
        align = svn.align_with_history if hist_on else svn.align
        out = align(icp, *args, cand_pts, cand_valid, guess_r, guess_t,
                    init_particles)
    else:
        with span("svnicp.map.query", on=guess_t):
            target, overflow = voxmap.query_radius(
                state.vmap, guess_t, cfg.preprocess.max_range + 10.0,
                icp.target_capacity)
        args += (target.points, target.valid, guess_r, guess_t, init_particles)
        if mesh is not None:
            from svnicp_tpu_torch.parallel import sharding

            out = sharding.sharded_register(mesh, icp, *args, history=hist_on)
        elif icp.method == "svgd":
            out = svgd.register(icp, *args, generator=state.rng)
        elif icp.method == "svd":
            out = icp_svd.register(icp, *args)
        elif hist_on:
            out = svn.register_with_history(icp, *args)
        else:
            out = svn.register(icp, *args)
    result, history = out if hist_on else (out, None)
    return result, overflow, history


def odometry_step(cfg: PipelineConfig, state: OdometryState, to_map, source,
                  time: torch.Tensor, init_particles=None,
                  skip_insert: bool = False, imu: ImuWindow | None = None,
                  mesh=None):
    """One frame from its preprocessed clouds -> (new state, FrameOutput).
    `init_particles` [P,6] replaces the frame's own particle draw (parity
    tests feed the JAX package's draws here); `imu` is the frame's IMU
    window, which KF mode propagates the filter over first; `mesh` (a
    `parallel` mesh) runs the registration, and with map.sharded the
    insert, mesh-parallel."""
    icp = cfg.icp
    dtype, device = state.pose_t.dtype, state.pose_t.device
    kf = cfg.lio.estimator == "kf"
    if kf:
        state = state._replace(eskf=_imu_scan_predict(
            state.eskf, imu, cfg.imu, cfg.lio.textbook_phi))
    guess_r, guess_t = _predict_pose(cfg, state, time)
    if init_particles is None:
        init_particles = draw_particles(cfg, state)
    else:
        init_particles = torch.as_tensor(init_particles, dtype=dtype,
                                         device=device)

    result, overflow, history = _register(cfg, state, source, guess_r, guess_t,
                                          init_particles, mesh)

    raw_var = result.var
    scaled_var = raw_var * torch.tensor(cfg.lio.icp_cov_scales, dtype=dtype,
                                        device=device)
    # failure containment (ref skips the frame, :599-601): a non-finite
    # result, a degenerate correspondence set (grad_norm stays +inf), or,
    # for SVN, a final iteration still at the trust-region cap (every
    # particle clipped: dragged, not converging) falls back to the
    # prediction and leaves the map and the variance rings untouched.
    # SVGD's grad_norm is an unclipped optimizer step with no such cap.
    with span("svnicp.sync.align_ok"):
        align_ok = bool(torch.isfinite(result.mean).all()
                        & torch.isfinite(result.var).all()
                        & torch.isfinite(result.grad_norm))
    if icp.method == "svn" and align_ok:
        with span("svnicp.sync.align_ok"):
            align_ok = bool(result.grad_norm < 0.999 * icp.max_dist)
    var_mean = smoother.mean_filtered(state.rings)
    rings = (smoother.push(state.rings, raw_var, scaled_var) if align_ok
             else state.rings)
    var_max = smoother.max_filtered(rings)
    if kf:
        with span("svnicp.filter.update", on=raw_var):
            ekf = _kf_update(cfg, state, result, raw_var, scaled_var, var_mean,
                             var_max, align_ok, guess_r, guess_t, time)
        pose_r, pose_t = ekf.nav.r, ekf.nav.t
        var_rw = eskf_mod.random_walk_variance(ekf)
    else:
        ekf = state.eskf
        # for SVGD, mean[3:] are ZYX Euler angles composed as an axis-angle
        # log: the reference's own conflation, kept as the JAX package does
        safe_mean = result.mean if align_ok else torch.zeros_like(result.mean)
        pose_r, pose_t = geo.transform_compose(
            guess_r, guess_t, geo.so3_exp(safe_mean[3:]), safe_mean[:3])
        var_rw = torch.zeros(6, dtype=dtype, device=device)

    do_insert = (align_ok and not skip_insert
                 and state.frame_idx % cfg.map.insert_every == 0)
    if do_insert:
        new_map, dropped = _insert(cfg, state, to_map, pose_r, pose_t, mesh)
    else:
        new_map = state.vmap
        dropped = torch.zeros((), dtype=torch.int64, device=device)

    new_state = OdometryState(
        vmap=new_map, eskf=ekf, pose_r=pose_r, pose_t=pose_t,
        prev_r=state.pose_r, prev_t=state.pose_t, pose_time=time,
        prev_time=state.pose_time, rings=rings, rng=state.rng,
        frame_idx=state.frame_idx + 1, split_keys=state.split_keys)
    out = FrameOutput(
        pose_r=pose_r, pose_t=pose_t, guess_r=guess_r, guess_t=guess_t,
        velocity=ekf.nav.v, particles=result.particles,
        weights=result.weights, var_icp=raw_var, var_mean=var_mean,
        var_max_sliding=var_max, var_random_walk=var_rw, cov=result.cov, icp_iterations=result.iterations,
        icp_grad_norm=result.grad_norm, align_ok=align_ok,
        map_points=new_map.count(), map_dropped=dropped,
        target_overflow=overflow, imu_dropped=_dropped(imu),
        kf_gain=ekf.gain, kf_cov_diag=torch.diagonal(ekf.cov),
        history=(torch.zeros((0, icp.particle_count, 6), dtype=dtype,
                             device=device) if history is None else history))
    return new_state, out


def dequantize(buf: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Rows in the working dtype; int16 rows (preprocess.quantize_upload)
    come off the 2^-8 m grid."""
    if buf.dtype == torch.int16:
        return buf.to(dtype) * 2.0 ** -8
    return buf.to(dtype)


def odometry_step_pre(cfg: PipelineConfig, state: OdometryState, ds_buf,
                      n_map: int, time: torch.Tensor, init_particles=None,
                      skip_insert: bool = False, imu: ImuWindow | None = None,
                      mesh=None):
    """One frame from a host-preprocessed cloud (the JAX package's
    `odometry_step_packed_pre`): ds_buf [2*source_capacity,3] holds the
    stage-A rows (int16 with quantize_upload); the stage-B source is
    derived on the device with the same selection the host would make. A
    4th column holds the rows' sweep times: with preprocess.deskew the
    stage-A cloud is deskewed with them first (normalised over these rows,
    not the scan's)."""
    device, dtype = state.pose_t.device, state.pose_t.dtype
    map_cap = 2 * cfg.icp.source_capacity
    buf = torch.as_tensor(ds_buf).to(device)
    with span("svnicp.preprocess", on=buf):
        buf = dequantize(buf, dtype)
        to_map = pc.PaddedCloud(buf[:map_cap, :3],
                                torch.arange(map_cap, device=device) < n_map)
        if cfg.preprocess.deskew and buf.shape[1] == 4:
            to_map = pc.PaddedCloud(
                pc.deskew(to_map.points, to_map.valid, buf[:map_cap, 3],
                          _deskew_motion(state)), to_map.valid)
        source = pc.downsample_uniform(to_map, 1.5 * cfg.preprocess.voxel_size,
                                       cfg.icp.source_capacity)
    return odometry_step(cfg, state, to_map, source, time, init_particles,
                         skip_insert, imu, mesh)


def raw_rows(buf: torch.Tensor, n: int, dtype: torch.dtype):
    """Raw staged rows on the device (int16 with quantize_upload) ->
    (points [cap,3], valid [cap], timestamps [cap] or None)."""
    buf = dequantize(buf, dtype)
    ts = buf[:, 3] if buf.shape[1] == 4 else None
    return buf[:, :3], torch.arange(buf.shape[0], device=buf.device) < n, ts


def odometry_step_raw(cfg: PipelineConfig, state: OdometryState, points,
                      valid, time, init_particles=None,
                      skip_insert: bool = False, imu: ImuWindow | None = None,
                      timestamps=None, mesh=None):
    """One frame from the raw padded scan (cropped on the host, or with
    per-point `timestamps` uncropped): preprocess on the device, then
    step."""
    with span("svnicp.preprocess", on=points):
        _, to_map, source, sel = _preprocess(cfg, state, points, valid, timestamps)
    state, out = odometry_step(cfg, state, to_map, source, time,
                               init_particles, skip_insert, imu, mesh)
    if sel is not None:
        out = out._replace(feature_counts=torch.stack(
            [sel.n_edge, sel.n_planar, sel.n_ground]))
    return state, out


class StagedFrame(NamedTuple):
    """One frame staged on the host for a batch."""

    rows: np.ndarray          # raw [raw_capacity,3|4] or stage-A [2*source_capacity,3|4]
    n: int                    # valid rows
    time: float
    imu: ImuWindow | None
    init_particles: object    # [P,6] or None: the frame's own draw
    skip_insert: bool
    preprocess_time: float    # host staging [s]


def upload_stacked(rows: list[np.ndarray], device) -> torch.Tensor:
    """F frames' staged rows -> one [F, ...] tensor on the device; on the
    card one host-to-device copy from pinned memory."""
    if torch.device(device).type == "cpu":
        return torch.from_numpy(np.stack(rows))
    host = torch.empty((len(rows), *rows[0].shape),
                       dtype=torch.from_numpy(rows[0][:0]).dtype, pin_memory=True)
    np.stack(rows, out=host.numpy())
    packing.copies["upload"] += 1
    return host.to(device, non_blocking=True)


def _run_staged(state, frames, step_one):
    dtype, device = state.pose_t.dtype, state.pose_t.device
    bufs = upload_stacked([f.rows for f in frames], device)
    outs = []
    for f, buf in zip(frames, bufs):
        time = torch.tensor(f.time, dtype=dtype, device=device)
        state, out = step_one(state, buf, f, time)
        outs.append(out)
    return state, packing.pack_outputs(outs)


def odometry_steps_packed(cfg: PipelineConfig, state: OdometryState,
                          frames: list[StagedFrame], mesh=None):
    """A batch of raw-staged frames (the JAX package's
    `odometry_steps_packed`) -> (state, PackedFrameOutput with a leading
    F axis): one upload of the F frames' rows, then `odometry_step_raw` on
    each in order, the small outputs packed into one buffer pair for one
    read-back. Unlike the JAX package's lax.scan the frames are F steps,
    not one program: the align loop reads the host once a round of its
    passes, so a batch saves the per-frame uploads and read-backs, nothing
    more."""
    dtype = _dtype(cfg)

    def one(st, buf, f, time):
        pts, valid, ts = raw_rows(buf, f.n, dtype)
        return odometry_step_raw(cfg, st, pts, valid, time, f.init_particles,
                                 f.skip_insert, f.imu, ts, mesh)

    return _run_staged(state, frames, one)


def odometry_steps_packed_pre(cfg: PipelineConfig, state: OdometryState,
                              frames: list[StagedFrame], mesh=None):
    """`odometry_steps_packed` for host-preprocessed frames (the JAX
    package's `odometry_steps_packed_pre`): `odometry_step_pre` on each."""

    def one(st, buf, f, time):
        return odometry_step_pre(cfg, st, buf, f.n, time, f.init_particles,
                                 f.skip_insert, f.imu, mesh)

    return _run_staged(state, frames, one)


class LIOPipeline(IngestDriver, PoseGraphDriver):
    """Host driver: scan staging, the frame-gap gate, dispatch and records
    (ref: OdometryPipeline.cpp:106-110, 449-658), and with
    `posegraph.enabled` the keyframe graph, loop closure and re-anchoring
    (`runtime/posegraph_driver.py`) after every frame.

    Runs on the card unless `device="cpu"` is passed; on a host without CUDA
    the default raises. With `stage_ahead` (and host_downsample, and no pose
    graph, which needs each frame's output before the next, and
    `dispatch_batch` 1), frame k's native staging overlaps frame k-1's
    dispatch and outputs lag by one frame. With `dispatch_batch` F > 1 (and
    no pose graph, which forces 1) frames after the bootstrap are staged
    and dispatched F at a time (`odometry_steps_packed*`), their outputs
    `HostFrameOutput`s. Call `flush()` (or `close()`) to drain either.

    With `cfg.sharding` over more than one shard the frames register on a
    ("particle", "point") mesh (`parallel/`), built over the visible devices
    of the pipeline's type (one shard per rank after
    `distributed.initialize`), or the prebuilt `mesh` given, whose shape
    must be cfg.sharding's (`sharding.make_mesh(p, q, devices=["cpu"] * n)`
    puts n shards on one device). With map.sharded the map rebalances after
    the bootstrap and every map.rebalance_every frames."""

    def __init__(self, cfg: PipelineConfig, device=None, imu_window: int = 256,
                 mesh=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.imu_window = imu_window
        self.mesh = self._make_mesh(mesh)
        self.rebalances = 0
        self.rebalance_drops = 0
        self.state = init_state(cfg, self.device)
        self._imu_times: list[float] = []
        self._imu_samples: list = []
        self._last_frame_time: float | None = None
        self._last_imu_time: float | None = None
        self._frames = 0
        self.outputs: list[FrameOutput] = []
        self.times: list[float] = []
        self.imu_dropped_total = 0
        # per-stage wall clocks; frame_timings[i] pairs with outputs[i]
        self.timer = StageTimer()
        self.frame_timings: list[dict] = []
        self._stage_pool = None
        self._pending: list = []
        self._batch: list[StagedFrame] = []
        self._batch_kind = None
        self.posegraph = None
        self._keyframe_clouds: list[tuple[np.ndarray, np.ndarray]] = []
        self.loop_closures: list[tuple[int, int]] = []
        self.reanchors = 0
        self.reanchors_rejected = 0
        self.loop_edges_pruned = 0
        # rows a sharded re-anchor drops; the replicated move never drops
        self.reanchor_drops = 0
        if cfg.posegraph.enabled:
            pg = cfg.posegraph
            self.posegraph = PoseGraph(
                keyframe_trans_threshold=pg.keyframe_trans_threshold,
                keyframe_rot_threshold=pg.keyframe_rot_threshold,
                loop_radius=pg.loop_radius,
                loop_min_separation=pg.loop_min_separation,
                cov_floor=pg.cov_floor, huber_delta=pg.huber_delta,
                device=self.device, host_dtype=_dtype(cfg))

    def _make_mesh(self, mesh):
        """The registration mesh of cfg.sharding (None for one shard), with
        the JAX package's divisibility checks."""
        from svnicp_tpu_torch.parallel import sharding
        from svnicp_tpu_torch.parallel.mesh import PARTICLE_AXIS, POINT_AXIS

        cfg, sh = self.cfg, self.cfg.sharding
        if sh.particle_axis * sh.point_axis == 1:
            if cfg.map.sharded:
                raise ValueError("map.sharded needs a device mesh: set "
                                 "sharding.point_axis (and optionally "
                                 "particle_axis) > 1")
            if mesh is not None:
                raise ValueError("a mesh was given but cfg.sharding has one shard")
            return None
        if cfg.icp.particle_count % sh.particle_axis:
            raise ValueError(f"particle_count ({cfg.icp.particle_count}) must "
                             f"divide over {sh.particle_axis} particle shards")
        if cfg.icp.source_capacity % sh.point_axis:
            raise ValueError(f"source_capacity ({cfg.icp.source_capacity}) must "
                             f"divide over {sh.point_axis} point shards")
        if mesh is None:
            return sharding.make_mesh(sh.particle_axis, sh.point_axis,
                                      kind=self.device.type)
        if (mesh.shape[PARTICLE_AXIS], mesh.shape[POINT_AXIS]) != (
                sh.particle_axis, sh.point_axis):
            raise ValueError(f"the mesh's shape {mesh.shape} is not cfg.sharding's "
                             f"({sh.particle_axis}, {sh.point_axis})")
        kinds = {d.type for d in getattr(mesh, "devices", [mesh.device])}
        if kinds != {self.device.type}:
            raise ValueError(f"the mesh's shards lie on {sorted(kinds)}, the "
                             f"pipeline on {self.device.type}")
        return mesh

    def _maybe_rebalance(self, force: bool = False) -> None:
        """The sharded map's occupancy rebalance every map.rebalance_every
        frames (a pass that changes nothing below the imbalance threshold,
        `voxmap_sharded.rebalance`); `force` skips the cadence: the one
        after the bootstrap must run, since the uniform initial split puts
        a real scene in one block."""
        if self.mesh is None or not self.cfg.map.sharded:
            return
        k = self.cfg.map.rebalance_every
        if not force and (k <= 0 or len(self.outputs) % k):
            return
        from svnicp_tpu_torch.parallel import voxmap_sharded as vms

        new_map, new_splits, dropped = vms.rebalance(
            self.mesh, self.state.vmap, self.state.split_keys,
            sample_per_shard=self.cfg.map.rebalance_sample)
        self.state = self.state._replace(vmap=new_map, split_keys=new_splits)
        self.rebalance_drops += int(dropped)
        self.rebalances += 1

    def _time(self, t: float) -> torch.Tensor:
        return torch.tensor(t, dtype=_dtype(self.cfg), device=self.device)

    def _skip_insert(self, frame_idx: int) -> bool:
        n = self.cfg.map.insert_every
        return n > 1 and frame_idx % n != 0

    def _upload(self, rows: np.ndarray, n: int):
        """Packed rows (int16 with quantize_upload) -> (points [cap,3],
        valid [cap], timestamps [cap] or None) on the device."""
        with span("svnicp.upload"):
            buf = torch.from_numpy(rows).to(self.device)
        return raw_rows(buf, n, _dtype(self.cfg))

    def feed_scan(self, t: float, points: np.ndarray, timestamps=None,
                  init_particles=None) -> FrameOutput | None:
        """Process one LiDAR scan [N,3], with optional per-point times [N]
        (any scale: deskew normalises them per scan); returns its
        FrameOutput, or None when the frame-gap gate drops it or stage-ahead
        or a batch holds it back (a filled batch returns its last frame's
        HostFrameOutput). The routing is the JAX package's: the host
        route (host_downsample, after the bootstrap frame, without
        segmentation or feature selection) takes a scan without times, or
        with times when deskewing (they ride with the stage-A rows); every
        other frame takes the raw route, where times without
        preprocess.deskew are carried and ignored."""
        if (self._last_frame_time is not None
                and t - self._last_frame_time < self.cfg.lio.frame_gap_seconds):
            return None
        with span("svnicp.frame", on=self.state.pose_t, frame=self._frames):
            return self._feed_scan(t, points, timestamps, init_particles)

    def _feed_scan(self, t, points, timestamps, init_particles):
        pp = self.cfg.preprocess
        host_ds = (pp.host_downsample and not pp.use_segmentation
                   and not pp.feature_select and self._frames > 0
                   and (timestamps is None or pp.deskew))
        ds_ts = timestamps if (host_ds and pp.deskew) else None
        if self._frames == 0:
            rows, n, imu = self._pack_frame(t, points, timestamps)
            with self.timer.span("dispatch"):
                pts, valid, ts = self._upload(rows, n)
                self.state, out = bootstrap(self.cfg, self.state, pts, valid,
                                            self._time(t), imu, ts, self.mesh)
            self._record_frame(t, out, points)
            self._maybe_rebalance(force=True)
            return out
        batch_n = self.cfg.dispatch_batch if self.posegraph is None else 1
        if host_ds and batch_n == 1 and self.cfg.stage_ahead and self.posegraph is None:
            return self._feed_scan_ahead(t, points, ds_ts, init_particles)
        if self._pending:
            self.flush()    # staging mode changed mid-stream: keep order
        if batch_n > 1:
            return self._feed_batch(t, points, host_ds, ds_ts, timestamps,
                                    init_particles, batch_n)
        if host_ds:
            ds_buf, n_map, imu = self._pack_frame_pre(t, points, ds_ts)
            out = self._dispatch_pre(t, ds_buf, n_map, imu, self._frames,
                                     init_particles)
        else:
            rows, n, imu = self._pack_frame(t, points, timestamps)
            with self.timer.span("dispatch"):
                pts, valid, ts = self._upload(rows, n)
                self.state, out = odometry_step_raw(
                    self.cfg, self.state, pts, valid, self._time(t),
                    init_particles, self._skip_insert(self._frames), imu, ts,
                    self.mesh)
        self._record_frame(t, out, points)
        return out

    def _feed_batch(self, t, points, host_ds, ds_ts, timestamps, init_particles,
                    batch_n: int):
        """Stage the frame into the batch (its IMU window and particles ride
        with it; frame count, last stamp and insert cadence advance now, as
        per-frame dispatch advances them) and dispatch a filled batch. A
        change of staging kind or row layout flushes the batch first."""
        if host_ds:
            rows, n, imu = self._pack_frame_pre(t, points, ds_ts)
        else:
            rows, n, imu = self._pack_frame(t, points, timestamps)
        kind = ("pre" if host_ds else "raw", rows.shape, rows.dtype)
        if self._batch and self._batch_kind != kind:
            self.flush()
        self._batch_kind = kind
        self._batch.append(StagedFrame(
            rows, n, t, imu, init_particles, self._skip_insert(self._frames),
            self.timer.last.get("preprocess", 0.0)))
        self._frames += 1
        self._last_frame_time = t
        if len(self._batch) < batch_n:
            return None
        return self._flush_batch()

    def _flush_batch(self, count: int | None = None):
        """Dispatch the first `count` (all) staged frames as one batch; the
        batch's wall time is spread evenly over its frames' timings."""
        items = self._batch[:count]
        del self._batch[:len(items)]
        steps = (odometry_steps_packed_pre if self._batch_kind[0] == "pre"
                 else odometry_steps_packed)
        with self.timer.span("dispatch"):
            self.state, packed = steps(self.cfg, self.state, items, self.mesh)
        per_frame = self.timer.last.get("dispatch", 0.0) / len(items)
        outs = packing.host_outputs(packed)
        for f, out in zip(items, outs):
            self.outputs.append(out)
            self.times.append(f.time)
            self.frame_timings.append({"preprocessing_time": f.preprocess_time,
                                       "steinicp_time": per_frame})
        return outs[-1]

    def _dispatch_pre(self, t, ds_buf, n_map, imu, frame_idx, init_particles):
        with self.timer.span("dispatch", frame=frame_idx):
            self.state, out = odometry_step_pre(
                self.cfg, self.state, ds_buf, n_map, self._time(t),
                init_particles, self._skip_insert(frame_idx), imu, self.mesh)
        return out

    def _record_frame(self, t: float, out: FrameOutput, points) -> None:
        """Keep the frame's output and stamps, rebalance the sharded map on
        its cadence; with the pose graph, update it from the frame's pose
        and the scan as it was fed."""
        self._frames += 1
        self._last_frame_time = t
        self.outputs.append(out)
        self.times.append(t)
        self.frame_timings.append({
            "preprocessing_time": self.timer.last.get("preprocess", 0.0),
            "steinicp_time": self.timer.last.get("dispatch", 0.0),
        })
        self._maybe_rebalance()
        if self.posegraph is not None:
            self._update_posegraph(t, out, points)

    def flush(self) -> FrameOutput | None:
        """Dispatch any staged-ahead frames, and a partly filled batch one
        frame at a time; returns the last output, or None when nothing was
        pending."""
        last = None
        while self._pending:
            last = self._dispatch_pending()
        while self._batch:
            last = self._flush_batch(1)
        return last

    def close(self) -> None:
        """Drain pending work and stop the stage-ahead worker thread."""
        self.flush()
        if self._stage_pool is not None:
            self._stage_pool.shutdown(wait=True)
            self._stage_pool = None

    def __del__(self):
        pool = getattr(self, "_stage_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)

    def trajectory(self) -> np.ndarray:
        """[N,4,4] homogeneous poses of all processed frames."""
        mats = np.tile(np.eye(4), (len(self.outputs), 1, 1))
        for m, o in zip(mats, self.outputs):
            m[:3, :3] = o.pose_r.cpu().numpy()
            m[:3, 3] = o.pose_t.cpu().numpy()
        return mats
