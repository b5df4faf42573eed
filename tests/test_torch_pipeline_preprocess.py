"""The port's LIOPipeline on the raw-scan preprocessing routes against the
JAX package's, frame by frame.

A float64 run of both on the CPU over 5 frames of the JAX package's
`record_proxy` recipe (`chip_smoke.proxy_sequence`: motion-distorted HDL-64
raycast sweeps with their per-point times, every 15th azimuth column, a
noisy 100 Hz IMU fed before each scan), at cut-down versions of the two
configurations the routes exist for:
- configs/tpu_features.yaml: LOAM feature selection on the raw sweep as the
  source, deskew of the scan and of the selection, point-to-plane, the ESKF
  with the cold-start bootstrap (P=8, K=16);
- the same on range-image segmentation in place of the selection, with the
  ICP estimator;
- configs/subt_mrs_fast.yaml: host crop and stage-A downsample carrying the
  sweep times, the int16 upload, deskew of the stage-A cloud on the device,
  point-to-point, ICP (P=8, K=16, the grad-norm stop at 1e-2: at 1e-3
  frame 1 runs out all 100 iterations, over which float64 rounding
  differences between the two implementations grow chaotically), with and
  without stage-ahead.
The port replays the JAX package's particle draws (`init_particles`). Poses
agree to 1e-6 with identical iterations per frame; the features route's
Kalman gain is non-zero and agrees. Besides, the port restarted from the
converted JAX state after 3 frames matches the JAX package's 4th frame on
the host route (int16 rows with times).

The int16 upload puts the points on a 2^-8 m grid, where stage-1 scores
can tie exactly (`test_int16_grid_makes_exact_stage1_ties`). The port runs the
kernel route, which averages tied candidates as the JAX package's Pallas
kernels do; in float64 on the CPU the JAX package runs its XLA route
(Pallas' interpret mode refuses float64), which takes the first index. So
the full int16 run is held to 5e-4 with identical iterations, and the
same route without the int16 upload, where nothing ties, to 1e-6.
"""

import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnicp_tpu import config as jcfg_mod
from svnicp_tpu.runtime import pipeline as jpl
from svnicp_tpu_torch import config as tcfg_mod
from svnicp_tpu_torch import convert
from svnicp_tpu_torch.runtime import pipeline as tpl

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

torch.set_num_threads(2)

N_FRAMES = 5
ICP = dict(method="svn", residual="point_to_plane", particle_count=8,
           iterations=100, max_dist=3.0, knn_count=16, early_stop=True,
           convergence_metric="mean_delta", convergence_threshold=5e-3,
           prior_information=True, source_capacity=1024, target_capacity=8192,
           use_pallas=True)
MAP = dict(voxel_size=1.0, max_points_per_voxel=20, max_range=300.0,
           capacity=32768)
FEATURES = dict(
    icp=ICP, map=MAP,
    preprocess=dict(min_range=2.0, max_range=100.0, voxel_size=1.0,
                    deskew=True, feature_select=True, sensor_model="hdl64",
                    raw_capacity=16384),
    imu=dict(rot_rw=[0.0005817764, 0.0005817764, 0.0029088821],
             vel_rw=[0.8333333333] * 3, bg_std=[0.0000969627] * 3,
             ba_std=[0.005] * 3),
    lio=dict(estimator="kf", frame_gap_seconds=0.05, init_from_motion=True,
             cov_filter="none", use_const_cov=False,
             init_pos_std=[0.05] * 3, init_vel_std=[0.05] * 3,
             init_rot_std=[0.1] * 3),
    dtype="float64")
SEGMENTATION = dict(
    FEATURES,
    preprocess=dict(FEATURES["preprocess"], feature_select=False,
                    use_segmentation=True),
    lio=dict(estimator="icp", frame_gap_seconds=0.05))
SUBT_FAST = dict(
    icp=dict(ICP, residual="point_to_point", convergence_metric="grad_norm",
             convergence_threshold=1e-2, source_capacity=2048),
    map=dict(voxel_size=0.2, max_points_per_voxel=1, max_range=100.0,
             capacity=32768),
    preprocess=dict(min_range=0.5, max_range=60.0, voxel_size=0.2, deskew=True,
                    host_downsample=True, quantize_upload=True,
                    raw_capacity=16384),
    lio=dict(estimator="icp", frame_gap_seconds=0.05),
    dtype="float64")


def _frames():
    events, _, _ = chip_smoke.proxy_sequence(N_FRAMES, col_step=15)
    return chip_smoke.proxy_frames(events)


def _jax_state_fields(state) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(state)[0]
    return {".".join(p.name for p in path): np.asarray(leaf)
            for path, leaf in leaves}


def _jax_run(cfg_dict: dict) -> dict:
    """The JAX pipeline's trajectory, iterations, gains, particle draws and
    its state after 3 frames."""
    cfg = jcfg_mod.from_dict(cfg_dict)
    frames = _frames()
    with jax.enable_x64(True):
        pipe = jpl.LIOPipeline(cfg)
        state3 = None
        for i, (t, pts, imus, tau) in enumerate(frames):
            if i == 3:
                pipe.flush()
                state3 = _jax_state_fields(pipe.state)
            for sample in imus:
                pipe.feed_imu(*sample)
            pipe.feed_scan(t, pts, timestamps=tau)
        pipe.close()
        icp = cfg.icp
        lb = jnp.asarray(icp.init_lb, jnp.float64)
        ub = jnp.asarray(icp.init_ub, jnp.float64)
        key = jax.random.PRNGKey(cfg.seed)
        draws = [None]
        for _ in range(1, N_FRAMES):
            key, sub = jax.random.split(key)
            u = jax.random.uniform(sub, (icp.particle_count, 6), jnp.float64)
            draws.append(np.array(lb + (ub - lb) * u))
        return dict(traj=pipe.trajectory(), draws=draws, frames=frames,
                    iters=[int(o.icp_iterations) for o in pipe.outputs],
                    gains=[np.asarray(o.kf_gain) for o in pipe.outputs],
                    state3=state3)


def _port_run(want: dict, cfg_dict: dict, **top):
    cfg = tcfg_mod.from_dict(dict(cfg_dict, **top))
    pipe = tpl.LIOPipeline(cfg, device="cpu")
    for (t, pts, imus, tau), draw in zip(want["frames"], want["draws"]):
        for sample in imus:
            pipe.feed_imu(*sample)
        pipe.feed_scan(t, pts, timestamps=tau, init_particles=draw)
    pipe.close()
    return pipe


def _assert_same_run(pipe, want):
    assert [o.icp_iterations for o in pipe.outputs] == want["iters"]
    assert all(o.align_ok for o in pipe.outputs)
    assert max(want["iters"]) > 1
    np.testing.assert_allclose(pipe.trajectory(), want["traj"], rtol=0, atol=1e-6)


UNQUANTIZED = dict(SUBT_FAST, preprocess=dict(SUBT_FAST["preprocess"],
                                              quantize_upload=False))


@pytest.fixture(scope="module")
def subt_fast_run():
    return _jax_run(SUBT_FAST)


def test_features_route_with_kf_matches_jax_float64():
    want = _jax_run(FEATURES)
    pipe = _port_run(want, FEATURES)
    _assert_same_run(pipe, want)
    counts = [o.feature_counts for o in pipe.outputs[1:]]
    assert all(int(c[0] + c[1]) > 20 for c in counts), counts
    for o, g in zip(pipe.outputs, want["gains"]):
        np.testing.assert_allclose(o.kf_gain.numpy(), g, rtol=1e-5, atol=1e-9)
    assert float(pipe.outputs[1].kf_gain.abs().max()) > 0.0


def test_segmentation_route_matches_jax_float64():
    want = _jax_run(SEGMENTATION)
    _assert_same_run(_port_run(want, SEGMENTATION), want)


@pytest.mark.parametrize("stage_ahead", [False, True])
def test_host_route_with_times_matches_jax_float64(stage_ahead):
    want = _jax_run(UNQUANTIZED)
    _assert_same_run(_port_run(want, UNQUANTIZED, stage_ahead=stage_ahead), want)


@pytest.mark.parametrize("stage_ahead", [False, True])
def test_host_route_with_times_and_int16_matches_jax_float64(subt_fast_run,
                                                            stage_ahead):
    pipe = _port_run(subt_fast_run, SUBT_FAST, stage_ahead=stage_ahead)
    assert [o.icp_iterations for o in pipe.outputs] == subt_fast_run["iters"]
    assert all(o.align_ok for o in pipe.outputs)
    np.testing.assert_allclose(pipe.trajectory(), subt_fast_run["traj"],
                               rtol=0, atol=5e-4)


def test_restart_from_converted_jax_state_on_the_host_route(subt_fast_run):
    """state_from_numpy(JAX state after 3 frames) + frame 4 staged by the
    host route (int16 stage-A rows with their times) == JAX's frame 4."""
    want = subt_fast_run
    cfg = tcfg_mod.from_dict(SUBT_FAST)
    state = convert.state_from_numpy(want["state3"], "cpu")
    assert state.frame_idx == 3
    pipe = tpl.LIOPipeline(cfg, device="cpu")
    t3, pts, _, tau = want["frames"][3]
    ds_buf, n_map = pipe._stage_scan_pre_untimed(pts, tau)
    pipe.close()
    assert ds_buf.dtype == np.int16 and ds_buf.shape[1] == 4
    _, out = tpl.odometry_step_pre(cfg, state, ds_buf, n_map,
                                   torch.tensor(t3, dtype=torch.float64),
                                   init_particles=want["draws"][3])
    assert out.icp_iterations == want["iters"][3]
    np.testing.assert_allclose(out.pose_t.numpy(), want["traj"][3, :3, 3],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.pose_r.numpy(), want["traj"][3, :3, :3],
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("quantized", [True, False])
def test_int16_grid_makes_exact_stage1_ties(quantized):
    """Why the int16 run is held to 5e-4: frame 1's stage-A cloud against
    the bootstrap map (both at the identity guess) has stage-1 slots whose
    two best targets score exactly alike on the 2^-8 m grid, and none
    without it."""
    from svnicp_tpu_torch.core import pointcloud as pc
    from svnicp_tpu_torch.core import voxmap
    from svnicp_tpu_torch.kernels import knn

    cfg_dict = SUBT_FAST if quantized else UNQUANTIZED
    cfg = tcfg_mod.from_dict(cfg_dict)
    frames = _frames()
    pipe = tpl.LIOPipeline(cfg, device="cpu")
    pipe.feed_scan(frames[0][0], frames[0][1], timestamps=frames[0][3])
    _, pts, _, tau = frames[1]
    ds_buf, n_map = pipe._stage_scan_pre_untimed(pts, tau)
    state = pipe.state
    pipe.close()
    buf = tpl.dequantize(torch.from_numpy(ds_buf), torch.float64)
    to_map = pc.PaddedCloud(buf[:, :3], torch.arange(len(buf)) < n_map)
    src = pc.downsample_uniform(to_map, 1.5 * cfg.preprocess.voxel_size,
                                cfg.icp.source_capacity)
    tgt, _ = voxmap.query_radius(state.vmap, state.pose_t,
                                 cfg.preprocess.max_range + 10.0,
                                 cfg.icp.target_capacity)
    score, _ = knn.group_scores(src.points, tgt.points, tgt.valid, cfg.icp.knn_count)
    two = torch.topk(score, 2, dim=-1, largest=False).values
    live = torch.isfinite(two[..., 0]) & src.valid[:, None]
    ties = int(((two[..., 0] == two[..., 1]) & live).sum())
    print(f"exact stage-1 ties: {ties} of {int(live.sum())} slots")
    assert (ties > 0) if quantized else (ties == 0)
