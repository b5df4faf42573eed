"""The port's LIOPipeline on the point-to-point path against the JAX
package's, frame by frame: the error-state Kalman filter of
configs/geode_alpha.yaml and the ICP estimator of configs/subt_mrs.yaml.

A float64 run of both on the CPU, on 2500-point scans of
SyntheticWorld(extent=30, seed=1) along synthetic_trajectory(speed=1.0,
seed=1), with synthetic_imu fed through `feed_imu` before each scan, at a
cut-down geode configuration: KF, point-to-point, P=8, K=16 (padded to 24),
source capacity 256, target capacity 4096, map capacity 8192, geode's IMU
noise, extrinsic, grad-norm stop at 5e-4 and measurement settings. The
port cannot reproduce JAX's PRNG, so the JAX package's per-frame particle
draws are replayed through `init_particles`. Poses must agree to 1e-4
with identical per-frame iterations, and the filter's gain, covariance
diagonal and velocity must agree, for each measurement-covariance choice
(cov_filter none / mean / max_sliding_window, use_const_cov) and for the
init_from_motion bootstrap, over the three staging routes (raw,
host-preprocessed, stage-ahead). Besides:
- the ICP estimator on the same point-to-point path (subt_mrs's shape);
- a restart from the converted JAX KF state after 3 frames;
- the port's synthetic_imu and ramped trajectory equal the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnicp_tpu import config as jcfg_mod
from svnicp_tpu.core.imu import GRAVITY as JAX_GRAVITY
from svnicp_tpu.io import datasets as jdatasets
from svnicp_tpu.runtime import pipeline as jpl
from svnicp_tpu_torch import config as tcfg_mod
from svnicp_tpu_torch import convert
from svnicp_tpu_torch.core.imu import GRAVITY
from svnicp_tpu_torch.io import datasets as tdatasets
from svnicp_tpu_torch.runtime import pipeline as tpl

torch.set_num_threads(2)

N_FRAMES = 6
GEODE_LIO = dict(
    estimator="kf", frame_gap_seconds=0.0, cov_filter="none",
    extrinsic_t=[0.0961, -0.1338, 0.3032],
    extrinsic_R=[0.9999, 0.0049, 0.0153, -0.0050, 1.0000, 0.0021, -0.0153,
                 -0.0022, 0.9999])
CFG = dict(
    icp=dict(method="svn", residual="point_to_point", particle_count=8,
             iterations=100, max_dist=3.0, knn_count=16, early_stop=True,
             convergence_threshold=5e-4, source_capacity=256,
             target_capacity=4096, use_pallas=True),
    map=dict(voxel_size=1.0, max_points_per_voxel=20, max_range=300.0,
             capacity=8192),
    preprocess=dict(min_range=2.0, max_range=100.0, voxel_size=1.0,
                    raw_capacity=4096),
    imu=dict(rot_rw=[0.0005817764, 0.0005817764, 0.0029088821],
             vel_rw=[0.8333333333] * 3, bg_std=[0.0000969627] * 3,
             ba_std=[0.005] * 3),
    lio=GEODE_LIO,
    dtype="float64",
)
PRE = dict(CFG["preprocess"], host_downsample=True)


def _cfg(lio=None, preprocess=None, estimator=None, **top):
    lio = dict(GEODE_LIO, **(lio or {}))
    if estimator:
        lio["estimator"] = estimator
    return {**CFG, "lio": lio, "preprocess": preprocess or CFG["preprocess"],
            **top}


def _sequence():
    world = tdatasets.SyntheticWorld(extent=30.0, seed=1)
    times, rots, trans = tdatasets.synthetic_trajectory(N_FRAMES, dt=0.1,
                                                        speed=1.0, seed=1)
    rng = np.random.default_rng(1)
    scans = [world.scan_at(rng, rots[i], trans[i], n_points=2500)
             for i in range(N_FRAMES)]
    return times, scans, tdatasets.synthetic_imu(times, rots, trans, GRAVITY)


def _jax_state_fields(state) -> dict:
    leaves = jax.tree_util.tree_flatten_with_path(state)[0]
    return {".".join(p.name for p in path): np.asarray(leaf)
            for path, leaf in leaves}


def _jax_run(cfg_dict: dict) -> dict:
    """The JAX pipeline's trajectory, iterations, filter outputs, particle
    draws, and its state after 3 frames (taken before frame 4)."""
    cfg = jcfg_mod.from_dict(cfg_dict)
    times, scans, imu = _sequence()
    with jax.enable_x64(True):
        pipe = jpl.LIOPipeline(cfg)
        state3 = None
        for i in range(N_FRAMES):
            if i == 3:
                state3 = _jax_state_fields(pipe.state)
            pipe.feed_imu(*imu[i])
            pipe.feed_scan(float(times[i]), scans[i])
        pipe.close()
        outs = [{k: np.asarray(getattr(o, k)) for k in
                 ("kf_gain", "kf_cov_diag", "velocity", "var_random_walk")}
                for o in pipe.outputs]
        icp = cfg.icp
        lb = jnp.asarray(icp.init_lb, jnp.float64)
        ub = jnp.asarray(icp.init_ub, jnp.float64)
        key = jax.random.PRNGKey(cfg.seed)
        draws = [None]
        for _ in range(1, N_FRAMES):
            key, sub = jax.random.split(key)
            u = jax.random.uniform(sub, (icp.particle_count, 6), jnp.float64)
            draws.append(np.array(lb + (ub - lb) * u))
        return dict(traj=pipe.trajectory(), outs=outs, draws=draws,
                    iters=[int(o.icp_iterations) for o in pipe.outputs],
                    state3=state3, times=times, scans=scans, imu=imu)


def _port_run(want: dict, cfg_dict: dict):
    pipe = tpl.LIOPipeline(tcfg_mod.from_dict(cfg_dict), device="cpu")
    for i in range(N_FRAMES):
        pipe.feed_imu(*want["imu"][i])
        pipe.feed_scan(float(want["times"][i]), want["scans"][i],
                       init_particles=want["draws"][i])
    pipe.close()
    return pipe


def _assert_same_run(pipe, want):
    assert [o.icp_iterations for o in pipe.outputs] == want["iters"]
    assert all(o.align_ok for o in pipe.outputs)
    assert max(want["iters"]) > 1
    np.testing.assert_allclose(pipe.trajectory(), want["traj"], atol=1e-4)
    for o, w in zip(pipe.outputs, want["outs"]):
        np.testing.assert_allclose(o.velocity.numpy(), w["velocity"], atol=1e-5)
        np.testing.assert_allclose(o.kf_gain.numpy(), w["kf_gain"], rtol=1e-5,
                                   atol=1e-9)
        np.testing.assert_allclose(o.kf_cov_diag.numpy(), w["kf_cov_diag"],
                                   rtol=1e-5, atol=1e-12)
        np.testing.assert_allclose(o.var_random_walk.numpy(),
                                   w["var_random_walk"], rtol=1e-9, atol=1e-15)


@pytest.fixture(scope="module")
def kf_run():
    return _jax_run(CFG)


KF_CASES = {
    # (lio overrides, preprocess, extra top-level settings): the staging
    # route varies with the case so every route hands its window over
    "none_raw": ({}, None, {}),
    "mean_stage_ahead": ({"cov_filter": "mean"}, PRE, {"stage_ahead": True}),
    "max_sliding_window_pre": ({"cov_filter": "max_sliding_window"}, PRE, {}),
    "const_cov": ({"use_const_cov": True}, None, {}),
    "init_from_motion": ({"init_from_motion": True}, None, {}),
}


@pytest.mark.parametrize("case", list(KF_CASES))
def test_kf_trajectory_matches_jax_float64(kf_run, case):
    lio, pre, top = KF_CASES[case]
    cfg_dict = _cfg(lio, pre, **top)
    want = kf_run if case == "none_raw" else _jax_run(cfg_dict)
    pipe = _port_run(want, cfg_dict)
    _assert_same_run(pipe, want)
    # the update ran: a non-zero gain from the first aligned frame on
    assert float(pipe.outputs[1].kf_gain.abs().max()) > 0.0
    if case == "init_from_motion":
        # the bootstrap fired on frame 1: the filter's velocity is the
        # frame's motion (~1 m/s), where the plain filter starts near 0
        v1 = np.linalg.norm(pipe.outputs[1].velocity.numpy())
        v1_plain = np.linalg.norm(kf_run["outs"][1]["velocity"])
        assert v1 > 0.5 > v1_plain, (v1, v1_plain)


def test_icp_estimator_point_to_point_matches_jax_float64():
    """The ICP estimator on the point-to-point path: the shape of
    configs/subt_mrs.yaml (the IMU window is consumed and unused)."""
    cfg_dict = _cfg(estimator="icp")
    want = _jax_run(cfg_dict)
    pipe = _port_run(want, cfg_dict)
    assert [o.icp_iterations for o in pipe.outputs] == want["iters"]
    assert all(o.align_ok for o in pipe.outputs)
    np.testing.assert_allclose(pipe.trajectory(), want["traj"], atol=1e-4)
    for o in pipe.outputs:
        assert not o.kf_gain.any()


def test_restart_from_converted_jax_kf_state(kf_run):
    """state_from_numpy(JAX KF state after 3 frames) + frame 4 on the raw
    route with its IMU window == the JAX package's frame 4."""
    cfg = tcfg_mod.from_dict(CFG)
    state = convert.state_from_numpy(kf_run["state3"], "cpu")
    assert state.frame_idx == 3
    back = convert.state_to_numpy(state)
    for name, value in back.items():
        np.testing.assert_array_equal(value, kf_run["state3"][name], err_msg=name)
    pipe = tpl.LIOPipeline(cfg, device="cpu")
    for i in range(4):                 # the windows of frames 0-3 are consumed
        pipe.feed_imu(*kf_run["imu"][i])
        if i < 3:
            pipe._pack_imu(float(kf_run["times"][i]))
    rows, n, imu = pipe._pack_frame(float(kf_run["times"][3]), kf_run["scans"][3])
    assert imu.count == 1
    pts = torch.from_numpy(rows)
    t3 = torch.tensor(kf_run["times"][3], dtype=torch.float64)
    _, out = tpl.odometry_step_raw(cfg, state, pts, torch.arange(len(rows)) < n,
                                   t3, init_particles=kf_run["draws"][3], imu=imu)
    assert out.icp_iterations == kf_run["iters"][3]
    np.testing.assert_allclose(out.pose_t.numpy(), kf_run["traj"][3, :3, 3],
                               atol=1e-4)
    np.testing.assert_allclose(out.pose_r.numpy(), kf_run["traj"][3, :3, :3],
                               atol=1e-4)
    np.testing.assert_allclose(out.kf_gain.numpy(), kf_run["outs"][3]["kf_gain"],
                               rtol=1e-5, atol=1e-9)


def test_synthetic_imu_and_ramp_match_jax():
    jt = jdatasets.synthetic_trajectory(12, dt=0.1, speed=1.5, seed=7,
                                        ramp_seconds=1.0)
    tt = tdatasets.synthetic_trajectory(12, dt=0.1, speed=1.5, seed=7,
                                        ramp_seconds=1.0)
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(a, b)
    assert GRAVITY == JAX_GRAVITY
    for (tj, aj, gj), (t, a, g) in zip(jdatasets.synthetic_imu(*jt, JAX_GRAVITY),
                                       tdatasets.synthetic_imu(*tt, GRAVITY)):
        assert t == tj
        np.testing.assert_array_equal(a, aj)
        np.testing.assert_array_equal(g, gj)
