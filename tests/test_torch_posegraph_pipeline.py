"""The port's pose-graph pipeline (`runtime/posegraph_driver.py` mixed into
`LIOPipeline`) against the JAX package's:

- the JAX package's own closure scenario (`tests/test_checkpoint_posegraph.py`
  `TestReanchor`: a 6 m circle of 64 frames, scans capped at 9 m, sloppy
  4-iteration odometry, keyframes every 0.3 m, re-anchoring on) in
  float64 on the CPU, the JAX run's particle draws fed through
  `init_particles` (the loop verification draws its own from numpy, alike
  in both): the same loop closures, re-anchors and rejections; the
  trajectory equal within 1e-6 m up to the first closure (measured 1e-14:
  float64 rounding), and within 2e-2 m after it, where the graph's
  float32 solve (two implementations' roundings, ~1e-7 in the
  correction) moves map points across voxel edges and the sloppy
  odometry carries it on (measured 6e-3 m at the last frame); the graph
  after its first optimization within 1e-5 m and 1e-5 rad of the JAX
  package's (float32), and every node within 5e-3 m at the end;
- `_reanchor_state` on a converted JAX state moves the map's points, keys
  and mask bit for bit in float64, and the poses and the nav state within
  1e-12;
- a non-finite or oversized correction is rejected and counted, and leaves
  the map as it was;
- one loop verification (`_verify_loop`) on the kernel route (the plain
  B1-B3 on the CPU; P=8, 2,048-row keyframe clouds) against the JAX
  package's Pallas kernels in interpret mode, in float32 on a crisp scene
  (three planes): the relative pose within 1e-4, the covariance within
  1e-6 and the same acceptance.
"""

import dataclasses
import os
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import test_checkpoint_posegraph as jtest  # noqa: E402
from svnicp_tpu import config as jcfg  # noqa: E402
from svnicp_tpu.runtime import pipeline as jpl  # noqa: E402
from svnicp_tpu.runtime import posegraph_driver as jdrv  # noqa: E402
from svnicp_tpu_torch import config as tcfg  # noqa: E402
from svnicp_tpu_torch import convert  # noqa: E402
from svnicp_tpu_torch.core import geometry as tgeo  # noqa: E402
from svnicp_tpu_torch.io import datasets as tds  # noqa: E402
from svnicp_tpu_torch.runtime import pipeline as tpl  # noqa: E402
from svnicp_tpu_torch.runtime import posegraph_driver as tdrv  # noqa: E402

torch.set_num_threads(2)


def _circle_config():
    """TestReanchor's configuration (JAX's), in float64."""
    return jtest.small_cfg(
        icp=jcfg.SteinICPConfig(particle_count=8, iterations=4, knn_count=16,
                                max_dist=2.8, early_stop=False, source_capacity=1024,
                                target_capacity=8192),
        preprocess=jcfg.PreprocessConfig(min_range=1.0, max_range=9.0,
                                         raw_capacity=8192),
        posegraph=jcfg.PoseGraphConfig(
            enabled=True, keyframe_trans_threshold=0.3, keyframe_rot_threshold=10.0,
            loop_radius=2.5, loop_min_separation=20, loop_max_grad=0.05,
            loop_particles=8, loop_iterations=40, reanchor=True),
        dtype="float64")


def _record_optimize(graph, log):
    """Record the graph's nodes after each `optimize` call."""
    inner = graph.optimize

    def optimize(iterations=10):
        inner(iterations=iterations)
        log.append((np.stack(graph.nodes_r), np.stack(graph.nodes_t)))
    graph.optimize = optimize


@pytest.fixture(scope="module")
def circle():
    case = jtest.TestReanchor()
    trans, rots = case._circle()
    world = tds.SyntheticWorld(extent=14.0, n_walls=20, n_boxes=14, seed=4)
    rng = np.random.default_rng(9)
    scans = [world.scan_at(rng, rots[i], trans[i], n_points=2500, max_range=9.0,
                           noise=0.05) for i in range(len(trans))]
    cfg = _circle_config()
    j_opt, t_opt = [], []
    with jax.enable_x64(True):
        jp = jpl.LIOPipeline(cfg)
        _record_optimize(jp.posegraph, j_opt)
        for i, scan in enumerate(scans):
            jp.feed_scan(float(i) * 0.1, scan)
        icp = cfg.icp
        lb = jnp.asarray(icp.init_lb, jnp.float64)
        ub = jnp.asarray(icp.init_ub, jnp.float64)
        key = jax.random.PRNGKey(cfg.seed)
        draws = [None]
        for _ in range(1, len(scans)):
            key, sub = jax.random.split(key)
            u = jax.random.uniform(sub, (icp.particle_count, 6), jnp.float64)
            draws.append(np.array(lb + (ub - lb) * u))
        j_state = {".".join(p.name for p in path): np.asarray(leaf) for path, leaf in
                   jax.tree_util.tree_flatten_with_path(jp.state)[0]}
    tp = tpl.LIOPipeline(tcfg.from_dict(dataclasses.asdict(cfg)), device="cpu")
    _record_optimize(tp.posegraph, t_opt)
    for i, scan in enumerate(scans):
        tp.feed_scan(float(i) * 0.1, scan, init_particles=draws[i])
    return dict(jp=jp, tp=tp, j_opt=j_opt, t_opt=t_opt, j_state=j_state, cfg=cfg)


def test_circle_closes_and_reanchors_as_jax_float64(circle):
    jp, tp = circle["jp"], circle["tp"]
    assert len(tp.loop_closures) >= 1 and tp.reanchors >= 1
    assert tp.loop_closures == jp.loop_closures
    assert (tp.reanchors, tp.reanchors_rejected, tp.loop_edges_pruned) == (
        jp.reanchors, jp.reanchors_rejected, jp.loop_edges_pruned)
    assert len(tp.posegraph.nodes_r) == len(jp.posegraph.nodes_r)
    assert len(tp.posegraph.edges) == len(jp.posegraph.edges)
    assert all(o.align_ok for o in tp.outputs)
    # frames up to (and including) the one whose keyframe closed the loop
    n_before = int(round(jp.posegraph.stamps[tp.loop_closures[0][1]] / 0.1)) + 1
    assert 50 < n_before < len(tp.outputs), n_before
    jt, tt = jp.trajectory(), tp.trajectory()
    np.testing.assert_allclose(tt[:n_before - 1], jt[:n_before - 1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(tt, jt, rtol=0, atol=2e-2)


def test_circle_graph_matches_jax(circle):
    jp, tp = circle["jp"], circle["tp"]
    (jr, jt), (tr, tt) = circle["j_opt"][0], circle["t_opt"][0]
    assert len(circle["t_opt"]) == len(circle["j_opt"]) >= 1
    np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tr, jr, rtol=0, atol=1e-5)
    np.testing.assert_allclose(np.stack(tp.posegraph.nodes_t),
                               np.stack(jp.posegraph.nodes_t), rtol=0, atol=5e-3)
    np.testing.assert_allclose(tp.optimized_trajectory()[:, :3, :3],
                               jp.optimized_trajectory()[:, :3, :3], rtol=0, atol=5e-3)


def test_reanchor_state_moves_the_map_bit_for_bit(circle):
    """The JAX package's `_reanchor_state` and the port's on the same
    float64 state (the circle's final map) and correction."""
    cfg, fields = circle["cfg"], circle["j_state"]
    dr = tgeo.so3_exp(torch.tensor([0.01, -0.02, 0.3], dtype=torch.float64)).numpy()
    dt = np.array([0.7, -1.3, 0.05])
    with jax.enable_x64(True):
        jstate = circle["jp"].state
        want = jdrv._reanchor_state(cfg, jstate, jnp.asarray(dr), jnp.asarray(dt))
        want = jax.tree.map(np.asarray, want)
    state = convert.state_from_numpy(fields, "cpu")
    got = tdrv._reanchor_state(tcfg.from_dict(dataclasses.asdict(cfg)), state,
                               torch.from_numpy(dr), torch.from_numpy(dt))
    assert int(got.vmap.valid.sum()) > 1000
    np.testing.assert_array_equal(got.vmap.points.numpy(), want.vmap.points)
    np.testing.assert_array_equal(got.vmap.key.numpy(), want.vmap.key)
    np.testing.assert_array_equal(got.vmap.valid.numpy(), want.vmap.valid)
    for name in ("pose_r", "pose_t", "prev_r", "prev_t"):
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(want, name),
                                   rtol=0, atol=1e-12)
    for a, b in zip(got.eskf.nav, want.eskf.nav):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)


def _small_port(**pg):
    cfg = tcfg.from_dict(dataclasses.asdict(jtest.small_cfg(
        posegraph=jcfg.PoseGraphConfig(**pg))))
    return tpl.LIOPipeline(cfg, device="cpu")


def test_non_finite_correction_rejected():
    pipe = _small_port()
    before = pipe.state.vmap.key.clone()
    pipe.apply_reanchor(np.full((3, 3), np.nan), np.zeros(3))
    pipe.apply_reanchor(np.eye(3), np.array([np.inf, 0.0, 0.0]))
    assert (pipe.reanchors, pipe.reanchors_rejected) == (0, 2)
    assert torch.equal(pipe.state.vmap.key, before)


def test_oversized_correction_rejected():
    pipe = _small_port(max_reanchor_correction=2.0)
    pipe.apply_reanchor(np.eye(3), np.array([5.0, 0.0, 0.0]))
    assert (pipe.reanchors, pipe.reanchors_rejected) == (0, 1)
    pipe.apply_reanchor(tgeo.so3_exp(torch.tensor([0.0, 0.0, 1.2], dtype=torch.float64)
                                     ).numpy(), np.zeros(3))
    assert (pipe.reanchors, pipe.reanchors_rejected) == (0, 2)   # over 1 rad
    pipe.apply_reanchor(np.eye(3), np.array([0.5, 0.0, 0.0]))
    assert (pipe.reanchors, pipe.reanchors_rejected) == (1, 2)
    torch.testing.assert_close(pipe.state.pose_t, torch.tensor([0.5, 0.0, 0.0]))


def _planes(n, rng):
    u = rng.uniform(-6, 6, size=(n, 3))
    which = rng.integers(0, 3, n)
    u[which == 0, 2] = 0.0
    u[which == 1, 1] = 4.0
    u[which == 2, 0] = -3.0
    return u


def test_verify_loop_kernel_route_matches_pallas_interpret():
    """Keyframe 1 (a 2,600-point cloud of three planes, strided to 2,048
    rows as `PoseGraphDriver` stores it) against keyframe 0 (another 2,048
    samples of the planes), the graph's guess 3 cm and 0.01 rad off the
    true relative pose; float32, P=8, K=32, 40 iterations, on the kernel
    route on both sides."""
    rng = np.random.default_rng(21)
    xi = np.array([0.2, -0.1, 0.05, 0.0, 0.01, 0.03])
    rel_r, rel_t = (x.numpy() for x in tgeo.se3_exp(torch.from_numpy(xi)))
    cloud0 = _planes(2048, rng).astype(np.float32)
    # keyframe 1's cloud in its own frame: points p1 with rel (p1) = p0
    cloud1 = ((_planes(2600, rng) - rel_t) @ rel_r).astype(np.float32)
    guess_r = tgeo.so3_exp(torch.tensor([0.0, 0.0, 0.01], dtype=torch.float64)
                           ).numpy() @ rel_r
    guess_t = rel_t + np.array([0.03, -0.02, 0.01])
    icp = dict(method="svn", residual="point_to_plane", max_dist=3.0, lr=1.0,
               convergence_metric="mean_delta", convergence_threshold=1e-3,
               source_capacity=256, target_capacity=4096)
    pg = dict(enabled=True, loop_particles=8, loop_iterations=40, loop_knn=32,
              loop_use_pallas=True, loop_max_grad=0.05)
    results = []
    for mod, cfg_mod in ((jpl, jcfg), (tpl, tcfg)):
        cfg = cfg_mod.from_dict(dict(icp=icp, posegraph=pg,
                                     lio=dict(estimator="icp")))
        pipe = (mod.LIOPipeline(cfg) if mod is jpl
                else mod.LIOPipeline(cfg, device="cpu"))
        for stamp, (r, t), cloud in ((0.0, (np.eye(3), np.zeros(3)), cloud0),
                                     (0.1, (guess_r, guess_t), cloud1)):
            pipe.posegraph.nodes_r.append(r)
            pipe.posegraph.nodes_t.append(t)
            pts = cloud[:: max(len(cloud) // 2048, 1)][:2048]
            pad = np.zeros((2048, 3), np.float32)
            pad[: len(pts)] = pts
            pipe._keyframe_clouds.append((pad, np.arange(2048) < len(pts)))
        if mod is jpl:
            os.environ["SVNICP_PALLAS_INTERPRET"] = "1"
            try:
                with pltpu.force_tpu_interpret_mode():
                    results.append(pipe._verify_loop(0, 1))
            finally:
                del os.environ["SVNICP_PALLAS_INTERPRET"]
        else:
            results.append(pipe._verify_loop(0, 1))
    want, got = results
    assert want is not None and got is not None
    for a, b in zip(got, want):
        assert np.isfinite(a).all()
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[1], rel_t, atol=5e-3)
