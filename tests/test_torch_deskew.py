"""Per-point motion deskew and the sweeps that need it, against the JAX
package: `pointcloud.deskew` (masked rows, a degenerate time span),
`SyntheticWorld.scan_sweep` (to float32 rounding), and the raw staging
route that carries per-point times to the device (uncropped, in order, the
time as a 4th column), whose times are ignored without preprocess.deskew.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnicp_tpu.core import pointcloud as jpc
from svnicp_tpu.io import datasets as jdatasets
from svnicp_tpu_torch import config as tcfg_mod
from svnicp_tpu_torch.core import pointcloud as tpc
from svnicp_tpu_torch.io import datasets
from svnicp_tpu_torch.runtime import pipeline as tpl

torch.set_num_threads(2)


def _scan(rng, n):
    points = rng.normal(size=(n, 3)) * 20
    valid = rng.random(n) > 0.2
    ts = rng.uniform(3.0, 3.1, n)          # raw times, any scale
    ts[~valid] = rng.uniform(-50, 50, int((~valid).sum()))
    delta = np.array([0.3, -0.1, 0.02, 0.01, -0.02, 0.05])
    return points, valid, ts, delta


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_deskew_matches_jax(rng, dtype):
    """Times normalised over the valid rows only (the invalid rows carry
    times far outside them), invalid rows unchanged."""
    points, valid, ts, delta = (x.astype(dtype) if x.dtype != bool else x
                                for x in _scan(rng, 500))
    with jax.enable_x64(dtype == "float64"):
        want = np.asarray(jpc.deskew(jnp.asarray(points), jnp.asarray(valid),
                                     jnp.asarray(ts), jnp.asarray(delta)))
    got = tpc.deskew(*(torch.from_numpy(x) for x in (points, valid, ts, delta)))
    tol = 1e-5 if dtype == "float32" else 1e-12
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
    np.testing.assert_array_equal(got.numpy()[~valid], points[~valid])
    assert np.abs(got.numpy()[valid] - points[valid]).max() > 0.05


def test_deskew_degenerate_span_passes_through(rng):
    """All valid rows at one time (invalid rows elsewhere): nothing moves,
    as in the JAX package (ref: OdometryPipeline.cpp:418)."""
    points, valid, ts, delta = _scan(rng, 200)
    ts[valid] = 7.0
    with jax.enable_x64(True):
        want = np.asarray(jpc.deskew(jnp.asarray(points), jnp.asarray(valid),
                                     jnp.asarray(ts), jnp.asarray(delta)))
    got = tpc.deskew(*(torch.from_numpy(x) for x in (points, valid, ts, delta)))
    np.testing.assert_array_equal(got.numpy(), points)
    np.testing.assert_array_equal(want, points)


def test_scan_sweep_matches_jax():
    world_j = jdatasets.SyntheticWorld(extent=40.0, seed=3)
    world_t = datasets.SyntheticWorld(extent=40.0, seed=3)
    times, rots, trans = datasets.synthetic_trajectory(3, dt=0.1, speed=2.0, seed=3)
    rng_j, rng_t = np.random.default_rng(9), np.random.default_rng(9)
    for i in range(2):
        pj, tj, (rj, tj_mid) = world_j.scan_sweep(rng_j, rots[i], trans[i],
                                                  rots[i + 1], trans[i + 1],
                                                  n_points=3000)
        pt, tt, (rt, tt_mid) = world_t.scan_sweep(rng_t, rots[i], trans[i],
                                                  rots[i + 1], trans[i + 1],
                                                  n_points=3000)
        assert pt.dtype == tt.dtype == np.float32 and pt.shape == pj.shape
        np.testing.assert_array_equal(tt, tj)
        np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5)
        np.testing.assert_allclose(rt, rj, rtol=0, atol=1e-6)
        np.testing.assert_allclose(tt_mid, tj_mid, rtol=0, atol=1e-5)
        # the sweep is distorted: tau spans the sweep, the mid pose sits
        # between its ends
        assert tt.min() < 0.01 and tt.max() > 0.99
        assert np.linalg.norm(tt_mid - 0.5 * (trans[i] + trans[i + 1])) < 0.01


CFG = dict(
    icp=dict(method="svgd", particle_count=8, iterations=5, knn_count=8,
             source_capacity=128, target_capacity=2048, use_pallas=True),
    map=dict(capacity=4096),
    preprocess=dict(min_range=0.5, max_range=30.0, voxel_size=1.0, deskew=True,
                    raw_capacity=1024),
    dtype="float64",
)


def test_raw_staging_carries_times_uncropped():
    """With per-point times the first raw_capacity rows go up uncropped
    (points beyond max_range included), in their order, the time as a 4th
    column; without them the native crop packs 3 columns."""
    pipe = tpl.LIOPipeline(tcfg_mod.from_dict(CFG), device="cpu")
    rng = np.random.default_rng(4)
    points = (rng.normal(size=(1500, 3)) * 30).astype(np.float32)
    tau = rng.random(1500).astype(np.float32)
    rows, n, imu = pipe._pack_frame(0.0, points, tau)
    assert rows.shape == (1024, 4) and n == 1024 and imu.count == 0
    np.testing.assert_array_equal(rows[:, :3], points[:1024])
    np.testing.assert_array_equal(rows[:, 3], tau[:1024])
    short, n_short, _ = pipe._pack_frame(0.1, points[:100], tau[:100])
    assert n_short == 100 and not short[100:].any()
    cropped, n_crop, _ = pipe._pack_frame(0.2, points[:100])
    d = np.linalg.norm(points[:100], axis=1)
    assert cropped.shape == (1024, 3) and n_crop == int(((d > 0.5) & (d < 30)).sum())
    pts, valid, ts = pipe._upload(rows, n)
    assert ts is not None and torch.equal(ts, torch.from_numpy(rows[:, 3]).double())
    assert pipe._upload(cropped, n_crop)[2] is None


def test_times_without_deskew_are_carried_and_ignored():
    """preprocess.deskew off: feeding the sweeps' times (raw route, crop on
    the device) gives the trajectory of feeding none (native crop)."""
    cfg = tcfg_mod.from_dict(CFG)
    cfg = dataclasses.replace(cfg, preprocess=dataclasses.replace(cfg.preprocess,
                                                                  deskew=False))
    world = datasets.SyntheticWorld(extent=25.0, seed=2)
    times, rots, trans = datasets.synthetic_trajectory(5, dt=0.1, speed=2.0, seed=2)
    rng = np.random.default_rng(2)
    sweeps = [world.scan_sweep(rng, rots[i], trans[i], rots[i + 1], trans[i + 1],
                               n_points=800)[:2] for i in range(4)]
    draws = [np.random.default_rng(i).uniform(-0.01, 0.01, (8, 6)) for i in range(4)]
    trajs = []
    for with_times in (True, False):
        pipe = tpl.LIOPipeline(cfg, device="cpu")
        for t, (pts, tau), draw in zip(times, sweeps, draws):
            pipe.feed_scan(float(t), pts, timestamps=tau if with_times else None,
                           init_particles=draw)
        pipe.close()
        trajs.append(pipe.trajectory())
        assert all(o.align_ok for o in pipe.outputs)
    np.testing.assert_array_equal(trajs[0], trajs[1])
