"""The port's public helpers and `raycast_scan` against the JAX package's.

- geometry: `interpolate_pose`, `matrix_to_euler_zyx` and
  `bmatrix_to_euler` (the JAX package's tests of them, and the same inputs
  through both packages, to 1e-12 in float64);
- `imu.interpolate`, `pointcloud.from_numpy`, `voxmap.get_all`: the same
  inputs through both;
- `svn.init_particles_uniform` / `init_particles_gaussian` take a
  `torch.Generator`, and the port cannot reproduce JAX's PRNG: shape,
  dtype and bounds, the same draws under one seed, and the moments of 4096
  draws against JAX's draws of the same size;
- `datasets.raycast_scan` (the full HDL-64 ray pattern): the port's scans
  equal the JAX package's bit for bit for the same surfaces, pose and rng.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from svnicp_tpu.core import geometry as jgeo
from svnicp_tpu.core import imu as jimu
from svnicp_tpu.core import pointcloud as jpc
from svnicp_tpu.core import svn as jsvn
from svnicp_tpu.core import voxmap as jvoxmap
from svnicp_tpu.io import datasets as jdatasets
from svnicp_tpu_torch.core import geometry as geo
from svnicp_tpu_torch.core import imu, pointcloud, svn, voxmap
from svnicp_tpu_torch.io import datasets

torch.set_num_threads(2)


def _rotations(rng, n):
    return Rotation.random(n, random_state=int(rng.integers(1 << 30))).as_matrix()


def test_interpolate_pose_endpoints_and_midpoint(rng):
    """The JAX package's test on the port: alpha 0 and 1 give the end poses,
    and 0.5 twice reaches the far pose."""
    r0, r1 = (torch.from_numpy(r) for r in _rotations(rng, 2))
    t0, t1 = (torch.from_numpy(rng.normal(size=3)) for _ in range(2))
    r, t = geo.interpolate_pose(r0, t0, r1, t1, 0.0)
    np.testing.assert_allclose(r.numpy(), r0.numpy(), atol=1e-12)
    np.testing.assert_allclose(t.numpy(), t0.numpy(), atol=1e-12)
    r, t = geo.interpolate_pose(r0, t0, r1, t1, 1.0)
    np.testing.assert_allclose(r.numpy(), r1.numpy(), atol=1e-9)
    np.testing.assert_allclose(t.numpy(), t1.numpy(), atol=1e-9)
    rm, tm = geo.interpolate_pose(r0, t0, r1, t1, 0.5)
    r2, t2 = geo.interpolate_pose(r0, t0, rm, tm, 2.0)
    np.testing.assert_allclose(r2.numpy(), r1.numpy(), atol=1e-9)
    np.testing.assert_allclose(t2.numpy(), t1.numpy(), atol=1e-9)


@pytest.mark.parametrize("alpha", [0.0, 0.25, 0.5, 0.9, 1.0])
def test_interpolate_pose_matches_jax(alpha, rng):
    r0, r1 = _rotations(rng, 2)
    t0, t1 = rng.normal(size=3) * 5, rng.normal(size=3) * 5
    with jax.enable_x64(True):
        want = jgeo.interpolate_pose(*(jnp.asarray(x) for x in (r0, t0, r1, t1)), alpha)
        want = [np.asarray(w) for w in want]
    got = geo.interpolate_pose(*(torch.from_numpy(x) for x in (r0, t0, r1, t1)), alpha)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-12)


def test_euler_roundtrip_and_batch_match_jax(rng):
    """matrix_to_euler_zyx inverts euler_zyx_to_matrix inside the principal
    range (the JAX package's test), and bmatrix_to_euler equals the JAX
    package's on a batch that includes gimbal lock."""
    angles = rng.uniform([-3.0, -1.5, -3.0], [3.0, 1.5, 3.0], size=(64, 3))
    angles[0] = [0.3, np.pi / 2, -0.2]
    angles[1] = [0.0, -np.pi / 2, 1.0]
    mats = geo.euler_zyx_to_matrix(*torch.from_numpy(angles).unbind(-1))
    back = geo.matrix_to_euler_zyx(mats)
    assert back.shape == (64, 3)
    np.testing.assert_allclose(geo.euler_zyx_to_matrix(*back.unbind(-1)).numpy(),
                               mats.numpy(), atol=1e-9)
    np.testing.assert_allclose(back[2:].numpy(), angles[2:], atol=1e-9)
    with jax.enable_x64(True):
        want = np.asarray(jgeo.bmatrix_to_euler(jnp.asarray(mats.numpy())))
        one = np.asarray(jgeo.matrix_to_euler_zyx(jnp.asarray(mats[5].numpy())))
    np.testing.assert_allclose(geo.bmatrix_to_euler(mats).numpy(), want, atol=1e-12)
    np.testing.assert_allclose(geo.matrix_to_euler_zyx(mats[5]).numpy(), one, atol=1e-12)
    f32 = geo.bmatrix_to_euler(mats.float())
    assert f32.dtype == torch.float32
    np.testing.assert_allclose(f32.numpy(), np.asarray(jgeo.bmatrix_to_euler(
        jnp.asarray(mats.float().numpy()))), atol=2e-6)


def test_imu_interpolate_matches_jax(rng):
    pre = [rng.normal(), rng.normal(size=3), rng.normal(size=3)]
    cur = [rng.normal(), rng.normal(size=3), rng.normal(size=3)]
    for off, gap in ((0.004, 0.01), (0.0, 0.01), (0.01, 0.01), (0.0, 0.0)):
        with jax.enable_x64(True):
            want = jimu.interpolate(jnp.asarray(off), jnp.asarray(gap),
                                    jimu.IMUSample(*(jnp.asarray(x) for x in pre)),
                                    jimu.IMUSample(*(jnp.asarray(x) for x in cur)))
            want = [[np.asarray(f) for f in s] for s in want]
        got = imu.interpolate(torch.tensor(off, dtype=torch.float64),
                              torch.tensor(gap, dtype=torch.float64),
                              imu.IMUSample(*(torch.as_tensor(x) for x in pre)),
                              imu.IMUSample(*(torch.as_tensor(x) for x in cur)))
        for gs, ws in zip(got, want):
            for g, w in zip(gs, ws):
                np.testing.assert_allclose(g.numpy(), w, rtol=1e-14, atol=1e-15)
        assert float(got[1].dt) == 0.0


@pytest.mark.parametrize("n", [0, 37, 64, 100])
def test_from_numpy_matches_jax(n, rng):
    pts = rng.normal(size=(n, 3)) * 10
    want = jpc.from_numpy(pts, 64)
    got = pointcloud.from_numpy(pts, 64)
    assert got.points.dtype == torch.float32 and got.points.shape == (64, 3)
    assert got.points.numpy().tobytes() == np.asarray(want.points).tobytes()
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    got64 = pointcloud.from_numpy(pts, 64, dtype=torch.float64)
    np.testing.assert_array_equal(got64.points[:min(n, 64)].numpy(), pts[:64])


def test_get_all_matches_jax(rng):
    """After two inserts of the same scans, the whole map as a cloud equals
    the JAX package's, row for row."""
    scans = [(rng.normal(size=(500, 3)) * 6).astype(np.float32) for _ in range(2)]
    jm = jvoxmap.create(2048)
    tm = voxmap.create(2048)
    for i, s in enumerate(scans):
        t = np.array([0.3 * i, 0.0, 0.0], np.float32)
        jm, _ = jvoxmap.insert(jm, jpc.from_numpy(s, 512), jnp.eye(3), jnp.asarray(t),
                               0.5, 5, 50.0)
        tm, _ = voxmap.insert(tm, pointcloud.from_numpy(s, 512), torch.eye(3),
                              torch.from_numpy(t), 0.5, 5, 50.0)
    want, got = jvoxmap.get_all(jm), voxmap.get_all(tm)
    assert int(got.valid.sum()) == int(np.asarray(want.valid).sum()) > 500
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(want.points))


LB = [-0.3, -0.2, -0.1, -0.004, -0.004, -0.012]
UB = [0.3, 0.2, 0.1, 0.004, 0.004, 0.012]
STD = [0.1, 0.05, 0.02, 0.002, 0.002, 0.006]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_init_particles_uniform(dtype):
    gen = torch.Generator().manual_seed(7)
    x = svn.init_particles_uniform(gen, 4096, LB, UB, dtype=dtype)
    assert x.shape == (4096, 6) and x.dtype == dtype
    assert (x >= torch.tensor(LB, dtype=dtype)).all()
    assert (x < torch.tensor(UB, dtype=dtype)).all()
    again = svn.init_particles_uniform(torch.Generator().manual_seed(7), 4096, LB, UB,
                                       dtype=dtype)
    assert torch.equal(x, again)
    assert not torch.equal(x, svn.init_particles_uniform(gen, 4096, LB, UB, dtype=dtype))
    assert torch.equal(svn.init_particles_uniform(gen, 1, LB, UB, dtype=dtype),
                       torch.zeros((1, 6), dtype=dtype))
    # the moments beside JAX's draws of the same size: mean and variance
    # within 5 standard errors of the box's, like JAX's
    want = np.asarray(jsvn.init_particles_uniform(jax.random.PRNGKey(7), 4096, LB, UB))
    lb, ub = np.array(LB), np.array(UB)
    mean, var = (lb + ub) / 2, (ub - lb) ** 2 / 12
    for draws in (x.double().numpy(), want.astype(np.float64)):
        se_mean = np.sqrt(var / 4096)
        assert (np.abs(draws.mean(0) - mean) < 5 * se_mean).all()
        assert (np.abs(draws.var(0) / var - 1) < 5 * np.sqrt(0.8 / 4096)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_init_particles_gaussian(dtype):
    gen = torch.Generator().manual_seed(11)
    x = svn.init_particles_gaussian(gen, 4096, STD, dtype=dtype)
    std = torch.tensor(STD, dtype=dtype)
    assert x.shape == (4096, 6) and x.dtype == dtype
    assert (x.abs() <= 3 * std).all()
    assert torch.equal(x, svn.init_particles_gaussian(torch.Generator().manual_seed(11),
                                                      4096, STD, dtype=dtype))
    assert torch.equal(svn.init_particles_gaussian(gen, 1, STD, dtype=dtype),
                       torch.zeros((1, 6), dtype=dtype))
    want = np.asarray(jsvn.init_particles_gaussian(jax.random.PRNGKey(11), 4096, STD))
    s = np.array(STD)
    for draws in (x.double().numpy(), want.astype(np.float64)):
        # a normal clamped at 3 sigma: mean 0, variance 0.9866 sigma^2
        assert (np.abs(draws.mean(0)) < 5 * s / 64).all()
        assert (np.abs(draws.var(0) / s ** 2 - 0.9866) < 5 * np.sqrt(2 / 4096)).all()


@pytest.mark.parametrize("kind,pose", [("world", 0), ("world", 1), ("corridor", 2)])
def test_raycast_scan_equals_jax(kind, pose):
    """The same surfaces, pose and rng give the JAX package's scan byte for
    byte: the HDL-64 test's world and pose at full resolution, a turned
    pose at col_step 3, a corridor without noise."""
    if kind == "world":
        surfaces = jdatasets.SyntheticWorld(extent=40.0, n_walls=18, n_boxes=12,
                                            seed=5)._surfaces
    else:
        surfaces = datasets.DegenerateWorld("corridor").surfaces
    rot = Rotation.from_euler("zyx", [0.4 * pose, 0.02, -0.01]).as_matrix()
    trans = np.array([0.1 * pose, -0.2, 1.5])
    kw = [dict(max_range=50.0), dict(col_step=3, max_range=60.0),
          dict(noise=0.0, col_step=5)][pose]
    want = jdatasets.raycast_scan(surfaces, rot, trans, rng=np.random.default_rng(pose), **kw)
    got = datasets.raycast_scan(surfaces, rot, trans, rng=np.random.default_rng(pose), **kw)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.tobytes() == want.tobytes()
    if pose == 0:
        assert len(got) > 60_000
