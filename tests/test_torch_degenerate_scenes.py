"""The paper's observability claim on the port: the tunnel, the plane and
the HDL-64 segmentation case of tests/test_degenerate_pipeline.py (see
test_torch_degenerate_corridor.py for the corridor and the method):
- parity: each scene at `kf_cfg(equilibrium=True)`, every frame from the
  JAX package's state before it with its particle draws, frame by frame;
- the claim: the JAX test's assertions on the port's own draws;
- HDL-64: the segmentation case (the full 64 x 2250 range image, float32,
  the ICP estimator) on the port's own `raycast_scan` scans with the JAX
  test's assertions, and the first frame's map points equal to the JAX
  package's.
"""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import test_degenerate_pipeline as jdeg  # noqa: E402
from svnicp_tpu.io import datasets as jdatasets  # noqa: E402
from svnicp_tpu.runtime import pipeline as jpl  # noqa: E402
from svnicp_tpu_torch import config as tcfg  # noqa: E402
from svnicp_tpu_torch.io import datasets  # noqa: E402
from svnicp_tpu_torch.runtime import pipeline as tpl  # noqa: E402
from test_torch_degenerate_corridor import (  # noqa: E402
    assert_parity, errors, jax_run, median_var, port_run)

torch.set_num_threads(2)


@pytest.fixture(scope="module", params=["tunnel", "plane"])
def scene(request):
    return request.param, jax_run(request.param, jdeg.kf_cfg(equilibrium=True))


def test_equilibrium_parity(scene):
    kind, want = scene
    pipe, _ = port_run(kind, jdeg.kf_cfg(equilibrium=True), want, restart=True)
    assert want["iters"][1:] == [60] * (jdeg.N_FRAMES - 1)
    assert_parity(pipe, want, "equilibrium")


class TestTunnel:
    """The JAX package's TestTunnel on the port's own draws: x unobservable,
    the cross-section constrained."""

    def test_anisotropic_variance_and_containment(self):
        pipe, trans = port_run("tunnel", jdeg.kf_cfg(equilibrium=True))
        r = median_var(pipe) / jdeg.prior_var()
        print(f"tunnel r = {r}")
        assert r[0] > 0.15, f"x did not retain prior spread: {r}"
        assert r[1] < 0.01, f"y not constrained: {r}"
        assert r[2] < 0.3, f"z not constrained: {r}"
        assert r[0] > 50.0 * r[1], f"x not dominant over y: {r}"
        err = errors(pipe, trans)
        assert np.isfinite(err).all()
        assert np.abs(err[:, 1]).max() < 0.15
        assert np.abs(err[:, 2]).max() < 0.15
        assert np.abs(err[:, 0]).max() < 1.0


class TestPlane:
    """The JAX package's TestPlane on the port's own draws: x, y and yaw
    unobservable; z and pitch held (roll reads prior-bound there too)."""

    def test_anisotropic_variance_and_containment(self):
        pipe, trans = port_run("plane", jdeg.kf_cfg(equilibrium=True))
        r = median_var(pipe) / jdeg.prior_var()
        print(f"plane r = {r}")
        assert r[0] > 0.15 and r[1] > 0.15, f"x/y did not retain prior: {r}"
        assert r[5] > 0.15, f"yaw did not retain prior: {r}"
        assert r[2] < 1e-2, f"z not constrained: {r}"
        assert r[4] < 1e-2, f"pitch not constrained: {r}"
        err = errors(pipe, trans)
        assert np.isfinite(err).all()
        assert np.abs(err[:, 2]).max() < 0.15   # z held by the plane


def hdl64_cfg():
    """The JAX test's HDL-64 configuration."""
    return jdeg.kf_cfg(
        preprocess=jdeg.cfg_mod.PreprocessConfig(
            min_range=1.0, max_range=50.0, voxel_size=0.5, use_segmentation=True,
            sensor_model="hdl64", raw_capacity=147456),
        lio=jdeg.cfg_mod.LIOConfig(estimator="icp", frame_gap_seconds=0.0),
        dtype="float32")


def hdl64_poses():
    times = np.arange(3) * jdeg.DT
    rots = np.tile(np.eye(3), (3, 1, 1))
    trans = np.zeros((3, 3))
    trans[:, 0] = jdeg.SPEED * times
    trans[:, 2] = 1.5
    return times, rots, trans


class TestHDL64Segmentation:
    """The JAX package's segmentation case at the real HDL-64 shape."""

    def test_full_resolution_pipeline(self):
        world = datasets.SyntheticWorld(extent=40.0, n_walls=18, n_boxes=12, seed=5)
        times, rots, trans = hdl64_poses()
        rng = np.random.default_rng(0)
        pipe = tpl.LIOPipeline(tcfg.from_dict(dataclasses.asdict(hdl64_cfg())),
                               device="cpu")
        n_raw = []
        for i in range(3):
            scan = datasets.raycast_scan(world._surfaces, rots[i], trans[i],
                                         max_range=50.0, rng=rng)
            n_raw.append(len(scan))
            pipe.feed_scan(float(times[i]), scan)
        pipe.close()
        assert min(n_raw) > 60_000, n_raw
        err = errors(pipe, trans)
        assert np.isfinite(err).all()
        assert np.abs(err[-1]).max() < 0.2, err
        assert int(pipe.outputs[0].map_points) < n_raw[0] // 2
        assert all(o.align_ok for o in pipe.outputs)

    def test_first_frame_map_equals_the_jax_packages(self):
        """The bootstrap frame (segmentation, crop, map insert) of the same
        scan leaves the JAX package's map point count."""
        world = jdatasets.SyntheticWorld(extent=40.0, n_walls=18, n_boxes=12, seed=5)
        times, rots, trans = hdl64_poses()
        scan = jdatasets.raycast_scan(world._surfaces, rots[0], trans[0],
                                      max_range=50.0, rng=np.random.default_rng(0))
        jpipe = jpl.LIOPipeline(hdl64_cfg())
        jpipe.feed_scan(0.0, scan)
        pipe = tpl.LIOPipeline(tcfg.from_dict(dataclasses.asdict(hdl64_cfg())),
                               device="cpu")
        pipe.feed_scan(0.0, scan)
        assert int(pipe.outputs[0].map_points) == int(jpipe.outputs[0].map_points)
        assert int(pipe.outputs[0].map_points) > 5_000
