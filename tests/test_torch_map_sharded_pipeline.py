"""The sharded map as a live pipeline mode on the port (the JAX package's
tests/test_map_sharded_pipeline.py), on the port's in-process mesh with its
shards on `cpu`.

The operating point is the JAX package's exact-parity one
(`chip_smoke.dryrun_config`, from `__graft_entry__.dryrun_multichip`):
float64, point-to-point, exact top-k candidates (the ring's union top-k is
then the exact global KNN, the same candidates the replicated radius query
finds), target capacity = map capacity, rebalances every 2 frames, and a
re-anchor after frame 3 of 6 (`chip_smoke.dryrun_inputs`). Checked:
- the port's sharded-map run against the JAX package's on the simulated
  8-device mesh, the JAX particle draws replayed: poses to 1e-9 (measured
  ~1e-16: only the order of the point-axis sums is left), the same
  iterations and rebalances, and the map's keys, valid rows and split keys
  exactly equal;
- sharded against the port's own replicated-map run: drift below 1e-4 m
  (the JAX contract), one re-anchor, at least 3 rebalances, the same
  resident voxel keys;
- the rebalance cadence (post-bootstrap + every rebalance_every frames);
- save_particles on the mesh; the two ValueErrors (no mesh; capacity not
  divisible over the point shards).
"""

import dataclasses
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from svnicp_tpu import config as jcfg  # noqa: E402
from svnicp_tpu.runtime import pipeline as jpl  # noqa: E402
from svnicp_tpu_torch import config as tcfg  # noqa: E402
from svnicp_tpu_torch.core.pointcloud import INVALID_KEY  # noqa: E402
from svnicp_tpu_torch.parallel import sharding  # noqa: E402
from svnicp_tpu_torch.runtime import pipeline as tpl  # noqa: E402

torch.set_num_threads(2)


def cpu_mesh(p, q):
    return sharding.make_mesh(p, q, devices=["cpu"] * (p * q))


@pytest.fixture(scope="module")
def inputs():
    return chip_smoke.dryrun_inputs(6, 2500)


def jax_draws(cfg, n_frames):
    """The JAX pipeline's per-frame particle draws (none at the bootstrap)."""
    key = jax.random.PRNGKey(cfg.seed)
    lb = jnp.asarray(cfg.icp.init_lb, jnp.float64)
    ub = jnp.asarray(cfg.icp.init_ub, jnp.float64)
    draws = [None]
    for _ in range(1, n_frames):
        key, sub = jax.random.split(key)
        u = jax.random.uniform(sub, (cfg.icp.particle_count, 6), jnp.float64)
        draws.append(np.array(lb + (ub - lb) * u))
    return draws


def jax_dryrun(cfg, inputs, reanchor_after):
    """The JAX package's run of the dry-run program -> its pipeline."""
    pipe = jpl.LIOPipeline(cfg)
    for sample in inputs["imu"]:
        pipe.feed_imu(*sample)
    for i, scan in enumerate(inputs["scans"]):
        pipe.feed_scan(float(inputs["times"][i]), scan)
        if i == reanchor_after:
            pipe.apply_reanchor(*inputs["delta"])
    pipe.close()
    return pipe


def resident_keys(vmap):
    key, valid = np.asarray(vmap.key), np.asarray(vmap.valid)
    return np.unique(key[valid & (key != INVALID_KEY)])


def test_sharded_map_matches_jax_float64(inputs):
    with jax.enable_x64(True):
        cfg = chip_smoke.dryrun_config(jcfg, 2, 4, sharded=True)
        want = jax_dryrun(cfg, inputs, 3)
        draws = jax_draws(cfg, 6)
        want_traj = want.trajectory()
        want_state = jax.tree.map(np.asarray, (want.state.vmap, want.state.split_keys))
    got = chip_smoke.run_dryrun(chip_smoke.dryrun_config(tcfg, 2, 4, sharded=True),
                                inputs, 3, "cpu", mesh=cpu_mesh(2, 4), draws=draws)
    np.testing.assert_allclose(got.trajectory(), want_traj, atol=1e-9)
    assert [o.icp_iterations for o in got.outputs] == \
        [int(o.icp_iterations) for o in want.outputs]
    assert got.rebalances == want.rebalances == 4
    assert got.reanchors == want.reanchors == 1
    assert got.reanchor_drops == want.reanchor_drops == 0
    (jmap, jsplit) = want_state
    np.testing.assert_array_equal(got.state.vmap.key.numpy(), jmap.key)
    np.testing.assert_array_equal(got.state.vmap.valid.numpy(), jmap.valid)
    np.testing.assert_array_equal(got.state.split_keys.numpy(), jsplit)


def test_sharded_map_against_replicated_map(inputs):
    """The (4, 2) mesh of the JAX dry run against the port's single-device
    run of the same configuration with the replicated map."""
    sharded = chip_smoke.run_dryrun(chip_smoke.dryrun_config(tcfg, 4, 2, sharded=True),
                                    inputs, 3, "cpu", mesh=cpu_mesh(4, 2))
    whole = chip_smoke.run_dryrun(chip_smoke.dryrun_config(tcfg, 4, 2, sharded=False),
                                  inputs, 3, "cpu")
    assert whole.mesh is None and sharded.mesh.shape == {"particle": 4, "point": 2}
    drift = np.linalg.norm(sharded.trajectory()[:, :3, 3] - whole.trajectory()[:, :3, 3],
                           axis=1)
    assert drift.max() < 1e-4, drift
    assert sharded.reanchors == whole.reanchors == 1
    assert sharded.rebalances >= 3
    assert all(o.align_ok for o in sharded.outputs)
    np.testing.assert_array_equal(resident_keys(sharded.state.vmap),
                                  resident_keys(whole.state.vmap))


def _quick(**over):
    """The dry run's configuration on a (2, 2) mesh, 3 iterations a frame."""
    cfg = chip_smoke.dryrun_config(tcfg, 2, 2, sharded=True)
    return dataclasses.replace(cfg, icp=dataclasses.replace(cfg.icp, iterations=3),
                               **over)


def test_rebalance_cadence(inputs):
    """One rebalance after the bootstrap, then every rebalance_every frames
    (the JAX test's 7 frames at a cadence of 3: 3 rebalances)."""
    cfg = _quick()
    cfg = dataclasses.replace(cfg, map=dataclasses.replace(cfg.map, rebalance_every=3))
    more = chip_smoke.dryrun_inputs(7, 1500)
    pipe = chip_smoke.run_dryrun(cfg, more, 99, "cpu", mesh=cpu_mesh(2, 2))
    assert pipe.rebalances == 3
    assert int(pipe.outputs[-1].map_points) > int(pipe.outputs[0].map_points)


def test_save_particles_on_mesh(inputs):
    cfg = _quick(save_particles=True)
    small = chip_smoke.dryrun_inputs(3, 1500)
    pipe = chip_smoke.run_dryrun(cfg, small, 99, "cpu", mesh=cpu_mesh(2, 2))
    out = pipe.outputs[-1]
    hist = out.history.numpy()
    assert hist.shape == (cfg.icp.iterations, cfg.icp.particle_count, 6)
    assert np.isfinite(hist).all()
    np.testing.assert_array_equal(hist[out.icp_iterations - 1], out.particles.numpy())


def test_sharded_without_mesh_raises():
    cfg = chip_smoke.dryrun_config(tcfg, 2, 2, sharded=False)
    cfg = dataclasses.replace(cfg, map=dataclasses.replace(cfg.map, sharded=True))
    with pytest.raises(ValueError, match="map.sharded"):
        tpl.LIOPipeline(cfg, device="cpu")


def test_capacity_divisibility_enforced():
    cfg = chip_smoke.dryrun_config(tcfg, 2, 4, sharded=True)
    cfg = dataclasses.replace(cfg, map=dataclasses.replace(cfg.map, capacity=32770))
    with pytest.raises(ValueError, match="capacity"):
        tpl.LIOPipeline(cfg, device="cpu", mesh=cpu_mesh(2, 4))


def test_mesh_on_another_device_type_raises():
    """A prebuilt mesh whose shards lie on another device type than the
    pipeline's is refused where it is given, not at the first frame."""
    cfg = chip_smoke.dryrun_config(tcfg, 2, 2, sharded=True)
    mesh = sharding.make_mesh(2, 2, devices=["meta"] * 4)
    with pytest.raises(ValueError, match="shards lie on"):
        tpl.LIOPipeline(cfg, device="cpu", mesh=mesh)
