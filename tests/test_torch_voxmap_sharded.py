"""The port's sharded voxel map (`parallel/voxmap_sharded.py`) against the
JAX package's on the suite's simulated 8-device CPU mesh, the port's
in-process (2, 4) mesh with its shards on `cpu`.

A float64 map of capacity 4096 in 4 blocks of 1024 takes two 2500-point
scans of SyntheticWorld(extent=30, seed=1) (voxel 1 m, 5 points a voxel):
the first under the uniform split (the whole scene in one block, so the
insert sheds rows), a rebalance of that skewed map, the second scan under
the new boundaries, a rebalance of the now balanced map (the boundaries
stay), and a re-anchor. After every step the keys, valid masks, split keys
and drop counts must equal JAX's exactly, and the float64 points bit for
bit. Besides: `compaction_order` with tied keys, `owner_of` and the uniform
split, the quantiles' running sum (`xla_cumsum` against `jnp.cumsum`
compiled on the CPU, exactly), and the registration against the sharded
map (ring candidates, both candidate methods) to 1e-9 in float64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnicp_tpu.config import SteinICPConfig as JCfg
from svnicp_tpu.core import pointcloud as jpc
from svnicp_tpu.core import voxmap as jvm
from svnicp_tpu.parallel import sharding as jsh
from svnicp_tpu.parallel import voxmap_sharded as jvms
from svnicp_tpu_torch.config import SteinICPConfig as TCfg
from svnicp_tpu_torch.core import geometry as tgeo
from svnicp_tpu_torch.core import pointcloud as tpc
from svnicp_tpu_torch.core import voxmap as tvm
from svnicp_tpu_torch.io import datasets
from svnicp_tpu_torch.parallel import sharding as tsh
from svnicp_tpu_torch.parallel import voxmap_sharded as tvms

torch.set_num_threads(1)

CAP, VOXEL, PER_VOXEL, RANGE = 4096, 1.0, 5, 100.0


@pytest.fixture(scope="module")
def scans():
    world = datasets.SyntheticWorld(extent=30.0, seed=1)
    _, rots, trans = datasets.synthetic_trajectory(2, dt=0.5, speed=2.0, seed=1)
    rng = np.random.default_rng(1)
    return [(world.scan_at(rng, rots[i], trans[i], n_points=2500).astype(np.float64),
             rots[i], trans[i])
            for i in range(2)]


def _same_map(port, want, what):
    np.testing.assert_array_equal(port.key.numpy(), np.asarray(want.key), err_msg=what)
    np.testing.assert_array_equal(port.valid.numpy(), np.asarray(want.valid), err_msg=what)
    assert port.points.numpy().tobytes() == np.asarray(want.points).tobytes(), what


@pytest.fixture(scope="module")
def steps(scans):
    """Both packages through insert, rebalance, insert, rebalance and
    re-anchor -> {step: (port result, JAX result)}."""
    jmesh, tmesh = jsh.make_mesh(2, 4), tsh.make_mesh(2, 4, devices=["cpu"] * 8)
    dr = tgeo.so3_exp(torch.tensor([0.0, 0.0, 0.05], dtype=torch.float64))
    dt = torch.tensor([0.4, -0.25, 0.1], dtype=torch.float64)
    out = {}
    with jax.enable_x64(True):
        jmap = jvm.create(CAP, jnp.float64)
        tmap = tvm.create(CAP, torch.float64)
        jsplit, tsplit = jvms.uniform_split_keys(4), tvms.uniform_split_keys(4)
        for i, (pts, r, t) in enumerate(scans):
            jcloud = jpc.PaddedCloud(jnp.asarray(pts, jnp.float64), jnp.ones(len(pts), bool))
            tcloud = tpc.PaddedCloud(torch.from_numpy(pts), torch.ones(len(pts), dtype=torch.bool))
            jmap, jd = jvms.sharded_insert(jmesh, jmap, jcloud, jnp.asarray(r), jnp.asarray(t),
                                           VOXEL, PER_VOXEL, RANGE, split_keys=jsplit)
            tmap, td = tvms.sharded_insert(tmesh, tmap, tcloud, torch.from_numpy(r),
                                           torch.from_numpy(t), VOXEL, PER_VOXEL, RANGE,
                                           split_keys=tsplit)
            out[f"insert{i}"] = ((tmap, tsplit, td), (jmap, jsplit, jd))
            jmap, jsplit, jd = jvms.rebalance(jmesh, jmap, jsplit, sample_per_shard=64)
            tmap, tsplit, td = tvms.rebalance(tmesh, tmap, tsplit, sample_per_shard=64)
            out[f"rebalance{i}"] = ((tmap, tsplit, td), (jmap, jsplit, jd))
        jmap, jd = jvms.sharded_reanchor(jmesh, jmap, jsplit, jnp.asarray(dr.numpy()),
                                         jnp.asarray(dt.numpy()), VOXEL)
        tmap, td = tvms.sharded_reanchor(tmesh, tmap, tsplit, dr, dt, VOXEL)
        out["reanchor"] = ((tmap, tsplit, td), (jmap, jsplit, jd))
        out = jax.tree.map(lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, out)
    return out


@pytest.mark.parametrize("step", ["insert0", "rebalance0", "insert1", "rebalance1",
                                  "reanchor"])
def test_step_matches_jax_exactly(steps, step):
    (tmap, tsplit, td), (jmap, jsplit, jd) = steps[step]
    _same_map(tmap, jmap, step)
    np.testing.assert_array_equal(tsplit.numpy(), np.asarray(jsplit))
    assert int(td) == int(jd), (step, int(td), int(jd))


def test_the_steps_exercise_what_they_name(steps):
    """The uniform split sheds rows into one block; the first rebalance
    moves the boundaries and spreads the rows; the second keeps them."""
    uniform = tvms.uniform_split_keys(4).numpy()
    (m0, _, d0), _ = steps["insert0"]
    (m1, s1, _), _ = steps["rebalance0"]
    (m3, s3, _), _ = steps["rebalance1"]
    (m2, s2, _), _ = steps["insert1"]
    assert int(d0) > 0
    assert not np.array_equal(s1.numpy(), uniform)
    blocks = m1.valid.reshape(4, -1).sum(1)
    assert (blocks > 0).all(), blocks
    np.testing.assert_array_equal(s3.numpy(), s2.numpy())
    assert int(m3.valid.sum()) == int(m2.valid.sum())


def test_blocks_hold_their_key_ranges(steps):
    (m, splits, _), _ = steps["reanchor"]
    key = m.key.reshape(4, -1)
    valid = m.valid.reshape(4, -1)
    for s in range(4):
        owners = tvms.owner_of(key[s][valid[s]], splits)
        assert (owners == s).all()
        k = key[s][valid[s]]
        assert (k[1:] >= k[:-1]).all()


def test_compaction_order_matches_jax_with_ties():
    rng = np.random.default_rng(3)
    key = rng.integers(0, 40, 500).astype(np.int32)      # many equal keys
    keep = rng.random(500) < 0.7
    want = np.asarray(jpc.compaction_order(jnp.asarray(keep), jnp.asarray(key)))
    got = tpc.compaction_order(torch.from_numpy(keep), torch.from_numpy(key)).numpy()
    np.testing.assert_array_equal(got, want)


def test_owner_and_uniform_split_match_jax():
    for n in (1, 2, 4, 8):
        np.testing.assert_array_equal(tvms.uniform_split_keys(n).numpy(),
                                      np.asarray(jvms.uniform_split_keys(n)))
        for s in range(n):
            lo, hi = jvms.shard_bounds(jnp.int32(s), n)
            assert tvms.shard_bounds(s, n) == (int(lo), int(hi))
    keys = np.random.default_rng(4).integers(0, 1 << 30, 1000).astype(np.int32)
    splits = np.sort(np.random.default_rng(5).integers(0, 1 << 30, 3)).astype(np.int32)
    np.testing.assert_array_equal(
        tvms.owner_of(torch.from_numpy(keys), torch.from_numpy(splits)).numpy(),
        np.asarray(jvms.owner_of(jnp.asarray(keys), jnp.asarray(splits))))


@pytest.mark.parametrize("n", [1, 15, 16, 17, 100, 256, 257, 2048, 4097])
def test_running_sum_rounds_as_xla(n):
    rng = np.random.default_rng(n)
    x = (rng.uniform(0, 100, n) * rng.choice([1e-3, 1.0, 1e3], n)).astype(np.float32)
    want = np.asarray(jax.jit(jnp.cumsum)(x))
    got = tvms.xla_cumsum(torch.from_numpy(x)).numpy()
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("method", ["topk", "bucketed"])
def test_register_with_map_matches_jax(steps, scans, method):
    """Ring-gathered candidates from the 4 blocks, then the sharded align
    on the plain route, float64, early stop off."""
    (tmap, _, _), (jmap, _, _) = steps["rebalance1"]
    pts, r, t = scans[1]
    src = pts[::8][:256]
    over = dict(particle_count=8, iterations=10, lr=1.0, max_dist=2.8, knn_count=8,
                early_stop=False, candidate_method=method)
    lb, ub = np.array(TCfg().init_lb), np.array(TCfg().init_ub)
    init = lb + (ub - lb) * np.random.default_rng(6).random((8, 6))
    with jax.enable_x64(True):
        fn = jax.jit(jvms.sharded_register_with_map, static_argnums=(0, 1))
        want = fn(jsh.make_mesh(2, 4), JCfg(**over), jnp.asarray(src),
                  jnp.ones(len(src), bool), jvm.VoxelMap(*map(jnp.asarray, jmap)),
                  jnp.asarray(r), jnp.asarray(t), jnp.asarray(init))
        want = jax.tree.map(np.asarray, want)
    got = tvms.sharded_register_with_map(
        tsh.make_mesh(2, 4, devices=["cpu"] * 8), TCfg(**over), torch.from_numpy(src),
        torch.ones(len(src), dtype=torch.bool), tmap, torch.from_numpy(r),
        torch.from_numpy(t), torch.from_numpy(init))
    for name in ("particles", "mean", "var", "cov"):
        np.testing.assert_allclose(getattr(got, name).numpy(), getattr(want, name),
                                   atol=1e-9, err_msg=name)
    assert int(got.iterations) == int(want.iterations) == 10
    assert np.isfinite(want.mean).all()
