"""Integer and sort decisions of the port against the JAX package, EXACTLY:
hash32, downsample_uniform, voxmap.insert (incl. shedding at a small
capacity) and voxmap.query_radius (incl. the whole-map fallback)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnicp_tpu.core import pointcloud as jpc
from svnicp_tpu.core import voxmap as jvm
from svnicp_tpu_torch.core import pointcloud as tpc
from svnicp_tpu_torch.core import voxmap as tvm

torch.set_num_threads(2)


def _cloud(rng, n, scale=20.0, frac_valid=0.85):
    pts = (rng.normal(size=(n, 3)) * scale).astype(np.float32)
    pts[: n // 4] = np.round(pts[: n // 4] * 2) / 2      # on voxel boundaries
    valid = rng.random(n) < frac_valid
    return pts, valid


def test_hash32_bit_exact(rng):
    x = rng.integers(-2**31, 2**31 - 1, size=5000, dtype=np.int64).astype(np.int32)
    x[:4] = [0, -1, 2**31 - 1, -2**31]
    np.testing.assert_array_equal(
        tpc.hash32(torch.from_numpy(x)).numpy(),
        np.asarray(jpc.hash32(jnp.asarray(x))))


@pytest.mark.parametrize("voxel,capacity", [(0.5, 2048), (1.5, 300)])
def test_downsample_uniform_exact(rng, voxel, capacity):
    pts, valid = _cloud(rng, 4000)
    want = jpc.downsample_uniform(jpc.PaddedCloud(jnp.asarray(pts),
                                                  jnp.asarray(valid)),
                                  voxel, capacity)
    got = tpc.downsample_uniform(tpc.PaddedCloud(torch.from_numpy(pts),
                                                 torch.from_numpy(valid)),
                                 voxel, capacity)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(want.points))


def test_crop_exact(rng):
    pts, valid = _cloud(rng, 1000)
    want = jpc.crop(jpc.PaddedCloud(jnp.asarray(pts), jnp.asarray(valid)), 2.0, 30.0)
    got = tpc.crop(tpc.PaddedCloud(torch.from_numpy(pts), torch.from_numpy(valid)),
                   2.0, 30.0)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


def _run_inserts(rng, capacity, n_scans, max_pts, max_range):
    """Insert the same scans into both maps at poses whose rotations are
    exact in f32 (identity and quarter turns), so world points agree bit
    for bit and every key, order and eviction decision can be compared."""
    jm = jvm.create(capacity)
    tm = tvm.create(capacity)
    quarter = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], np.float32)
    for i in range(n_scans):
        pts, valid = _cloud(rng, 700, scale=8.0)
        r = np.linalg.matrix_power(quarter, i % 4).astype(np.float32)
        t = np.array([0.75 * i, -0.5 * i, 0.25], np.float32)
        jm, jd = jvm.insert(jm, jpc.PaddedCloud(jnp.asarray(pts), jnp.asarray(valid)),
                            jnp.asarray(r), jnp.asarray(t), 1.0, max_pts, max_range)
        tm, td = tvm.insert(tm, tpc.PaddedCloud(torch.from_numpy(pts),
                                                torch.from_numpy(valid)),
                            torch.from_numpy(r), torch.from_numpy(t), 1.0,
                            max_pts, max_range)
        assert int(td) == int(jd)
        np.testing.assert_array_equal(tm.key.numpy(), np.asarray(jm.key))
        np.testing.assert_array_equal(tm.valid.numpy(), np.asarray(jm.valid))
        np.testing.assert_array_equal(tm.points.numpy(), np.asarray(jm.points))
    return jm, tm


def test_insert_exact():
    _run_inserts(np.random.default_rng(3), capacity=8192, n_scans=4,
                 max_pts=5, max_range=40.0)


def test_insert_sheds_at_capacity():
    rng = np.random.default_rng(4)
    jm, tm = _run_inserts(rng, capacity=1024, n_scans=3, max_pts=20,
                          max_range=100.0)
    assert int(tm.count()) == 1024          # full: shedding happened


def test_insert_evicts_far_voxels():
    _, near = _run_inserts(np.random.default_rng(5), capacity=8192, n_scans=4,
                           max_pts=8, max_range=12.0)
    _, all_kept = _run_inserts(np.random.default_rng(5), capacity=8192,
                               n_scans=4, max_pts=8, max_range=1000.0)
    assert int(near.count()) < int(all_kept.count())


@pytest.mark.parametrize("radius,target_cap", [(10.0, 4096), (12.0, 512),
                                               (0.5, 4096)])
def test_query_radius_exact(radius, target_cap):
    """Includes truncation at a small target capacity and, at a radius far
    from every voxel's first point, the whole-map fallback."""
    jm, tm = _run_inserts(np.random.default_rng(6), capacity=8192, n_scans=3,
                          max_pts=6, max_range=60.0)
    center = np.array([40.0, 40.0, 0.0], np.float32) if radius == 0.5 else \
        np.array([1.0, -0.5, 0.0], np.float32)
    jc, jo = jvm.query_radius(jm, jnp.asarray(center), jnp.asarray(radius),
                              target_cap)
    tc, to = tvm.query_radius(tm, torch.from_numpy(center), radius, target_cap)
    assert int(to) == int(jo)
    np.testing.assert_array_equal(tc.valid.numpy(), np.asarray(jc.valid))
    np.testing.assert_array_equal(tc.points.numpy(), np.asarray(jc.points))
    if radius == 0.5:
        assert int(tc.valid.sum()) == min(int(tm.count()), target_cap)


def _cummax_first(sorted_key):
    """The run broadcasts as a prefix-max scan, the reference for
    `voxmap._run_start`: each row's run start is the largest run-start
    index at or before it."""
    first = torch.ones_like(sorted_key, dtype=torch.bool)
    first[1:] = sorted_key[1:] != sorted_key[:-1]
    idx = torch.arange(sorted_key.shape[0])
    return torch.cummax(torch.where(first, idx, torch.zeros_like(idx)), 0).values


def _cummax_flag(sorted_key, flag):
    """The first row's flag broadcast over its run, riding the low bit of
    one cummax over packed run-start indices."""
    first = torch.ones_like(sorted_key, dtype=torch.bool)
    first[1:] = sorted_key[1:] != sorted_key[:-1]
    idx = torch.arange(sorted_key.shape[0])
    packed = torch.where(first, idx * 2 + flag.to(idx.dtype), torch.zeros_like(idx))
    return (torch.cummax(packed, 0).values & 1).bool()


def _keys(case, rng):
    if case == "random_invalid_tail":
        k = np.sort(rng.integers(-400, 400, 3000)) * 5_000_000
        return np.concatenate([k, np.full(700, tpc.INVALID_KEY)])
    if case == "one_key":
        return np.full(500, -7)
    if case == "distinct":
        return np.sort(rng.choice(2**31 - 1, 1000, replace=False)) - 2**30
    if case == "one_row":
        return np.array([123])
    lengths = np.concatenate([np.arange(1, 21), rng.integers(1, 4, 50),
                              np.arange(20, 0, -1)])
    return np.repeat(np.arange(len(lengths)) * 3 - 60, lengths)


@pytest.mark.parametrize("case", ["random_invalid_tail", "one_key", "distinct",
                                  "one_row", "runs_1_to_20_at_both_ends"])
def test_run_start_equals_the_cummax_broadcasts(rng, case):
    """The binary search's run starts, and a flag gathered from them, equal
    the prefix-max scan's bit for bit on sorted keys."""
    from svnicp_tpu_torch.runtime import profiling

    key = torch.from_numpy(_keys(case, rng).astype(np.int32))
    assert torch.equal(key, torch.sort(key).values)
    flag = torch.from_numpy(rng.random(key.shape[0]) < 0.5)
    with profiling.tracing() as trace:
        start = tvm._run_start(key)
    assert trace.counters["svnicp.map.run_searches"] == 1
    assert start.dtype == torch.int64
    assert torch.equal(start, _cummax_first(key))
    assert torch.equal(flag[start], _cummax_flag(key, flag))
