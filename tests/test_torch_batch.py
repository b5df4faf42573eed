"""Batched dispatch and the threaded ingest of the port's LIOPipeline.

The JAX package's tests of them (TestThreadedIngest and
test_insert_cadence_skip_matches_batched) on the port, at their
configuration (P=8, K=16, 4,000-point scans of SyntheticWorld(extent=40,
seed=3) along synthetic_trajectory(seed=5), source 1024, target 8192, map
32768), with the port's batched and threaded runs held bit-identical to
its per-frame run (the same step runs on the same bytes in the same order),
where the JAX package allows 1e-5. Then the port's batched run against the
JAX package's batched run (one lax.scan per batch) in float64 with JAX's
particle draws fed as `init_particles`: poses to 1e-6 and identical
iterations on every frame.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnicp_tpu import config as jcfg_mod
from svnicp_tpu.io import datasets as jdatasets
from svnicp_tpu.runtime import pipeline as jpl
from svnicp_tpu_torch import config as cfg_mod
from svnicp_tpu_torch.io import datasets
from svnicp_tpu_torch.runtime import packing
from svnicp_tpu_torch.runtime import pipeline as pl

torch.set_num_threads(2)


def small_cfg(mod=cfg_mod, **over):
    base = dict(
        icp=mod.SteinICPConfig(
            particle_count=8, iterations=30, lr=1.0, max_dist=2.8, knn_count=16,
            early_stop=True, convergence_threshold=5e-4,
            source_capacity=1024, target_capacity=8192,
        ),
        map=mod.MapConfig(voxel_size=1.0, max_points_per_voxel=10,
                          max_range=120.0, capacity=32768),
        preprocess=mod.PreprocessConfig(min_range=1.0, max_range=50.0,
                                        voxel_size=1.0, raw_capacity=8192),
        lio=mod.LIOConfig(estimator="icp", frame_gap_seconds=0.0),
    )
    base.update(over)
    return mod.PipelineConfig(**base)


@pytest.fixture(scope="module")
def world():
    return datasets.SyntheticWorld(extent=40.0, seed=3)


def sequence(world, n_frames, seed=5):
    times, rots, trans = datasets.synthetic_trajectory(n_frames, dt=0.1, speed=1.2,
                                                       seed=seed)
    rng = np.random.default_rng(seed)
    scans = [world.scan_at(rng, rots[i], trans[i], n_points=4000, noise=0.01)
             for i in range(n_frames)]
    return times, scans


def run(cfg, times, scans, draws=None):
    pipe = pl.LIOPipeline(cfg, device="cpu")
    returned = [pipe.feed_scan(float(t), s,
                               init_particles=None if draws is None else draws[i])
                for i, (t, s) in enumerate(zip(times, scans))]
    pipe.flush()
    return pipe, returned


def assert_bit_identical(pipe, ref):
    assert len(pipe.outputs) == len(ref.outputs)
    for a, b in zip(pipe.outputs, ref.outputs):
        for name in ("pose_r", "pose_t", "var_icp", "var_mean", "cov", "kf_cov_diag"):
            assert torch.equal(getattr(a, name).cpu(), getattr(b, name).cpu()), name
        assert a.icp_iterations == b.icp_iterations
        assert a.align_ok == b.align_ok
        assert int(a.map_points) == int(b.map_points)
        assert torch.equal(a.particles, b.particles)


def preprocess(**over):
    return dataclasses.replace(small_cfg().preprocess, **over)


class TestBatchedDispatch:
    def test_batched_dispatch_matches_sequential(self, world):
        """dispatch_batch=3 over 7 frames (the bootstrap, then two
        batches): buffered feeds return None, a filled batch returns its
        last frame, and the run is the per-frame run bit for bit, the
        generator's draws included."""
        times, scans = sequence(world, 7)
        ref, _ = run(small_cfg(), times, scans)
        packing.copies.update(upload=0, readback=0)
        pipe, returned = run(small_cfg(dispatch_batch=3), times, scans)
        assert returned[1] is None and returned[2] is None
        assert isinstance(returned[3], packing.HostFrameOutput)
        assert returned[3] is pipe.outputs[3]
        assert returned[6] is pipe.outputs[6] and len(pipe.outputs) == 7
        assert_bit_identical(pipe, ref)
        assert max(o.icp_iterations for o in pipe.outputs) > 1
        assert packing.copies == {"upload": 0, "readback": 0}   # the CPU copies nothing
        assert len(pipe.frame_timings) == 7
        # the batch's wall time is spread evenly over its frames
        b1 = [f["steinicp_time"] for f in pipe.frame_timings[1:4]]
        assert b1[0] > 0 and b1 == [b1[0]] * 3

    def test_host_downsample_with_batched_dispatch(self, world):
        """host_downsample and dispatch_batch compose (the "pre" batch)."""
        times, scans = sequence(world, 7)
        cfg_ref = small_cfg(preprocess=preprocess(host_downsample=True))
        ref, _ = run(cfg_ref, times, scans)
        pipe, rets = run(dataclasses.replace(cfg_ref, dispatch_batch=3), times, scans)
        assert rets[1] is None and rets[3] is not None  # batching engaged
        assert_bit_identical(pipe, ref)

    def test_insert_cadence_skip_matches_batched(self, world):
        """map.insert_every=3 with a batch of 4 over 8 frames (a batch,
        then 3 frames that flush() drains one at a time): the batched run
        skips the same inserts as the per-frame run."""
        times, scans = sequence(world, 8)
        cfg1 = small_cfg(map=cfg_mod.MapConfig(
            voxel_size=1.0, max_points_per_voxel=10, max_range=120.0,
            capacity=32768, insert_every=3))
        ref, _ = run(cfg1, times, scans)
        pipe, rets = run(dataclasses.replace(cfg1, dispatch_batch=4), times, scans)
        assert rets[4] is pipe.outputs[4] and rets[5:] == [None] * 3
        assert len(pipe.outputs) == len(ref.outputs) == 8
        assert_bit_identical(pipe, ref)
        counts = [int(o.map_points) for o in pipe.outputs]
        assert counts[1] == counts[2] and counts[3] > counts[2]

    def test_stage_ahead_is_off_and_kinds_flush(self, world):
        """With a batch, stage-ahead stays off (nothing pends on the worker);
        a frame of the other staging kind (a sweep with times, which takes
        the raw route without deskew) flushes the batch first, so frames
        stay in order and the run is the per-frame run's."""
        times, scans = sequence(world, 6)
        cfg = small_cfg(preprocess=preprocess(host_downsample=True), stage_ahead=True)
        tau = np.linspace(0.0, 1.0, len(scans[3]), dtype=np.float32)
        feeds = [dict(timestamps=tau if i == 3 else None) for i in range(6)]

        def go(c):
            pipe = pl.LIOPipeline(c, device="cpu")
            rets = [pipe.feed_scan(float(t), s, **f) for t, s, f in zip(times, scans, feeds)]
            assert not pipe._pending
            pipe.close()
            return pipe, rets

        ref, _ = go(dataclasses.replace(cfg, stage_ahead=False))
        pipe, rets = go(dataclasses.replace(cfg, dispatch_batch=4))
        # frames 1-2 staged "pre", frame 3 "raw" flushes them, frame 4 "pre"
        # flushes frame 3, frame 5 waits for close()
        assert rets[1] is None and rets[2] is None
        assert rets[3] is None and rets[4] is None
        assert_bit_identical(pipe, ref)

    def test_posegraph_forces_a_batch_of_one(self, world):
        times, scans = sequence(world, 4)
        cfg = small_cfg(dispatch_batch=4)
        cfg = dataclasses.replace(cfg, posegraph=dataclasses.replace(cfg.posegraph,
                                                                     enabled=True))
        pipe, rets = run(cfg, times, scans)
        assert all(r is not None for r in rets)
        assert not isinstance(rets[1], packing.HostFrameOutput)


class TestThreadedIngest:
    @pytest.mark.parametrize("batch", [1, 3])
    def test_run_threaded_matches_sequential(self, world, batch):
        """The JAX package's test on the port: 6 frames through the producer
        thread and the native ring, per frame and with a batch of 3, equal
        the per-frame run bit for bit."""
        cfg = small_cfg()
        times, rots, trans = datasets.synthetic_trajectory(6, dt=0.1, seed=9)
        scans = [world.scan_at(np.random.default_rng(50 + i), rots[i], trans[i],
                               n_points=2000) for i in range(6)]
        ref = pl.LIOPipeline(cfg, device="cpu")
        for i in range(6):
            ref.feed_scan(float(times[i]), scans[i])
        pipe = pl.LIOPipeline(dataclasses.replace(cfg, dispatch_batch=batch),
                              device="cpu")
        n = pipe.run_threaded(((float(times[i]), scans[i]) for i in range(6)),
                              ring_slots=2)
        assert n == 6
        assert_bit_identical(pipe, ref)

    def test_stream_error_is_raised_and_the_producer_stops(self, world):
        times, scans = sequence(world, 3)

        def stream():
            yield float(times[0]), scans[0]
            raise RuntimeError("sensor gone")

        pipe = pl.LIOPipeline(small_cfg(), device="cpu")
        with pytest.raises(RuntimeError, match="sensor gone"):
            pipe.run_threaded(stream())
        assert len(pipe.outputs) == 1


def test_batched_run_matches_the_jax_packages(world):
    """dispatch_batch=3 on 7 frames in float64 on both sides (JAX: two
    lax.scan batches and a remainder; the port: its batched steps), JAX's
    particle draws replayed through `init_particles`: poses to 1e-6 and
    identical iterations."""
    n = 7
    times, scans = sequence(jdatasets.SyntheticWorld(extent=40.0, seed=3), n)
    jcfg = dataclasses.replace(small_cfg(jcfg_mod), dispatch_batch=3, dtype="float64")
    with jax.enable_x64(True):
        jpipe = jpl.LIOPipeline(jcfg)
        for t, s in zip(times, scans):
            jpipe.feed_scan(float(t), s)
        jpipe.flush()
        want = jpipe.trajectory()
        want_iters = [int(o.icp_iterations) for o in jpipe.outputs]
        icp = jcfg.icp
        lb = jnp.asarray(icp.init_lb, jnp.float64)
        ub = jnp.asarray(icp.init_ub, jnp.float64)
        key = jax.random.PRNGKey(jcfg.seed)
        draws = [None]
        for _ in range(1, n):
            key, sub = jax.random.split(key)
            u = jax.random.uniform(sub, (icp.particle_count, 6), jnp.float64)
            draws.append(np.array(lb + (ub - lb) * u))
    cfg = dataclasses.replace(small_cfg(), dispatch_batch=3, dtype="float64")
    pipe, _ = run(cfg, times, scans, draws)
    assert [o.icp_iterations for o in pipe.outputs] == want_iters
    assert max(want_iters) > 1
    assert all(o.align_ok for o in pipe.outputs)
    np.testing.assert_allclose(pipe.trajectory(), want, atol=1e-6)
