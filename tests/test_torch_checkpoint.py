"""The port's checkpoints (`svnicp_tpu_torch/runtime/checkpoint.py`):

- a pipeline saved after 4 frames and loaded into a fresh one continues
  exactly as the original does (the particle generator's state is saved
  with the state), on the JAX package's checkpoint scenario
  (`tests/test_checkpoint_posegraph.py` `TestCheckpoint`);
- the pose graph (keyframes, edges, keyframe clouds, closures) round-trips,
  under the same `extra_*` and `pg_*` keys as the JAX package's file;
- a checkpoint of another configuration raises on its first mismatched
  field;
- `StageTimer.reset` and `device_trace` (a torch.profiler trace written to
  a directory, with the program's spans in it).
"""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import test_checkpoint_posegraph as jtest  # noqa: E402
from svnicp_tpu import config as jcfg  # noqa: E402
from svnicp_tpu.runtime import checkpoint as jckpt  # noqa: E402
from svnicp_tpu.runtime import pipeline as jpl  # noqa: E402
from svnicp_tpu_torch import config as tcfg  # noqa: E402
from svnicp_tpu_torch.io import datasets  # noqa: E402
from svnicp_tpu_torch.runtime import checkpoint, profiling  # noqa: E402
from svnicp_tpu_torch.runtime import pipeline as tpl  # noqa: E402

torch.set_num_threads(2)


def _cfg(**over):
    return tcfg.from_dict(dataclasses.asdict(jtest.small_cfg(**over)))


def _scans(n, speed=1.5, n_points=3000):
    world = datasets.SyntheticWorld(extent=40.0, seed=3)
    times, rots, trans = datasets.synthetic_trajectory(n, dt=0.1, speed=speed, seed=5)
    rng = np.random.default_rng(0)
    return times, [world.scan_at(rng, rots[i], trans[i], n_points=n_points)
                   for i in range(n)]


def test_roundtrip_continues_identically(tmp_path):
    times, scans = _scans(8)
    cfg = _cfg()
    pipe = tpl.LIOPipeline(cfg, device="cpu")
    for i in range(4):
        pipe.feed_scan(float(times[i]), scans[i])
    path = str(tmp_path / "state.npz")
    checkpoint.save_pipeline(path, pipe)
    for i in range(4, 8):
        pipe.feed_scan(float(times[i]), scans[i])
    pipe2 = tpl.LIOPipeline(cfg, device="cpu")
    checkpoint.load_pipeline(path, pipe2)
    assert pipe2._frames == 4 and pipe2._last_frame_time == pytest.approx(times[3])
    for i in range(4, 8):
        pipe2.feed_scan(float(times[i]), scans[i])
    for a, b in zip(pipe.outputs[4:], pipe2.outputs):
        assert a.icp_iterations == b.icp_iterations
        assert torch.equal(a.pose_r, b.pose_r) and torch.equal(a.pose_t, b.pose_t)
        assert torch.equal(a.particles, b.particles)
    assert torch.equal(pipe.state.vmap.points, pipe2.state.vmap.points)


def test_posegraph_roundtrips_under_the_jax_keys(tmp_path):
    pg = dict(enabled=True, keyframe_trans_threshold=0.1, loop_min_separation=100)
    times, scans = _scans(6, speed=3.0, n_points=2000)
    pipe = tpl.LIOPipeline(_cfg(posegraph=jcfg.PoseGraphConfig(**pg)), device="cpu")
    for i in range(6):
        pipe.feed_scan(float(times[i]), scans[i])
    pipe.loop_closures.append((0, 2))       # as a verified closure would
    n_kf, n_edges = len(pipe.posegraph.nodes_r), len(pipe.posegraph.edges)
    assert n_kf >= 2
    path = str(tmp_path / "pg.npz")
    checkpoint.save_pipeline(path, pipe)
    pipe2 = tpl.LIOPipeline(_cfg(posegraph=jcfg.PoseGraphConfig(**pg)), device="cpu")
    checkpoint.load_pipeline(path, pipe2)
    g, g2 = pipe.posegraph, pipe2.posegraph
    assert len(g2.nodes_r) == n_kf and len(g2.edges) == n_edges
    assert len(pipe2._keyframe_clouds) == n_kf and pipe2.loop_closures == [(0, 2)]
    np.testing.assert_array_equal(np.stack(g2.nodes_t), np.stack(g.nodes_t))
    for a, b in zip(g.edges, g2.edges):
        assert a[:2] == b[:2]
        for x, y in zip(a[2:], b[2:]):
            np.testing.assert_array_equal(x, y)
    for (c, v), (c2, v2) in zip(pipe._keyframe_clouds, pipe2._keyframe_clouds):
        np.testing.assert_array_equal(c, c2)
        np.testing.assert_array_equal(v, v2)
    # the JAX package's file of the same kind of run holds the same extra keys
    jpipe = jpl.LIOPipeline(jtest.small_cfg(posegraph=jcfg.PoseGraphConfig(**pg)))
    for i in range(6):
        jpipe.feed_scan(float(times[i]), scans[i])
    jpipe.loop_closures.append((0, 2))
    jpath = str(tmp_path / "jax.npz")
    jckpt.save_pipeline(jpath, jpipe)
    with np.load(path) as a, np.load(jpath) as b:
        extra = sorted(k for k in a.files if k.startswith("extra_"))
        assert extra == sorted(k for k in b.files if k.startswith("extra_"))
        assert "extra_pg_edge_info" in extra and "extra_pg_clouds" in extra


def test_shape_mismatch_raises(tmp_path):
    pipe = tpl.LIOPipeline(_cfg(), device="cpu")
    path = str(tmp_path / "s.npz")
    checkpoint.save_pipeline(path, pipe)
    pipe2 = tpl.LIOPipeline(_cfg(map=jcfg.MapConfig(capacity=16384, max_range=120.0)),
                            device="cpu")
    with pytest.raises(ValueError, match="checkpoint field vmap.points"):
        checkpoint.load_pipeline(path, pipe2)
    pipe3 = tpl.LIOPipeline(dataclasses.replace(_cfg(), dtype="float64"), device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        checkpoint.load_pipeline(path, pipe3)


def test_stage_timer_reset_and_device_trace(tmp_path):
    t = profiling.StageTimer()
    with t.span("a"):
        pass
    assert t.counts["a"] == 1 and "a=" in t.report()
    t.reset()
    assert not t.totals and not t.counts and not t.last
    with profiling.device_trace(str(tmp_path / "trace")) as spans:
        with profiling.span("svnicp.frame", frame=0):
            torch.ones(8).sum()
    files = list((tmp_path / "trace").iterdir())
    assert files and all(f.name.endswith(".json") for f in files)
    # the program's spans are written beside the host's operations
    assert '"svnicp.frame"' in files[0].read_text()
    assert [s.name for s in spans.spans] == ["svnicp.frame"]
