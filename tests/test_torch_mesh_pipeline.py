"""The port's pipeline on a device mesh beyond the sharded map's parity
(tests/test_torch_map_sharded_pipeline.py), on the in-process mesh with
its shards on `cpu`, at the dry run's float64 operating point
(`chip_smoke.dryrun_config`) cut to 10 iterations a frame:
- the replicated-map mesh mode (map whole, each point shard searching it
  by index) against the port's single-device run: poses to 1e-9 (the
  psum order is all that differs), the same iterations;
- batched dispatch (dispatch_batch 3) on a mesh equals per-frame dispatch
  bit for bit, in the replicated-map mode and with the sharded map
  (rebalance off: the JAX package's batch path does not rebalance);
- a checkpoint after 3 frames of a sharded-map run keeps the split keys,
  and the resumed run repeats the uninterrupted one bit for bit;
- a mesh run of an SVGD configuration takes the sharded SVN route, as the
  JAX package's does (the mesh branch comes first): the same poses as
  method svn, and `svgd.register` is never called.
"""

import dataclasses
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402
from svnicp_tpu_torch import config as tcfg  # noqa: E402
from svnicp_tpu_torch.core import svgd  # noqa: E402
from svnicp_tpu_torch.parallel import sharding  # noqa: E402
from svnicp_tpu_torch.runtime import checkpoint  # noqa: E402
from svnicp_tpu_torch.runtime import pipeline as tpl  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def inputs():
    return chip_smoke.dryrun_inputs(6, 2000)


def _cfg(sharded: bool, **over):
    cfg = chip_smoke.dryrun_config(tcfg, 2, 2, sharded=True)
    cfg = dataclasses.replace(
        cfg, icp=dataclasses.replace(cfg.icp, iterations=10),
        map=dataclasses.replace(cfg.map, sharded=sharded))
    return dataclasses.replace(cfg, **over)


def _mesh():
    return sharding.make_mesh(2, 2, devices=["cpu"] * 4)


def _feed(pipe, inputs, lo=0, hi=None):
    hi = len(inputs["scans"]) if hi is None else hi
    for i in range(lo, hi):
        pipe.feed_scan(float(inputs["times"][i]), inputs["scans"][i])


def _run(cfg, inputs, mesh=True):
    pipe = tpl.LIOPipeline(cfg, device="cpu", mesh=_mesh() if mesh else None)
    for sample in inputs["imu"]:
        pipe.feed_imu(*sample)
    _feed(pipe, inputs)
    pipe.close()
    return pipe


def test_replicated_map_mesh_matches_single_device(inputs):
    mesh_run = _run(_cfg(False), inputs)
    single = _run(dataclasses.replace(_cfg(False), sharding=tcfg.ShardingConfig()),
                  inputs, mesh=False)
    assert mesh_run.mesh is not None and single.mesh is None
    np.testing.assert_allclose(mesh_run.trajectory(), single.trajectory(), atol=1e-9)
    assert [o.icp_iterations for o in mesh_run.outputs] == \
        [o.icp_iterations for o in single.outputs]
    assert mesh_run.rebalances == 0


@pytest.mark.parametrize("sharded", [False, True], ids=["replicated_map", "sharded_map"])
def test_batched_dispatch_on_a_mesh_is_per_frame_dispatch(inputs, sharded):
    cfg = _cfg(sharded)
    cfg = dataclasses.replace(cfg, map=dataclasses.replace(cfg.map, rebalance_every=0))
    per_frame = _run(cfg, inputs)
    batched = _run(dataclasses.replace(cfg, dispatch_batch=3), inputs)
    np.testing.assert_array_equal(batched.trajectory(), per_frame.trajectory())
    for a, b in zip(batched.outputs, per_frame.outputs):
        assert a.icp_iterations == b.icp_iterations
        np.testing.assert_array_equal(np.asarray(a.var_icp), b.var_icp.numpy())
    assert batched.rebalances == per_frame.rebalances == (1 if sharded else 0)


def test_checkpoint_keeps_split_keys(inputs, tmp_path):
    """On a (1, 4) mesh, where the first rebalance moves the boundaries (the
    ICP estimator: a checkpoint does not carry queued IMU samples)."""
    cfg = chip_smoke.dryrun_config(tcfg, 1, 4, sharded=True)
    cfg = dataclasses.replace(cfg, icp=dataclasses.replace(cfg.icp, iterations=10),
                              lio=dataclasses.replace(cfg.lio, estimator="icp"))

    def mesh():
        return sharding.make_mesh(1, 4, devices=["cpu"] * 4)

    whole = tpl.LIOPipeline(cfg, device="cpu", mesh=mesh())
    _feed(whole, inputs)
    first = tpl.LIOPipeline(cfg, device="cpu", mesh=mesh())
    _feed(first, inputs, 0, 3)
    path = str(tmp_path / "mesh.npz")
    checkpoint.save_pipeline(path, first)
    resumed = tpl.LIOPipeline(cfg, device="cpu", mesh=mesh())
    checkpoint.load_pipeline(path, resumed)
    np.testing.assert_array_equal(resumed.state.split_keys.numpy(),
                                  first.state.split_keys.numpy())
    assert not np.array_equal(resumed.state.split_keys.numpy(),
                              tpl.init_state(cfg, "cpu").split_keys.numpy())
    _feed(resumed, inputs, 3)
    np.testing.assert_array_equal(resumed.trajectory(), whole.trajectory()[3:])
    np.testing.assert_array_equal(resumed.state.vmap.key.numpy(),
                                  whole.state.vmap.key.numpy())


def test_svgd_config_on_a_mesh_takes_the_svn_route(inputs, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("svgd.register ran on a mesh")

    monkeypatch.setattr(svgd, "register", refuse)
    cfg = _cfg(False)
    as_svgd = _run(dataclasses.replace(cfg, icp=dataclasses.replace(cfg.icp, method="svgd")),
                   inputs)
    as_svn = _run(cfg, inputs)
    np.testing.assert_array_equal(as_svgd.trajectory(), as_svn.trajectory())
    assert [o.icp_iterations for o in as_svgd.outputs] == \
        [o.icp_iterations for o in as_svn.outputs]
