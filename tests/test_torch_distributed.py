"""The port's multi-process runtime (`parallel/distributed.py`): 4 gloo
ranks on this host, one shard each of a (2, 2) mesh, run
tests/distributed_worker.py's program on the port
(`chip_smoke.distributed_rank`: the dry run's float64 sharded-map pipeline,
5 frames of 2,000 points, the re-anchor after frame 2), started with
torch.multiprocessing and stopped after 300 s. Every rank's trajectory
must stay below 1e-4 m of
- the port's in-process (2, 2) mesh on the same frames (the same psum
  order on both, so the two agree to rounding of the host copies: 0 here);
- the JAX package's single-process (2, 2) run of the same program on the
  suite's simulated devices (tests/test_distributed.py's contract), whose
  particle draws every run replays.
"""

import os
import pathlib
import sys

import jax
import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent))

import chip_smoke  # noqa: E402
from svnicp_tpu import config as jcfg  # noqa: E402
from svnicp_tpu_torch import config as tcfg  # noqa: E402
from svnicp_tpu_torch.parallel import distributed, sharding  # noqa: E402
from test_torch_map_sharded_pipeline import jax_draws, jax_dryrun  # noqa: E402

torch.set_num_threads(1)


def test_four_gloo_ranks_match_the_mesh_and_jax(tmp_path):
    inputs = chip_smoke.dryrun_inputs(5, 2000)
    with jax.enable_x64(True):
        cfg = chip_smoke.dryrun_config(jcfg, 2, 2, sharded=True)
        want = jax_dryrun(cfg, inputs, 2)
        draws = jax_draws(cfg, 5)
        want_traj = want.trajectory()
    assert want.reanchors == 1
    ranks = chip_smoke.run_distributed(4, "cpu", str(tmp_path), timeout_s=300.0,
                                       draws=draws)
    mesh = sharding.make_mesh(2, 2, devices=["cpu"] * 4)
    inproc = chip_smoke.run_dryrun(chip_smoke.dryrun_config(tcfg, 2, 2, sharded=True),
                                   inputs, 2, "cpu", mesh=mesh, draws=draws).trajectory()
    assert len(ranks) == 4
    for traj in ranks:
        assert traj.shape == (5, 4, 4) and np.isfinite(traj).all()
        for ref in (inproc, want_traj):
            drift = np.linalg.norm(traj[:, :3, 3] - ref[:, :3, 3], axis=1)
            assert drift.max() < 1e-4, drift
    assert not distributed.is_multiprocess()


def test_initialize_reads_the_environment(monkeypatch):
    for name in ("SVNICP_COORDINATOR", "SVNICP_NUM_PROCESSES", "SVNICP_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    assert distributed.maybe_initialize_from_env() is False
    monkeypatch.setenv("SVNICP_NUM_PROCESSES", "2")
    try:
        distributed.initialize()
    except ValueError as e:
        assert "SVNICP_COORDINATOR" in str(e)
    else:
        raise AssertionError("initialize without a coordinator must raise")
    assert os.environ.get("SVNICP_COORDINATOR") is None


def test_replicate_puts_every_tensor_on_the_mesh_device():
    mesh = sharding.make_mesh(1, 2, devices=["cpu"] * 2)
    t = torch.arange(3.0)
    out = distributed.replicate({"a": (t, [t, 1])}, mesh)
    assert out["a"][0].device == mesh.device and out["a"][1][1] == 1
    assert torch.equal(out["a"][1][0], t)


MESH_YAML = """icp:
  particle_count: 8
  iterations: 10
  knn_count: 16
  max_dist: 2.8
  source_capacity: 512
  target_capacity: 4096
map:
  capacity: 16384
  max_points_per_voxel: 10
  sharded: true
  rebalance_every: 2
preprocess:
  raw_capacity: 8192
  max_range: 50.0
lio:
  estimator: kf
sharding:
  particle_axis: 1
  point_axis: 2
"""


def test_cli_joins_the_process_group(tmp_path, monkeypatch):
    """`cli demo` launched twice with SVNICP_COORDINATOR, _NUM_PROCESSES and
    _PROCESS_ID runs the sharded-map configuration one shard per process;
    both ranks' summaries equal the in-process (1, 2) mesh's (time aside)."""
    import json
    import socket
    import subprocess

    from svnicp_tpu_torch import cli

    cfg = tmp_path / "mesh.yaml"
    cfg.write_text(MESH_YAML)
    argv = ["demo", "--config", str(cfg), "--frames", "5", "--points", "3000",
            "--device", "cpu"]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = str(pathlib.Path(__file__).resolve().parents[1])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "svnicp_tpu_torch.cli", *argv],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=str(tmp_path),
        env=dict(os.environ, PYTHONPATH=root, SVNICP_COORDINATOR=f"127.0.0.1:{port}",
                 SVNICP_NUM_PROCESSES="2", SVNICP_PROCESS_ID=str(rank)))
        for rank in range(2)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]

    def summary(text):
        got = json.loads(text.strip().splitlines()[-1])
        return {k: v for k, v in got.items() if k not in ("wall_seconds", "frames_per_sec")}

    monkeypatch.setattr(sharding, "make_mesh",
                        lambda p, q, devices=None, kind=None:
                        sharding.Mesh(["cpu"] * (p * q), p, q))
    pipe, want = cli.main(argv)
    assert pipe.mesh.shape == {"particle": 1, "point": 2} and pipe.rebalances >= 3
    want = summary(json.dumps(want))
    assert summary(outs[0][0]) == summary(outs[1][0]) == want
