"""The port's command line (`svnicp_tpu_torch/cli.py`) against the JAX
package's `svnicp_tpu/cli.py` on the same arguments, on the CPU
(`--device cpu`) at a cut-down configuration (P=8, K=16, 512 source rows,
a 4,096-row target, 2,000-point scans):

- `record` then `stream`, and `demo --frames 4 --output ...`: the summary's
  keys, the frame count and the JSONL records' types in order equal the
  JAX CLI's, and both ATEs agree within 1e-2 m (two float32 runs);
- `kitti` on a small velodyne directory the test writes (`.bin` records
  of x, y, z, intensity, `times.txt`, `poses.txt`, the layout
  tools/make_raycast_kitti.py writes), with and without
  `--kitti-correction`, whose points and pseudo-times equal the JAX
  package's `kitti_vertical_correction` within 1e-5;
- `metrics.rpe`, `nees`, `ate_rmse` with every alignment and
  `umeyama_alignment(with_scale=True)` equal the JAX package's.
"""

import json

import numpy as np
import pytest
import torch

from svnicp_tpu import cli as jcli
from svnicp_tpu.core import pointcloud as jpc
from svnicp_tpu.io import metrics as jmetrics
from svnicp_tpu_torch import cli as tcli
from svnicp_tpu_torch.core import geometry as tgeo
from svnicp_tpu_torch.core import pointcloud as tpc
from svnicp_tpu_torch.io import datasets
from svnicp_tpu_torch.io import metrics as tmetrics

torch.set_num_threads(2)

SMALL = """icp:
  particle_count: 8
  iterations: 20
  knn_count: 16
  max_dist: 2.8
  source_capacity: 512
  target_capacity: 4096
map:
  capacity: 16384
  max_points_per_voxel: 10
preprocess:
  raw_capacity: 8192
  max_range: 50.0
lio:
  estimator: {estimator}
"""


def _config(tmp_path, estimator="kf"):
    path = tmp_path / f"small_{estimator}.yaml"
    path.write_text(SMALL.format(estimator=estimator))
    return str(path)


def _jax(capsys, argv) -> dict:
    capsys.readouterr()
    jcli.main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _types(path) -> list:
    with open(path) as f:
        return [json.loads(line)["_type"] for line in f]


def _same(jsum, tsum, jout, tout):
    assert sorted(jsum) == sorted(tsum)
    assert jsum["frames"] == tsum["frames"]
    assert _types(jout) == _types(tout)
    if "ate_rmse_m" in jsum:
        assert abs(jsum["ate_rmse_m"] - tsum["ate_rmse_m"]) < 1e-2


def test_record_and_stream_match_jax(tmp_path, capsys):
    cfg = _config(tmp_path)
    logs = {}
    for name, mod in (("jax", jcli), ("port", tcli)):
        log, gt = tmp_path / f"{name}.svnl", tmp_path / f"{name}_gt.npy"
        mod.main(["record", "--log", str(log), "--frames", "5", "--points", "2000",
                  "--gt", str(gt)])
        logs[name] = (log, gt)
    assert logs["jax"][0].read_bytes() == logs["port"][0].read_bytes()
    np.testing.assert_array_equal(np.load(logs["jax"][1]), np.load(logs["port"][1]))
    log, gt = (str(p) for p in logs["port"])
    jout, tout = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    jsum = _jax(capsys, ["stream", "--log", log, "--config", cfg, "--gt", gt,
                         "--output", str(jout)])
    pipe, tsum = tcli.main(["stream", "--log", log, "--config", cfg, "--gt", gt,
                            "--output", str(tout), "--device", "cpu"])
    _same(jsum, tsum, jout, tout)
    assert _types(tout)[:3] == ["ParametersRecord", "RuntimeRecord", "OdometryRecord"]
    assert "KFGainRecord" in _types(tout) and len(pipe.outputs) == 5


@pytest.mark.parametrize("save_particles", [False, True])
def test_demo_matches_jax(tmp_path, capsys, save_particles):
    cfg = _config(tmp_path)
    jout, tout = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    argv = ["demo", "--frames", "4", "--points", "2000", "--config", cfg]
    if save_particles:
        argv.append("--save-particles")
    jsum = _jax(capsys, argv + ["--output", str(jout)])
    _, tsum = tcli.main(argv + ["--output", str(tout), "--device", "cpu"])
    _same(jsum, tsum, jout, tout)
    assert ("ParticleHistoryRecord" in _types(tout)) == save_particles


def _velodyne(tmp_path, n=4):
    world = datasets.SyntheticWorld(extent=40.0, seed=2)
    times, rots, trans = datasets.synthetic_trajectory(n, dt=0.1, speed=2.0, seed=2)
    rng = np.random.default_rng(2)
    vel = tmp_path / "velodyne"
    vel.mkdir()
    for i in range(n):
        pts = world.scan_at(rng, rots[i], trans[i], n_points=2000)
        rec = np.zeros((len(pts), 4), np.float32)
        rec[:, :3] = pts
        rec[:, 3] = 0.5
        rec.tofile(vel / f"{i:06d}.bin")
    np.savetxt(tmp_path / "times.txt", times, fmt="%.6f")
    poses = np.concatenate([rots, trans[:, :, None]], axis=2).reshape(-1, 12)
    np.savetxt(tmp_path / "poses.txt", poses, fmt="%.9f")
    return vel


@pytest.mark.parametrize("correction", [False, True])
def test_kitti_matches_jax(tmp_path, capsys, correction):
    vel = _velodyne(tmp_path)
    cfg = _config(tmp_path, "icp")
    argv = ["kitti", "--velodyne", str(vel), "--times", str(tmp_path / "times.txt"),
            "--poses", str(tmp_path / "poses.txt"), "--config", cfg,
            "--max-frames", "3"]
    if correction:
        argv.append("--kitti-correction")
    jout, tout = tmp_path / "j.jsonl", tmp_path / "t.jsonl"
    jsum = _jax(capsys, argv + ["--output", str(jout)])
    _, tsum = tcli.main(argv + ["--output", str(tout), "--device", "cpu"])
    _same(jsum, tsum, jout, tout)
    assert tsum["frames"] == 3 and {"rpe_trans_m", "rpe_rot_rad"} <= set(tsum)
    poses = datasets.read_kitti_poses(str(tmp_path / "poses.txt"))
    assert poses.shape == (4, 4, 4)
    frames = list(datasets.kitti_sequence(str(vel), str(tmp_path / "times.txt")))
    assert [t for t, _ in frames] == pytest.approx([0.0, 0.1, 0.2, 0.3])
    if correction:
        pts = frames[1][1]
        jp, jt = (np.asarray(x) for x in jpc.kitti_vertical_correction(pts))
        tp, tt = (x.numpy() for x in tpc.kitti_vertical_correction(torch.from_numpy(pts)))
        np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-5)
        np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-5)


def _poses(n, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    out = np.tile(np.eye(4), (n, 1, 1))
    for i in range(n):
        out[i, :3, :3] = tgeo.so3_exp(torch.from_numpy(rng.normal(scale=0.3, size=3))
                                      ).numpy()
        out[i, :3, 3] = rng.normal(scale=scale * 5, size=3)
    return out


def test_metrics_match_jax():
    est, gt, guess = _poses(30, 1), _poses(30, 2), _poses(30, 3)
    for delta in (1, 3):
        assert tmetrics.rpe(est, gt, delta) == jmetrics.rpe(est, gt, delta)
    rng = np.random.default_rng(4)
    a = rng.normal(size=(30, 6, 6))
    covs = a @ a.transpose(0, 2, 1) + 1e-3 * np.eye(6)
    covs[5] = 0.0                                  # singular: skipped by both
    got, want = tmetrics.nees(est, gt, guess, covs), jmetrics.nees(est, gt, guess, covs)
    assert got[0] == want[0] and len(got[1]) == 29
    np.testing.assert_array_equal(got[1], want[1])
    for align in ("umeyama", "first", "none"):
        assert tmetrics.ate_rmse(est, gt, align) == jmetrics.ate_rmse(est, gt, align)
    got = tmetrics.umeyama_alignment(est[:, :3, 3], gt[:, :3, 3], with_scale=True)
    want = jmetrics.umeyama_alignment(est[:, :3, 3], gt[:, :3, 3], with_scale=True)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y)
    r = tgeo.so3_exp(torch.tensor([1e-9, 0.0, 0.0], dtype=torch.float64)).numpy()
    np.testing.assert_array_equal(tmetrics._so3_log_np(r), jmetrics._so3_log_np(r))


def test_cli_defaults_to_the_card(tmp_path):
    """Without --device the pipeline asks for the card, which this host
    lacks: the command raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    log = tmp_path / "r.svnl"
    tcli.main(["record", "--log", str(log), "--frames", "2", "--points", "500"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["stream", "--log", str(log), "--config", _config(tmp_path)])
