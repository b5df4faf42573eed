"""The port's tools on `bench.build` and the proxy logs (`tools/torch_*.py`)
against the JAX package's tools.

- `variant_config` of the loop study and of the SubT study equals the JAX
  tools' for every variant, field by field; the loop study's pose-graph
  block is chip_smoke.py's (the loop path's).
- The KITTI writer's files are byte-identical to `tools/make_raycast_kitti.py`'s
  for the same arguments; the port's reader and `cli kitti` read them back.
- `torch_ate_check` at a tiny size (4 frames; P=8 and 512 source rows on
  both sides) gives the JAX tool's ATE within 0.02 m:
  both run float32 with their own particle draws, so the trajectories
  agree to the scale of the ensemble's spread, not to rounding.
- The profile tool's stage grouping runs on a CPU trace of the bench's
  operating point at that size, and names the port's kernels.
- The stein A/B tool runs both settings on the CPU at that size.
"""

import contextlib
import dataclasses
import importlib.util
import io
import json
import pathlib
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from svnicp_tpu.runtime import pipeline as jpl  # noqa: E402
from svnicp_tpu_torch import bench as tbench  # noqa: E402
from svnicp_tpu_torch import cli as tcli  # noqa: E402
from svnicp_tpu_torch.io import datasets  # noqa: E402

torch.set_num_threads(2)


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}",
                                                  ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


LOOP_VARIANTS = [v + s for v in ("base", "base-icp", "seg", "feat", "feat-kf")
                 for s in ("", "-plane")]


@pytest.mark.parametrize("name", LOOP_VARIANTS)
def test_loop_study_variants_are_the_jax_tool_s(name):
    port = _tool("torch_loop_study").variant_config(name)
    want = _tool("loop_study").variant_config(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(want)


def test_loop_study_posegraph_block_is_the_loop_path_s():
    tool = _tool("torch_loop_study")
    cfg = tool.with_posegraph(tool.variant_config("feat-kf-plane"))
    want = dataclasses.replace(cfg.posegraph, **chip_smoke.LOOP_POSEGRAPH)
    assert cfg.posegraph == want
    with pytest.raises(SystemExit):
        tool.variant_config("nope")


@pytest.mark.parametrize("name", ["subt", "subt-fast"])
def test_subt_speed_variants_are_the_jax_tool_s(name):
    port = _tool("torch_subt_speed").variant_config(name)
    want = _tool("subt_speed").variant_config(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(want)


def test_kitti_writer_matches_the_jax_tool(tmp_path, monkeypatch):
    args = ["--frames", "2", "--seed", "7"]
    monkeypatch.setattr(sys, "argv", ["make_raycast_kitti.py", "--out",
                                      str(tmp_path / "jax"), *args])
    _tool("make_raycast_kitti").main()
    _tool("torch_make_raycast_kitti").main(["--out", str(tmp_path / "port"), *args])
    names = ["times.txt", "poses.txt", "velodyne/000000.bin", "velodyne/000001.bin"]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes(), name
    # the port's reader reads them back
    port = tmp_path / "port"
    frames = list(datasets.kitti_sequence(str(port / "velodyne"), str(port / "times.txt")))
    raw = np.fromfile(port / "velodyne" / "000001.bin", np.float32).reshape(-1, 4)
    assert [t for t, _ in frames] == [0.0, 0.1]
    np.testing.assert_array_equal(frames[1][1], raw[:, :3])
    poses = datasets.read_kitti_poses(str(port / "poses.txt"))
    _, rots, trans = datasets.synthetic_trajectory(2, dt=0.1, speed=2.0, seed=7)
    np.testing.assert_allclose(poses[:, :3, :3], rots, atol=1e-9)
    np.testing.assert_allclose(poses[:, :3, 3], trans, atol=1e-9)
    # and so does `cli kitti`, on a configuration cut for the CPU
    cfg = tmp_path / "small.yaml"
    cfg.write_text("icp:\n  particle_count: 8\n  iterations: 20\n  knn_count: 16\n"
                   "  source_capacity: 512\n  target_capacity: 4096\n"
                   "map:\n  capacity: 16384\npreprocess:\n  raw_capacity: 147456\n"
                   "lio:\n  estimator: icp\n")
    pipe, summary = tcli.main(["kitti", "--velodyne", str(port / "velodyne"),
                               "--times", str(port / "times.txt"), "--poses",
                               str(port / "poses.txt"), "--config", str(cfg),
                               "--device", "cpu"])
    assert summary["frames"] == 2 and len(pipe.outputs) == 2
    assert all(o.align_ok for o in pipe.outputs)
    assert np.isfinite(summary["ate_rmse_m"])


def _small(cfg):
    """P=8 and 512 source rows; the target and the map keep their capacity
    (a cut map loses the scene and the registration with it)."""
    return dataclasses.replace(
        cfg, icp=dataclasses.replace(cfg.icp, particle_count=8, source_capacity=512))


@pytest.fixture
def small_bench(monkeypatch):
    """The bench's operating point at P=8 and 512 source rows, on both sides."""
    full = tbench.pipeline_config
    monkeypatch.setattr(tbench, "pipeline_config", lambda *a, **k: _small(full(*a, **k)))

    class SmallJax(jpl.LIOPipeline):
        def __init__(self, cfg, *a, **k):
            super().__init__(_small(cfg), *a, **k)

    monkeypatch.setattr(jpl, "LIOPipeline", SmallJax)


def test_ate_check_matches_the_jax_tool(small_bench, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["ate_check.py", "--frames", "4"])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        _tool("ate_check").main()
    want = json.loads(buf.getvalue().strip().splitlines()[-1])
    got = _tool("torch_ate_check").main(["--frames", "4", "--device", "cpu"])
    assert set(got) == set(want) | {"device"}
    assert got["device"] == "cpu" and got["frames"] == 4
    assert abs(got["ate_rmse_m"] - want["ate_rmse_m"]) < 0.02, (got, want)
    assert abs(got["rpe_trans_m"] - want["rpe_trans_m"]) < 0.02, (got, want)


def test_profile_grouping_runs_on_a_cpu_trace(small_bench, capsys):
    tool = _tool("torch_profile_step")
    res = tool.main(["--frames", "1", "--device", "cpu", "--top", "5"])
    out = capsys.readouterr().out
    assert "by group:" in out and "idle" in out
    assert sum(res["groups"].values()) == pytest.approx(sum(res["totals"].values()))
    assert res["groups"]["map/query sorts"] > 0
    assert res["iterations"] > 0
    # the port's kernels by their CUDA function names
    names = {"stage1_prep_kernel": 1.0, "stage1_kernel": 2.0, "plane_moments_kernel": 3.0,
             "plane_system_kernel": 4.0, "point_moments_kernel": 5.0,
             "nn_match_kernel": 6.0, "stein_kernel": 7.0,
             "void at::native::tensor_kernel_scan_innermost_dim_with_indices<long>": 8.0,
             "something else": 9.0}
    g = tool.group(names)
    assert g["B1 stage-1 candidates"] == 3.0 and g["B2 plane moments"] == 7.0
    assert g["B4 point moments"] == 5.0 and g["B5 nn match"] == 6.0
    assert g["B3 stein update"] == 7.0 and g["map run broadcasts (cummax)"] == 8.0
    assert g["other"] == 9.0


def test_stein_ab_runs_both_settings(small_bench):
    lines = _tool("torch_stein_ab").main(["--particles", "8", "--reps", "2",
                                          "--frames", "4", "--device", "cpu"])
    assert len(lines) == 1 and lines[0]["particles"] == 8
    assert len(lines[0]["kernel_on"]) == len(lines[0]["kernel_off"]) == 2
    assert lines[0]["device"] == "cpu"
