"""The port's bench (`svnicp_tpu_torch.bench`) against the JAX package's
`bench.py`.

- For each of its modes, `pipeline_config` is the configuration the JAX
  package's `bench.build` builds, field by field.
- The scans of the default and the segmentation modes are the JAX
  recipe's, byte for byte.
- `run` on the CPU at a tiny size (P=8, 5 iterations, 3 + 2 frames,
  `repeat=3`, the capacities cut: source 512, target 4,096, map 8,192)
  returns 3 samples of equal iteration totals after a pass it does not
  record.
- `main()` prints one JSON line with the JAX line's keys and `quartiles`,
  `iterations` and `device`; without CUDA it raises unless
  `--cpu-baseline` is given, which writes only under build/.
- The first 3 frames of the default row through both pipelines, in
  float64 on the CPU on the same scans with the JAX package's particle
  draws, on the XLA route of both (`--no-pallas`: the first index at
  stage-1 ties, which the int16 grid makes) and at cut capacities (P=8,
  source 512, target 4,096, map 8,192), agree to 1e-9 m with identical
  iterations.
"""

import dataclasses
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import bench as jbench  # noqa: E402
from svnicp_tpu_torch import bench as tbench  # noqa: E402
from svnicp_tpu_torch.runtime import pipeline as tpl  # noqa: E402

torch.set_num_threads(2)

MODES = {
    "default": [],
    "point_to_point": ["--residual", "point_to_point"],
    "svgd": ["--icp-method", "svgd"],
    "svd": ["--icp-method", "svd"],
    "segmentation": ["--segmentation"],
    "features": ["--features"],
    "batch4": ["--batch", "4"],
    "insert_every2": ["--insert-every", "2"],
    "no_pallas": ["--no-pallas"],
    "no_stein_kernel": ["--no-stein-kernel"],
    "topk": ["--method", "topk"],
    "voxel": ["--method", "voxel"],
}
# the JAX line's keys (bench.py:282-290) and the port's additions
JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "runs"}
NEW_KEYS = {"quartiles", "iterations", "device"}


def _kwargs(flags) -> dict:
    return tbench.run_kwargs(tbench.parser().parse_args(flags))


def _small(cfg, particles=None):
    """The capacities cut for the CPU (and the particles, when given)."""
    icp = dict(source_capacity=512, target_capacity=4096)
    if particles:
        icp["particle_count"] = particles
    return dataclasses.replace(cfg, icp=dataclasses.replace(cfg.icp, **icp),
                               map=dataclasses.replace(cfg.map, capacity=8192))


@pytest.mark.parametrize("mode", MODES)
def test_config_is_the_jax_bench_s(mode):
    kw = _kwargs(MODES[mode])
    jpipe, _, _ = jbench.build(0, **kw)   # no frame: no scan to make
    assert dataclasses.asdict(tbench.pipeline_config(**kw)) == \
        dataclasses.asdict(jpipe.cfg)


def test_build_default_residual_is_point_to_point():
    """build's own default, which the tools rely on, is point-to-point;
    main()'s is point-to-plane, as in the JAX package."""
    assert dataclasses.asdict(tbench.pipeline_config(64)) == \
        dataclasses.asdict(jbench.build(0, 64)[0].cfg)
    assert tbench.pipeline_config(64).icp.residual == "point_to_point"
    assert tbench.parser().parse_args([]).residual == "point_to_plane"


@pytest.mark.parametrize("mode", ["default", "segmentation"])
def test_scans_are_the_jax_recipe_s(mode):
    kw = _kwargs(MODES[mode])
    _, jtimes, jscans = jbench.build(3, **kw)
    times, rots, trans, scans = tbench.sequence(3, raycast=kw["segmentation"])
    np.testing.assert_array_equal(times, jtimes)
    assert len(scans) == len(jscans) == 3
    for a, b in zip(scans, jscans):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_run_on_the_cpu_takes_repeat_samples(monkeypatch):
    full = tbench.pipeline_config
    monkeypatch.setattr(tbench, "pipeline_config", lambda *a, **k: _small(full(*a, **k)))
    res = tbench.run(5, 3, particles=8, iterations=5, use_pallas=True,
                     residual="point_to_plane", repeat=3, device="cpu")
    assert len(res.samples) == len(res.iterations) == 3
    assert res.passes == 4
    assert all(s > 0 for s in res.samples)
    assert len(set(res.iterations)) == 1 and res.iterations[0] > 0
    assert res.pipe.device.type == "cpu" and len(res.pipe.outputs) == 5
    assert all(o.align_ok for o in res.pipe.outputs)


def test_frame_counts_are_bench_py_s():
    def counts(*flags):
        return tbench.frame_counts(tbench.parser().parse_args(list(flags)))

    assert counts() == (3, 40)
    assert counts("--insert-every", "4") == (5, 40)
    assert counts("--batch", "4") == (9, 40)
    assert counts("--batch", "3") == (7, 42)
    assert counts("--segmentation") == counts("--features") == (3, 20)


def _fake_run(**kw):
    return tbench.BenchRun([10.0, 12.0, 11.0], [300, 300, 300], 4, None)


def test_main_prints_one_line_with_the_jax_keys(monkeypatch, capsys, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tbench, "run", _fake_run)
    monkeypatch.setattr(tbench, "nvidia_smi_line", lambda: "a card, 700.00 W")
    monkeypatch.setattr(tbench, "BASELINE_FILE", tmp_path / "none.json")
    rec = tbench.main(["--icp-method", "svgd"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and json.loads(lines[0]) == rec
    assert set(rec) == JAX_KEYS | NEW_KEYS
    assert rec["metric"] == "lidar_frames_per_sec_per_chip_64_particles_svgd"
    assert rec["value"] == 11.0 and rec["runs"] == [10.0, 12.0, 11.0]
    assert rec["quartiles"] == [10.5, 11.5]
    assert rec["iterations"] == [300, 300, 300]
    assert rec["vs_baseline"] is None and rec["device"] == "a card, 700.00 W"


def test_main_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tbench, "run", _fake_run)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbench.main([])


def test_cpu_baseline_writes_under_build(monkeypatch, capsys, tmp_path):
    """--cpu-baseline runs on the CPU and writes the port's own figure,
    which vs_baseline then divides by."""
    seen = {}

    def fake(**kw):
        seen.update(kw)
        return tbench.BenchRun([0.5], [10], 1, None)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tbench, "run", fake)
    monkeypatch.setattr(tbench, "BASELINE_FILE", tmp_path / "build" / "b.json")
    rec = tbench.main(["--cpu-baseline"])
    assert seen == dict(n_frames=6, warmup=2, device="cpu")
    assert json.loads(capsys.readouterr().out) == rec
    assert rec["metric"] == "cpu_baseline_frames_per_sec" and rec["value"] == 0.5
    assert json.loads((tmp_path / "build" / "b.json").read_text()) == rec
    assert tbench.cpu_baseline_fps() == 0.5


def test_cpu_baseline_file_lies_under_build():
    """build/ is ignored by git; the JAX package's cpu_baseline.json is
    another file."""
    root = pathlib.Path(tbench.__file__).resolve().parents[1]
    assert tbench.BASELINE_FILE == root / "build" / "svnicp_tpu_torch" / "cpu_baseline.json"
    assert "build/" in (root / ".gitignore").read_text().splitlines()


N_PARITY = 3


def _jax_draws(cfg, n_frames):
    """The JAX pipeline's per-frame particle draws: the state key split once
    per aligned frame, uniform in the particle box."""
    icp = cfg.icp
    lb = jnp.asarray(icp.init_lb, jnp.float64)
    ub = jnp.asarray(icp.init_ub, jnp.float64)
    key, draws = jax.random.PRNGKey(cfg.seed), [None]
    for _ in range(1, n_frames):
        key, sub = jax.random.split(key)
        u = jax.random.uniform(sub, (icp.particle_count, 6), jnp.float64)
        draws.append(np.array(lb + (ub - lb) * u))
    return draws


def test_first_frames_match_jax_float64():
    from svnicp_tpu.runtime import pipeline as jpl

    kw = _kwargs(["--no-pallas"])
    _, times, scans = jbench.build(N_PARITY, **kw)
    with jax.enable_x64(True):
        jpipe = jbench.build(0, **kw)[0]
        jcfg = dataclasses.replace(_small(jpipe.cfg, particles=8), dtype="float64")
        jpipe = jpl.LIOPipeline(jcfg)
        for i in range(N_PARITY):
            jpipe.feed_scan(float(times[i]), scans[i])
        jpipe.close()
        want = jpipe.trajectory()
        want_iters = [int(o.icp_iterations) for o in jpipe.outputs]
        draws = _jax_draws(jcfg, N_PARITY)
    cfg = dataclasses.replace(_small(tbench.pipeline_config(**kw), particles=8),
                              dtype="float64")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    pipe = tpl.LIOPipeline(cfg, device="cpu")
    for i in range(N_PARITY):
        pipe.feed_scan(float(times[i]), scans[i], init_particles=draws[i])
    pipe.close()
    assert [o.icp_iterations for o in pipe.outputs] == want_iters
    assert all(o.align_ok for o in pipe.outputs)
    np.testing.assert_allclose(pipe.trajectory(), want, rtol=0, atol=1e-9)
