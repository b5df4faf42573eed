"""The port stands alone and never quietly runs on the CPU.

- A static scan of every module of `svnicp_tpu_torch/`, of `chip_smoke.py`,
  of the card-only test file and of the port's card tools (`tools/torch_*`)
  finds no import of jax, jaxlib or the JAX package (a static scan, because
  this test process imports JAX anyway).
- Entry points default to the card: `LIOPipeline(cfg)` raises on a host
  without CUDA, and a kernel wrapper handed non-CPU tensors launches its
  kernel or raises, never computing on the CPU instead.
"""

import ast
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from svnicp_tpu_torch import config as cfg_mod
from svnicp_tpu_torch.kernels import _build, nn, stein
from svnicp_tpu_torch.runtime import pipeline as pl

torch.set_num_threads(2)
ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "svnicp_tpu")


def _port_files():
    files = sorted((ROOT / "svnicp_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_cuda.py",
                    *sorted((ROOT / "tools").glob("torch_*.py"))]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_port_imports_nothing_of_jax():
    files = _port_files()
    assert len(files) > 15
    bad = {str(f.relative_to(ROOT)): root for f in files
           for root in _imported_roots(f) if root in FORBIDDEN}
    assert not bad, bad


def _svgd_kernel_route(cfg):
    """generic_svgd.yaml on the JAX package's kernel route for SVGD."""
    return dataclasses.replace(cfg, icp=dataclasses.replace(cfg.icp, use_pallas=True))


@pytest.mark.parametrize("name", ["tpu_plane", "geode_alpha", "subt_mrs",
                                  "generic_svgd", "tpu_features", "subt_mrs_fast"])
def test_pipeline_defaults_to_the_card(name):
    """The ported configurations construct on the CPU when asked, and the
    default device is the card."""
    cfg = cfg_mod.from_yaml(str(ROOT / "configs" / f"{name}.yaml"))
    if name == "generic_svgd":
        cfg = _svgd_kernel_route(cfg)
    pl.LIOPipeline(cfg, device="cpu").close()
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        pl.LIOPipeline(cfg)


def test_wrappers_refuse_non_cpu_tensors_instead_of_falling_back():
    """Tensors on another device than the CPU (here the meta device, which a
    host without CUDA can create) go to the kernel path, which raises."""
    x = torch.zeros((8, 3), device="meta")
    m = torch.ones(8, dtype=torch.bool, device="meta")
    before = nn.bucketed_candidates.launches
    with pytest.raises(ValueError, match="CUDA"):
        nn.bucketed_candidates(x, x, m, m, 2)
    h = torch.zeros((4, 6, 6), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        stein.stein_update(h, h[:, 0], h[:, :3, :3], h[:, 0, :3], max_dist=3.0)
    assert nn.bucketed_candidates.launches == before
    before = nn.point_moments.launches
    prep = nn.PointPrep(torch.zeros((13, 8, 4), device="meta"),
                        torch.zeros((3, 8, 4), device="meta"),
                        torch.zeros((3, 4), device="meta"),
                        torch.zeros(4, device="meta"))
    with pytest.raises(ValueError, match="CUDA"):
        nn.point_moments(torch.zeros((2, 12), device="meta"), prep, 3.0)
    assert nn.point_moments.launches == before
    before = nn.nn_match.launches
    with pytest.raises(ValueError, match="CUDA"):
        nn.nn_match(torch.zeros((2, 12), device="meta"), prep)
    assert nn.nn_match.launches == before


def test_kernel_build_needs_nvcc():
    if _build.shutil.which("nvcc"):
        pytest.skip("nvcc present")
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build_all()


def _svgd_variant(case):
    cfg = cfg_mod.from_yaml(str(ROOT / "configs" / "generic_svgd.yaml"))
    if case == "as_written":
        return cfg
    cfg = _svgd_kernel_route(cfg)
    if case == "dispatch_batch":
        return dataclasses.replace(cfg, dispatch_batch=4)
    if case == "use_minibatch":
        return dataclasses.replace(cfg, icp=dataclasses.replace(
            cfg.icp, use_minibatch=True, batch_size=1024))
    return dataclasses.replace(cfg, icp=dataclasses.replace(cfg.icp, method="svd"))


def _small_svgd(cfg):
    """The SVGD kernel route cut to a CPU-sized run."""
    return dataclasses.replace(
        cfg, icp=dataclasses.replace(cfg.icp, source_capacity=256, target_capacity=2048,
                                     iterations=3),
        map=dataclasses.replace(cfg.map, capacity=8192),
        preprocess=dataclasses.replace(cfg.preprocess, raw_capacity=4096))


@pytest.mark.parametrize("case,name", [
    # the file leaves SVGD on the XLA route (first index at ties): ported
    ("as_written", "use_pallas"),
    # the batched steps (several frames per upload and read-back): ported
    ("dispatch_batch", "dispatch_batch"),
    # the minibatch rows are the port's own draws (or given): ported
    ("use_minibatch", "use_minibatch"),
    ("svd", "method=svd")])
def test_unported_options_raise(case, name):
    """Every SVGD option the port once refused by name now constructs on
    the CPU, with generic_svgd.yaml as written and on the kernel route; a
    batch of 4 also runs there: 5 sweeps, the last 4 as one batch."""
    pl.LIOPipeline(_svgd_kernel_route(_svgd_variant("as_written")),
                   device="cpu").close()
    pl.LIOPipeline(_svgd_variant(case), device="cpu").close()
    if case != "dispatch_batch":
        return
    from svnicp_tpu_torch.io import datasets
    from svnicp_tpu_torch.runtime import packing

    world = datasets.SyntheticWorld(extent=30.0, seed=2)
    times, rots, trans = datasets.synthetic_trajectory(5, dt=0.1, speed=1.0, seed=2)
    rng = np.random.default_rng(2)
    pipe = pl.LIOPipeline(_small_svgd(_svgd_variant(case)), device="cpu")
    rets = []
    for i in range(5):
        pts, tau, _ = world.scan_sweep(rng, rots[i], trans[i], rots[i], trans[i],
                                       n_points=1500)
        rets.append(pipe.feed_scan(float(times[i]), pts, timestamps=tau))
    pipe.close()
    assert rets[1:4] == [None] * 3 and rets[4] is pipe.outputs[4]
    assert isinstance(rets[4], packing.HostFrameOutput)
    assert len(pipe.outputs) == 5 and np.isfinite(pipe.trajectory()).all()


@pytest.mark.parametrize("option", ["use_pallas", "stein_kernel"])
def test_xla_path_options_raise(option):
    """Turning off a kernel selects the JAX package's XLA route (first
    index at ties), which the port runs: the pipeline constructs, and no
    option of that route is refused any more."""
    cfg = cfg_mod.from_yaml(str(ROOT / "configs" / "tpu_plane.yaml"))
    cfg = dataclasses.replace(cfg, icp=dataclasses.replace(cfg.icp, **{option: False}))
    pl.LIOPipeline(cfg, device="cpu").close()
    for icp in (dict(svn_full_grad=True), dict(match_count=16),
                dict(candidate_method="topk"), dict(candidate_method="voxel"),
                dict(adaptive_prior=True), dict(method="svd")):
        pl.LIOPipeline(dataclasses.replace(cfg, save_particles="method" not in icp,
                                           icp=dataclasses.replace(cfg.icp, **icp)),
                       device="cpu").close()


def test_remaining_refusals_are_named():
    """The pipeline refuses nothing any more: ROADMAP A12 lifted the last
    two refusals (the sharded map and the device mesh) and
    `check_supported` is gone. Both construct on the CPU with a mesh of
    shards on one device, beside the pose graph (A11) and batched dispatch
    (A11b)."""
    from svnicp_tpu_torch.parallel import sharding

    assert not hasattr(pl, "check_supported")
    cfg = cfg_mod.from_yaml(str(ROOT / "configs" / "tpu_plane.yaml"))
    mesh_cfg = dataclasses.replace(cfg, sharding=dataclasses.replace(
        cfg.sharding, point_axis=2))
    for change in ({}, dict(map=dataclasses.replace(cfg.map, sharded=True))):
        pipe = pl.LIOPipeline(dataclasses.replace(mesh_cfg, **change), device="cpu",
                              mesh=sharding.make_mesh(1, 2, devices=["cpu"] * 2))
        assert pipe.mesh.shape == {"particle": 1, "point": 2}
        assert tuple(pipe.state.split_keys.shape) == ((1,) if change else (0,))
        pipe.close()
    pipe = pl.LIOPipeline(dataclasses.replace(cfg, posegraph=dataclasses.replace(
        cfg.posegraph, enabled=True)), device="cpu")
    assert pipe.posegraph is not None
    pipe = pl.LIOPipeline(dataclasses.replace(cfg, dispatch_batch=2), device="cpu")
    assert pipe.cfg.dispatch_batch == 2
    pipe.close()


def test_all_configs_load(tmp_path):
    """The port's own config copy reads every shipped YAML unchanged."""
    for path in sorted((ROOT / "configs").glob("*.yaml")):
        cfg_mod.from_yaml(str(path))
    bad = tmp_path / "bad.yaml"
    bad.write_text("icp:\n  nope: 1\n")
    with pytest.raises(KeyError, match="nope"):
        cfg_mod.from_yaml(str(bad))
