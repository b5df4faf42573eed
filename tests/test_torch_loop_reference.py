"""Where `chip_smoke.py`'s limits for the loop path come from.

The loop path is tools/loop_study.py's ring-cloud loop played from a log:
246 motion-distorted HDL-64 proxy frames on a 6 m circle with the scans
capped at 9 m (`io/stream.record_proxy(path_shape="loop")`, seed 3), and
configs/tpu_features.yaml (loop_study's `feat-kf-plane` variant) with
loop_study's pose-graph block: keyframes every 1.5 m, loop candidates
within 4 m and 12 keyframes apart, verified by a 60-iteration P=8, K=32
registration on the kernel route, re-anchoring on. `chip_smoke.py` writes
the log with the port's recorder and the configuration as a YAML
(`write_loop_files`); the JAX run below reads that same log, so the limit
is taken on identical frames. Run this file as a script to repeat it (the
JAX package's float32 LIOPipeline on the CPU, its kernel route taking the
XLA fallback there as in the other reference scripts; some tens of
minutes):

    JAX_PLATFORMS=cpu python tests/test_torch_loop_reference.py

It prints one JSON line: ATE against the mid-sweep poses, the final
position error, the closures, re-anchors and rejected re-anchors, the
iterations and align_ok per frame, and the limit max(1.5 ATE, ATE + 0.05 m).
With `--odometry` it runs the same configuration without the pose graph.
"""

import json
import pathlib
import sys
import tempfile

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

LOOP_STUDY = ROOT / "tools" / "loop_study.py"


def test_chip_smoke_limit_follows_the_rule():
    ate = chip_smoke.LOOP_JAX_ATE
    assert chip_smoke.LOOP_ATE_LIMIT == max(1.5 * ate, ate + 0.05)
    assert len(chip_smoke.LOOP_JAX_ALIGN_OK) == chip_smoke.LOOP_LOG["n_frames"]


def test_loop_log_and_config_are_loop_studys(tmp_path):
    """chip_smoke's log parameters are loop_study's defaults and its
    pose-graph block is loop_study's; the YAML it writes loads to
    configs/tpu_features.yaml plus that block, which is loop_study's
    feat-kf-plane variant (up to the spelling of SVGD's optimizer)."""
    import ast
    import dataclasses

    from svnicp_tpu import config as jcfg
    from svnicp_tpu_torch import config as tcfg

    tree = ast.parse(LOOP_STUDY.read_text())
    defaults = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "add_argument"
                and node.args[0].value in ("--frames", "--scan-range", "--loop-radius", "--seed")):
            defaults[node.args[0].value] = next(
                ast.literal_eval(k.value) for k in node.keywords if k.arg == "default")
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "replace"
                and node.args and getattr(node.args[0], "attr", "") == "posegraph"):
            block = {k.arg: ast.literal_eval(k.value) for k in node.keywords}
    log = chip_smoke.LOOP_LOG
    assert (log["n_frames"], log["scan_range"], log["loop_radius"], log["seed"]) == (
        defaults["--frames"], defaults["--scan-range"], defaults["--loop-radius"],
        defaults["--seed"])
    assert log["path_shape"] == "loop"
    assert block == chip_smoke.LOOP_POSEGRAPH

    sys.path.insert(0, str(LOOP_STUDY.parent))
    import loop_study

    want = loop_study.variant_config("feat-kf-plane")
    # the one difference: proxy_hdl64.yaml spells SVGD's optimizer "Adam",
    # which the SVN path never reads
    assert want.icp.optimizer == "Adam"
    want = dataclasses.replace(
        want, icp=dataclasses.replace(want.icp, optimizer="adam"),
        posegraph=dataclasses.replace(want.posegraph, **block))
    cfg_path = tmp_path / "graph.yaml"
    cfg_path.write_text((ROOT / "configs" / "tpu_features.yaml").read_text())
    import unittest.mock as mock

    with mock.patch("svnicp_tpu_torch.io.stream.record_proxy",
                    side_effect=lambda path, **kw: open(path, "wb").close() or np.eye(4)[None]):
        _, _, graph_yaml = chip_smoke.write_loop_files(str(tmp_path), posegraph=True)
        _, _, odo_yaml = chip_smoke.write_loop_files(str(tmp_path), posegraph=False)
    assert jcfg.from_yaml(graph_yaml) == want
    assert jcfg.from_yaml(odo_yaml) == jcfg.from_yaml(str(ROOT / "configs" / "tpu_features.yaml"))
    assert tcfg.from_yaml(graph_yaml).posegraph == tcfg.PoseGraphConfig(
        **{**dataclasses.asdict(tcfg.PoseGraphConfig()), **block})


def jax_run(directory: str, posegraph: bool = True) -> dict:
    """The JAX package's float32 loop run on chip_smoke's log and config
    (without the pose-graph block when `posegraph` is False)."""
    import time

    from svnicp_tpu import config as cfg_mod
    from svnicp_tpu.io import metrics
    from svnicp_tpu.io import stream
    from svnicp_tpu.runtime import pipeline as pl

    log, gt_path, cfg_path = chip_smoke.write_loop_files(directory, posegraph)
    cfg = cfg_mod.from_yaml(cfg_path)
    gt = np.load(gt_path)
    pipe = pl.LIOPipeline(cfg)
    t0 = time.perf_counter()

    def progress(n, stamp):
        if n % 20 == 0:
            print(f"frame {n} at {time.perf_counter() - t0:.0f} s, closures "
                  f"{pipe.loop_closures}", file=sys.stderr, flush=True)

    with open(log, "rb") as f:
        n = stream.play(pipe, f, progress=progress)
    pipe.close()
    est = pipe.trajectory()
    ate = metrics.ate_rmse(est, gt)
    err = np.linalg.norm(est[:, :3, 3] - gt[:, :3, 3], axis=1)
    graph = {}
    if posegraph:
        graph = {"loop_closures": [list(map(int, c)) for c in pipe.loop_closures],
                 "keyframes": len(pipe.posegraph.nodes_r), "reanchors": pipe.reanchors,
                 "reanchors_rejected": pipe.reanchors_rejected,
                 "loop_edges_pruned": pipe.loop_edges_pruned}
    return {"frames": n, "dtype": cfg.dtype, "posegraph": posegraph, "ate_m": ate,
            "final_pos_err_m": float(err[-1]), **graph,
            "iterations": [int(o.icp_iterations) for o in pipe.outputs],
            "align_ok": [bool(o.align_ok) for o in pipe.outputs],
            "limit_m": max(1.5 * ate, ate + 0.05)}


if __name__ == "__main__":
    with tempfile.TemporaryDirectory() as d:
        print(json.dumps(jax_run(d, posegraph="--odometry" not in sys.argv[1:])))
