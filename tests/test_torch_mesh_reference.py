"""Where `chip_smoke.py`'s ATE limits for the mesh runs (phase 16 (b) and
(c)) come from.

The card's machine has no JAX, so the limits are constants in chip_smoke.py
derived from the JAX package's own LIOPipeline runs, in float32 on the
CPU's simulated 8-device mesh, with `sharding: {particle_axis: 2,
point_axis: 4}` (`chip_smoke.mesh_config`):
- configs/tpu_plane.yaml on the main path's first 10 frames
  (chip_smoke.WARMUP + MESH_TIMED), in the replicated-map mode and in the
  sharded-map mode (`map.sharded`, the 131,072-row map in 4 blocks,
  rebalanced after the bootstrap and at frame 10);
- configs/geode_alpha.yaml on the geode path's first 10 frames with their
  IMU samples, in the replicated-map mode.
Run this file as a script to repeat them (each takes minutes on the CPU;
one JSON line per run with its ATE, iterations and the limit
max(1.5 ATE, ATE + 0.05 m)); name runs to take only some:

    JAX_PLATFORMS=cpu python tests/test_torch_mesh_reference.py [--frames N] [plane plane_sharded geode]

(`--frames 23` repeats the 3 + 20 frames of the main and geode paths.)

The tests below check that chip_smoke.py's constants follow that rule and
that its mesh configurations are the ones these runs use.
"""

import json
import os
import pathlib
import sys

if __name__ == "__main__":
    # the simulated 8-device mesh must be asked for before JAX starts
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import chip_smoke  # noqa: E402

RUNS = ("plane", "plane_sharded", "geode")


def test_chip_smoke_mesh_limits_follow_the_rule():
    for name in RUNS:
        ate = chip_smoke.MESH_JAX_ATE[name]
        assert chip_smoke.mesh_limit(name) == max(1.5 * ate, ate + 0.05)


def test_mesh_config_is_the_same_in_both_packages():
    import dataclasses

    from svnicp_tpu import config as jcfg
    from svnicp_tpu_torch import config as tcfg

    for yaml, sharded in (("tpu_plane.yaml", False), ("tpu_plane.yaml", True),
                          ("geode_alpha.yaml", False)):
        j = chip_smoke.mesh_config(jcfg.from_yaml(str(ROOT / "configs" / yaml)), sharded)
        t = chip_smoke.mesh_config(tcfg.from_yaml(str(ROOT / "configs" / yaml)), sharded)
        assert (j.sharding.particle_axis, j.sharding.point_axis) == (2, 4)
        assert j.map.sharded == t.map.sharded == sharded
        assert dataclasses.asdict(j) == dataclasses.asdict(t)


def main(names, n=None) -> None:
    import jax

    from svnicp_tpu import config as cfg_mod
    from svnicp_tpu.io import metrics
    from svnicp_tpu.runtime import pipeline as pl
    from test_torch_geode_reference import jax_sequence as geode_sequence
    from test_torch_plane_reference import jax_sequence as plane_sequence

    assert len(jax.devices()) >= 8, jax.devices()
    n = n or chip_smoke.WARMUP + chip_smoke.MESH_TIMED
    for name in names:
        yaml = "geode_alpha.yaml" if name == "geode" else "tpu_plane.yaml"
        cfg = chip_smoke.mesh_config(cfg_mod.from_yaml(str(ROOT / "configs" / yaml)),
                                     sharded=name == "plane_sharded")
        if name == "geode":
            times, rots, trans, scans, imu = geode_sequence(n, 32000)
        else:
            times, rots, trans, scans = plane_sequence(n, 32000)
            imu = [None] * n
        pipe = pl.LIOPipeline(cfg)
        for i in range(n):
            if imu[i] is not None:
                pipe.feed_imu(*imu[i])
            pipe.feed_scan(float(times[i]), scans[i])
        pipe.close()
        gt = np.tile(np.eye(4), (n, 1, 1))
        gt[:, :3, :3] = rots
        gt[:, :3, 3] = trans
        ate = metrics.ate_rmse(pipe.trajectory(), gt)
        print(json.dumps({
            "run": name, "config": f"configs/{yaml}", "mesh": [2, 4],
            "map_sharded": cfg.map.sharded, "dtype": cfg.dtype, "frames": n,
            "iterations": [int(o.icp_iterations) for o in pipe.outputs],
            "align_ok": [bool(o.align_ok) for o in pipe.outputs],
            "rebalances": pipe.rebalances,
            "ate_m": ate, "limit_m": max(1.5 * ate, ate + 0.05)}), flush=True)


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("runs", nargs="*", default=RUNS)
    args = ap.parse_args()
    main(args.runs or RUNS, args.frames)
