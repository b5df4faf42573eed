"""Where `chip_smoke.py`'s ATE limit for the main path comes from.

The card's machine has no JAX, so the limit is a constant in chip_smoke.py
derived from the JAX package's own LIOPipeline run, in float32 on the CPU,
on the same 23 frames (3 warm-up + 20 timed) of `bench.py`'s sequence that
chip_smoke.py drives the port with: configs/tpu_plane.yaml unchanged,
SyntheticWorld(extent=80, n_walls=24, n_boxes=16, seed=7),
synthetic_trajectory(dt=0.1, speed=2.0, seed=7), 32,000-point scans to
75 m. Run this file as a script to repeat that run (a few minutes on the
CPU; it prints the JAX package's ATE, its iterations per frame and the
limit max(1.5 ATE, ATE + 0.05 m)):

    JAX_PLATFORMS=cpu python tests/test_torch_plane_reference.py

The tests below check that chip_smoke.py's constants follow that rule and
that its sequence is the JAX recipe's, byte for byte.
"""

import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from svnicp_tpu.io import datasets as jdatasets  # noqa: E402


def jax_sequence(n_frames: int, n_points: int):
    """bench.py's sequence through the JAX package's datasets."""
    world = jdatasets.SyntheticWorld(extent=80.0, n_walls=24, n_boxes=16, seed=7)
    times, rots, trans = jdatasets.synthetic_trajectory(n_frames, dt=0.1, speed=2.0,
                                                        seed=7)
    rng = np.random.default_rng(7)
    scans = [world.scan_at(rng, rots[i], trans[i], n_points=n_points, max_range=75.0)
             for i in range(n_frames)]
    return times, rots, trans, scans


def test_chip_smoke_limit_follows_the_rule():
    ate = chip_smoke.PLANE_JAX_ATE
    assert chip_smoke.PLANE_ATE_LIMIT == max(1.5 * ate, ate + 0.05)
    assert len(chip_smoke.PLANE_JAX_ITERS) == chip_smoke.WARMUP + chip_smoke.TIMED


def test_chip_smoke_main_sequence_is_the_jax_recipe():
    want = jax_sequence(3, 2000)
    got = chip_smoke.bench_sequence(3, n_points=2000)
    for a, b in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(got[3], want[3]):
        assert a.tobytes() == b.tobytes()


def main() -> None:
    from svnicp_tpu import config as cfg_mod
    from svnicp_tpu.io import metrics
    from svnicp_tpu.runtime import pipeline as pl

    n = chip_smoke.WARMUP + chip_smoke.TIMED
    cfg = cfg_mod.from_yaml(str(ROOT / "configs" / "tpu_plane.yaml"))
    times, rots, trans, scans = jax_sequence(n, 32000)
    pipe = pl.LIOPipeline(cfg)
    for i in range(n):
        pipe.feed_scan(float(times[i]), scans[i])
    pipe.close()
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, :3, :3] = rots
    gt[:, :3, 3] = trans
    ate = metrics.ate_rmse(pipe.trajectory(), gt)
    print(json.dumps({
        "config": "configs/tpu_plane.yaml", "dtype": cfg.dtype, "frames": n,
        "iterations": [int(o.icp_iterations) for o in pipe.outputs],
        "align_ok": [bool(o.align_ok) for o in pipe.outputs],
        "ate_m": ate, "limit_m": max(1.5 * ate, ate + 0.05)}))


if __name__ == "__main__":
    main()
