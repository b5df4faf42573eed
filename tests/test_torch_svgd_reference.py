"""Where `chip_smoke.py`'s ATE limit for the SVGD path comes from.

The card's machine has no JAX, so the limit is a constant in chip_smoke.py
derived from the JAX package's own LIOPipeline run, in float32 on the CPU,
on the same 23 frames (3 warm-up + 20 timed) that chip_smoke.py drives the
port with: configs/generic_svgd.yaml (SVGD-ICP, P=30, Adam, deskew) on
motion-distorted sweeps of SyntheticWorld(extent=60, seed=7) along
synthetic_trajectory(24, dt=0.1, speed=2.0, seed=7), each a 32,000-point
`scan_sweep` from pose i to pose i+1 fed at times[i] with its per-point
sweep times, against the mid-sweep poses as ground truth. On the CPU the
JAX package takes its XLA route (use_pallas as the file leaves it, first
index at ties, which have measure zero on continuous sweeps); the port runs
the same configuration with use_pallas=True, its kernel route. Run this
file as a script to repeat that run (a few minutes on the CPU; it prints
the JAX package's ATE, iterations, align_ok and the limit
max(1.5 ATE, ATE + 0.05 m)):

    JAX_PLATFORMS=cpu python tests/test_torch_svgd_reference.py

The tests below check that chip_smoke.py's constants follow that rule and
that its sequence is the JAX recipe's, to float32 rounding.
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
    """The SVGD path's recipe through the JAX package's datasets ->
    (times, [(points, tau)], ground-truth rotations, translations)."""
    world = jdatasets.SyntheticWorld(extent=60.0, seed=7)
    times, rots, trans = jdatasets.synthetic_trajectory(
        n_frames + 1, dt=0.1, speed=2.0, seed=7)
    rng = np.random.default_rng(7)
    sweeps, gt_r, gt_t = [], [], []
    for i in range(n_frames):
        pts, tau, (mr, mt) = world.scan_sweep(rng, rots[i], trans[i], rots[i + 1],
                                              trans[i + 1], n_points=n_points)
        sweeps.append((pts, tau))
        gt_r.append(mr)
        gt_t.append(mt)
    return times[:n_frames], sweeps, np.stack(gt_r), np.stack(gt_t)


def test_chip_smoke_limit_follows_the_rule():
    ate = chip_smoke.SVGD_JAX_ATE
    assert chip_smoke.SVGD_ATE_LIMIT == max(1.5 * ate, ate + 0.05)
    n = chip_smoke.WARMUP + chip_smoke.TIMED
    assert len(chip_smoke.SVGD_JAX_ALIGN_OK) == n


def test_chip_smoke_svgd_sequence_is_the_jax_recipe():
    want = jax_sequence(3, 2000)
    got = chip_smoke.svgd_sequence(3, n_points=2000)
    np.testing.assert_array_equal(got[0], want[0])
    for (p, tau), (pj, tauj) in zip(got[1], want[1]):
        assert p.shape == pj.shape and p.dtype == pj.dtype == np.float32
        np.testing.assert_array_equal(tau, tauj)
        np.testing.assert_allclose(p, pj, rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[3], want[3], rtol=0, atol=1e-5)


def main() -> None:
    from svnicp_tpu import config as cfg_mod
    from svnicp_tpu.io import metrics
    from svnicp_tpu.runtime import pipeline as pl

    n = chip_smoke.WARMUP + chip_smoke.TIMED
    cfg = cfg_mod.from_yaml(str(ROOT / "configs" / "generic_svgd.yaml"))
    times, sweeps, gt_r, gt_t = jax_sequence(n, 32000)
    pipe = pl.LIOPipeline(cfg)
    for i in range(n):
        pipe.feed_scan(float(times[i]), sweeps[i][0], timestamps=sweeps[i][1])
    pipe.close()
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, :3, :3] = gt_r
    gt[:, :3, 3] = gt_t
    ate = metrics.ate_rmse(pipe.trajectory(), gt)
    print(json.dumps({
        "config": "configs/generic_svgd.yaml", "dtype": cfg.dtype, "frames": n,
        "iterations": [int(o.icp_iterations) for o in pipe.outputs],
        "align_ok": [bool(o.align_ok) for o in pipe.outputs],
        "ate_m": ate, "limit_m": max(1.5 * ate, ate + 0.05)}))


if __name__ == "__main__":
    main()
