"""Where `chip_smoke.py`'s ATE limit for the features path comes from.

The card's machine has no JAX, so the limit is a constant in chip_smoke.py
derived from the JAX package's own LIOPipeline run, in float32 on the CPU,
on the same 23 frames (3 warm-up + 20 timed) that chip_smoke.py drives the
port with: configs/tpu_features.yaml unchanged, on the JAX package's
`cli record --proxy` recipe (`io/stream.record_proxy`: seed 5, col_step 3,
every other default) built in memory by `chip_smoke.proxy_sequence`, with
the port's `raycast_sweep` (float32 pose interpolation, so the sweeps agree
with the JAX package's to rounding; the JAX run takes the port's sweeps, so
the limit is taken on identical frames). Each IMU sample is fed before the
scans it precedes, each sweep with its per-point times. Run this file as a
script to repeat that run (a few minutes on the CPU; it prints the JAX
package's ATE against the mid-sweep poses, the limit max(1.5 ATE,
ATE + 0.05 m) and its iterations per frame):

    JAX_PLATFORMS=cpu python tests/test_torch_features_reference.py

The tests below check that chip_smoke.py's constants follow that rule and
that its sequence replays record_proxy's draws in record_proxy's order.
"""

import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from svnicp_tpu.io import stream as jstream  # noqa: E402

CONFIG = "tpu_features"


def test_chip_smoke_limit_follows_the_rule():
    ate = chip_smoke.FEATURES_JAX_ATE
    assert chip_smoke.FEATURES_ATE_LIMIT == max(1.5 * ate, ate + 0.05)
    n = chip_smoke.WARMUP + chip_smoke.TIMED
    assert len(chip_smoke.FEATURES_JAX_ITERS) == len(chip_smoke.FEATURES_JAX_ALIGN_OK) == n


def test_proxy_sequence_replays_record_proxy(tmp_path):
    """The in-memory sequence against the JAX package's `record_proxy` log
    read back: the same events in the same order, IMU values equal to the
    byte (so every draw before them was replayed in order), per-point times
    equal, points within 1e-4 m (the sweeps' poses are interpolated in
    float32 by two implementations) and the mid-sweep poses within 1e-5."""
    log = tmp_path / "proxy.svnl"
    gt = jstream.record_proxy(str(log), n_frames=3, seed=5, col_step=45)
    with open(log, "rb") as f:
        want = list(jstream.StreamReader(f))
    events, gt_r, gt_t = chip_smoke.proxy_sequence(3, col_step=45)
    assert len(events) == len(want)
    n_scans = 0
    for ev, pkt in zip(events, want):
        assert ev[1] == pkt.stamp
        if ev[0] == "imu":
            assert isinstance(pkt, jstream.ImuPacket)
            np.testing.assert_array_equal(ev[2], pkt.acc)
            np.testing.assert_array_equal(ev[3], pkt.gyro)
        else:
            n_scans += 1
            assert ev[2].shape == pkt.points.shape
            np.testing.assert_allclose(ev[2], pkt.points, rtol=0, atol=1e-4)
            np.testing.assert_array_equal(ev[3], pkt.timestamps)
    assert n_scans == 3
    np.testing.assert_allclose(gt_r, gt[:, :3, :3], atol=1e-5)
    np.testing.assert_allclose(gt_t, gt[:, :3, 3], atol=1e-5)


def jax_run(config: str) -> dict:
    """The JAX package's float32 LIOPipeline on chip_smoke.py's proxy frames."""
    from svnicp_tpu import config as cfg_mod
    from svnicp_tpu.io import metrics
    from svnicp_tpu.runtime import pipeline as pl

    n = chip_smoke.WARMUP + chip_smoke.TIMED
    cfg = cfg_mod.from_yaml(str(ROOT / "configs" / f"{config}.yaml"))
    events, gt_r, gt_t = chip_smoke.proxy_sequence(n)
    pipe = pl.LIOPipeline(cfg)
    for t, pts, imus, tau in chip_smoke.proxy_frames(events):
        for sample in imus:
            pipe.feed_imu(*sample)
        pipe.feed_scan(t, pts, timestamps=tau)
    pipe.close()
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, :3, :3] = gt_r
    gt[:, :3, 3] = gt_t
    ate = metrics.ate_rmse(pipe.trajectory(), gt)
    return {"config": f"configs/{config}.yaml", "dtype": cfg.dtype, "frames": n,
            "points": [len(f[1]) for f in chip_smoke.proxy_frames(events)],
            "iterations": [int(o.icp_iterations) for o in pipe.outputs],
            "align_ok": [bool(o.align_ok) for o in pipe.outputs],
            "ate_m": ate, "limit_m": max(1.5 * ate, ate + 0.05)}


if __name__ == "__main__":
    print(json.dumps(jax_run(CONFIG)))
