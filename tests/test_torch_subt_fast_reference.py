"""Where `chip_smoke.py`'s ATE limit for the SubT-fast path comes from.

As `tests/test_torch_features_reference.py`, for configs/subt_mrs_fast.yaml
unchanged (the ICP estimator with host crop and stage-A downsample carrying
the per-point times, the int16 upload, deskew on the device and
stage-ahead) on the same 23 proxy frames, IMU samples fed as well (the ICP
estimator does not use them). Run this file as a script to repeat that run:

    JAX_PLATFORMS=cpu python tests/test_torch_subt_fast_reference.py
"""

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from test_torch_features_reference import jax_run  # noqa: E402

CONFIG = "subt_mrs_fast"


def test_chip_smoke_limit_follows_the_rule():
    ate = chip_smoke.SUBT_FAST_JAX_ATE
    assert chip_smoke.SUBT_FAST_ATE_LIMIT == max(1.5 * ate, ate + 0.05)
    n = chip_smoke.WARMUP + chip_smoke.TIMED
    assert len(chip_smoke.SUBT_FAST_JAX_ITERS) == len(chip_smoke.SUBT_FAST_JAX_ALIGN_OK) == n


def test_subt_fast_runs_on_the_features_paths_frames():
    """Both paths take the same proxy frames: one sequence, one limit rule."""
    import test_torch_features_reference as feat

    assert feat.jax_run is jax_run
    assert chip_smoke.proxy_frames([("imu", 0.0, 1, 2), ("scan", 0.05, "p", "t")]) \
        == [(0.05, "p", [(0.0, 1, 2)], "t")]


if __name__ == "__main__":
    print(json.dumps(jax_run(CONFIG)))
