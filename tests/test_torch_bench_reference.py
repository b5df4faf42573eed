"""Where `chip_smoke.py`'s phase-18 ATE limits come from.

Phase 18 drives the seven rows of the port's bench (`chip_smoke.BENCH_ROWS`:
the default, point-to-point, SVGD, segmentation, features, `--batch 4` and
SVD rows) at bench.py's own frame counts. The card's machine has no JAX, so
each row's limit is a constant in chip_smoke.py, max(1.5 x, x + 0.05 m),
where x is the ATE of the JAX package's own LIOPipeline, in float32 on the
CPU, built by its `bench.build` with the row's flags and fed every frame of
the same sequence. Run this file as a script to repeat those runs (tens of
minutes on the CPU in all; one JSON line per row with its ATE, iterations
per frame and align_ok per frame):

    JAX_PLATFORMS=cpu python tests/test_torch_bench_reference.py [row ...]

The tests below check that chip_smoke.py's constants follow that rule and
cover every row.
"""

import json
import pathlib
import sys

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from svnicp_tpu_torch import bench as tbench  # noqa: E402

ROWS = ("default", "point_to_point", "svgd", "segmentation", "features", "batch4",
        "svd")


def row_frames(name: str) -> tuple[int, int]:
    """(warm-up, timed) frames of a row, by the bench's own rule."""
    return tbench.frame_counts(tbench.parser().parse_args(chip_smoke.BENCH_ROWS[name][0]))


def test_bench_rows_are_the_seven_rows():
    assert tuple(chip_smoke.BENCH_ROWS) == ROWS
    assert set(chip_smoke.BENCH_JAX_ATE) == set(ROWS)
    assert chip_smoke.BENCH_ROWS["default"][1] == 5
    assert all(repeat > 1 for _, repeat in chip_smoke.BENCH_ROWS.values())


def test_bench_limits_follow_the_rule():
    for name in ROWS:
        ate = chip_smoke.BENCH_JAX_ATE[name]
        assert 0 < ate < 5.0, (name, ate)
        assert chip_smoke.bench_limit(name) == max(1.5 * ate, ate + 0.05)


def test_bench_row_frames_are_bench_py_s():
    assert row_frames("default") == (3, 40)
    assert row_frames("segmentation") == row_frames("features") == (3, 20)
    assert row_frames("batch4") == (9, 40)


def jax_row(name: str) -> dict:
    """The JAX package's float32 CPU run of one row: bench.build with the
    row's flags, every frame fed, ATE against the trajectory's poses."""
    import bench as jbench
    from svnicp_tpu.io import datasets, metrics

    args = tbench.parser().parse_args(chip_smoke.BENCH_ROWS[name][0])
    warmup, timed = tbench.frame_counts(args)
    n = warmup + timed
    pipe, times, scans = jbench.build(n, **tbench.run_kwargs(args))
    for i in range(n):
        pipe.feed_scan(float(times[i]), scans[i])
    pipe.flush()
    _, rots, trans = datasets.synthetic_trajectory(n, dt=0.1, speed=2.0, seed=7)
    gt = np.tile(np.eye(4), (n, 1, 1))
    gt[:, :3, :3] = rots
    gt[:, :3, 3] = trans
    ate = metrics.ate_rmse(pipe.trajectory(), gt)
    return {"row": name, "dtype": pipe.cfg.dtype, "frames": n,
            "iterations": [int(o.icp_iterations) for o in pipe.outputs],
            "align_ok": [bool(o.align_ok) for o in pipe.outputs],
            "ate_m": ate, "limit_m": max(1.5 * ate, ate + 0.05)}


def main() -> None:
    for name in sys.argv[1:] or ROWS:
        print(json.dumps(jax_row(name)), flush=True)


if __name__ == "__main__":
    main()
