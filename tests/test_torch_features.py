"""The port's LOAM feature selection against the JAX package's.

On raycast sweeps (`tests/test_torch_segmentation.sweep`: HDL-64 and
VLP-16 patterns, every 15th or 45th column, cut at 9 m or 80 m) in float32
and float64, each step is held to the JAX function on the same inputs:
`_compact_rows`, `_curvature` and `_occlusion_free` equal;
`_sector_topk` equal on scores with constructed exact ties (lax.top_k
takes the lower index first, as must the port); `select_features` with
identical validity, order, counts and times, and points equal to 1e-6 in
float32 (equal in float64), including a capacity smaller than the picks
(the ground quota is cut first, then planar tails).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from svnicp_tpu.core import features as jfeat
from svnicp_tpu.core import segmentation as jseg
from svnicp_tpu_torch.core import features as tfeat
from svnicp_tpu_torch.core import segmentation as tseg
from test_torch_segmentation import sweep

torch.set_num_threads(2)


def _images(sensor, col_step, max_range, dtype):
    """(JAX range image as numpy, the port's image) of one sweep."""
    pts, valid, ts = sweep(sensor, col_step, max_range, 16384)
    np_dt = np.float64 if dtype == "float64" else np.float32
    arrays = (pts.astype(np_dt), valid, ts.astype(np_dt))
    with jax.enable_x64(dtype == "float64"):
        jp, jv, jt = [jnp.asarray(a) for a in arrays]
        ji = jseg.project(jp, jv, getattr(jseg, sensor.upper()), jt)
        ji = jseg.RangeImage(*[np.asarray(a) for a in ji])
    tp, tv, tt = [torch.from_numpy(a) for a in arrays]
    ti = tseg.project(tp, tv, getattr(tseg, sensor.upper()), tt)
    return ji, ti, arrays


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_compact_curvature_occlusion_match_jax(dtype):
    ji, ti, _ = _images("hdl64", 15, 80.0, dtype)
    assert ti.rng.dtype == torch.float32
    with jax.enable_x64(dtype == "float64"):
        jc = jfeat._compact_rows(jseg.RangeImage(*[jnp.asarray(a) for a in ji]))
        jcurv, jelig = jfeat._curvature(jc[1], jc[4], 5)
        jocc = jfeat._occlusion_free(jc[1], jc[4], 0.3)
        jc = [np.asarray(a) for a in jc]
        jcurv, jelig, jocc = np.asarray(jcurv), np.asarray(jelig), np.asarray(jocc)
    tc = tfeat._compact_rows(ti)
    for a, b in zip(jc, tc):
        np.testing.assert_array_equal(b.numpy(), a)
    tcurv, telig = tfeat._curvature(tc[1], tc[4], 5)
    np.testing.assert_array_equal(tcurv.numpy(), jcurv)
    np.testing.assert_array_equal(telig.numpy(), jelig)
    assert telig.sum() > 1000
    np.testing.assert_array_equal(tfeat._occlusion_free(tc[1], tc[4], 0.3).numpy(), jocc)


@pytest.mark.parametrize("k", [1, 3, 7])
def test_sector_topk_ties_take_the_lower_index(k):
    """Scores on a coarse grid, so most of each sector ties with another
    cell, plus whole sectors of one value and of -1 (nothing to pick)."""
    rng = np.random.default_rng(k)
    score = rng.integers(-2, 4, size=(6, 180)).astype(np.float32) * 0.25
    score[1, 20:30] = 0.5
    score[2] = -1.0
    score[3, 170:] = 9.0              # the trailing columns a sector drops
    want = [np.asarray(a) for a in jfeat._sector_topk(jnp.asarray(score), 18, k)]
    got = tfeat._sector_topk(torch.from_numpy(score), 17, k)  # 180 % 17 = 10
    want17 = [np.asarray(a) for a in jfeat._sector_topk(jnp.asarray(score), 17, k)]
    for a, b in zip(want17, got):
        np.testing.assert_array_equal(b.numpy(), a)
    got18 = tfeat._sector_topk(torch.from_numpy(score), 18, k)
    for a, b in zip(want, got18):
        np.testing.assert_array_equal(b.numpy(), a)


CASES = [  # (sensor, col_step, max_range, capacity)
    ("hdl64", 15, 80.0, 4096),
    ("hdl64", 15, 9.0, 4096),
    ("vlp16", 15, 80.0, 4096),
    ("hdl64", 15, 80.0, 300),      # fewer slots than picks
]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", CASES)
def test_select_features_matches_jax(case, dtype):
    sensor, col_step, max_range, cap = case
    pts, valid, ts = sweep(sensor, col_step, max_range, 16384)
    np_dt = np.float64 if dtype == "float64" else np.float32
    arrays = (pts.astype(np_dt), valid, ts.astype(np_dt))
    with jax.enable_x64(dtype == "float64"):
        want = jfeat.select_features(*[jnp.asarray(a) for a in arrays],
                                     getattr(jseg, sensor.upper()), cap,
                                     max_range=max_range)
        want = [np.asarray(a) for a in want]
    got = tfeat.select_features(*[torch.from_numpy(a) for a in arrays],
                                getattr(tseg, sensor.upper()), cap,
                                max_range=max_range)
    counts = [int(x) for x in got[3:]]
    assert counts == [int(x) for x in want[3:]]
    assert sum(counts) > 20
    np.testing.assert_array_equal(got.valid.numpy(), want[1])
    np.testing.assert_array_equal(got.timestamps.numpy(), want[2])
    np.testing.assert_allclose(got.points.numpy(), want[0], rtol=0,
                               atol=1e-6 if dtype == "float32" else 0.0)
    if cap < sum(counts):
        assert bool(got.valid.all())
