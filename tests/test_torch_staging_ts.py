"""The host route's timestamp channel and the int16 upload against the JAX
package's.

On a raycast sweep with its per-point times (`tests/test_torch_segmentation.
sweep`), the port's native `stage_scan_ts` and `downsample_one_stage_ts`
are byte-equal to the JAX package's native library and to the port's numpy
versions; the quantized staging buffers of both routes (the raw route's
scan with its time column, the host route's stage-A rows with theirs) are
byte-equal to the JAX package's, the time column clipping at 127.996 where
its values exceed the int16 grid.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from svnicp_tpu import config as jcfg_mod
from svnicp_tpu.io import native as jnative
from svnicp_tpu.runtime import pipeline as jpl
from svnicp_tpu_torch import config as tcfg_mod
from svnicp_tpu_torch.io import native as tnative
from svnicp_tpu_torch.runtime import ingest
from svnicp_tpu_torch.runtime import pipeline as tpl
from test_torch_segmentation import sweep


def _scan(n=8000):
    pts, valid, ts = sweep("hdl64", 15, 80.0, n)
    k = int(valid.sum())
    return pts[:k], ts[:k]


@pytest.mark.parametrize("rng_cut", [(0.5, 60.0), (2.0, 20.0)])
def test_stage_scan_ts_matches_jax_and_numpy(rng_cut):
    pts, ts = _scan()
    got = tnative.stage_scan_ts(pts, ts, *rng_cut, 6000)
    want = jnative.stage_scan_ts(pts, ts, *rng_cut, 6000)
    plain = tnative.stage_scan_ts_numpy(pts, ts, *rng_cut, 6000)
    assert got[2] == want[2] == plain[2] > 100
    for a, b, c in zip(got[:2], want[:2], plain[:2]):
        assert a.dtype == b.dtype == np.float32
        assert a.tobytes() == b.tobytes() == c.tobytes()
    # without times: the untimed crop's points
    rows, _, n = tnative.stage_scan_ts(pts, None, *rng_cut, 6000)
    plain_rows, _, plain_n = tnative.stage_scan(pts, *rng_cut, 6000)
    assert n == plain_n == got[2] and rows.tobytes() == plain_rows.tobytes()


@pytest.mark.parametrize("voxel,cap", [(0.1, 4096), (0.5, 512)])
def test_downsample_one_stage_ts_matches_jax_and_numpy(voxel, cap):
    pts, ts = _scan()
    got = tnative.downsample_one_stage_ts(pts, ts, voxel, cap)
    want = jnative.downsample_one_stage_ts(pts, ts, voxel, cap)
    plain = tnative.downsample_one_stage_ts_numpy(pts, ts, voxel, cap)
    assert got[2] == want[2] == plain[2] > 100
    for a, b, c in zip(got[:2], want[:2], plain[:2]):
        assert a.tobytes() == b.tobytes() == c.tobytes()
    # the same rows as the untimed stage
    rows, n = tnative.downsample_one_stage(pts, voxel, cap)
    assert n == got[2] and rows.tobytes() == got[0].tobytes()
    rows, none, n = tnative.downsample_one_stage_ts(pts, None, voxel, cap)
    assert none is None and n == got[2] and rows.tobytes() == got[0].tobytes()


CFG = dict(
    icp=dict(method="svn", residual="point_to_point", particle_count=8,
             knn_count=16, source_capacity=2048, target_capacity=4096,
             use_pallas=True),
    map=dict(voxel_size=0.2, max_points_per_voxel=1, capacity=8192),
    preprocess=dict(min_range=0.5, max_range=60.0, voxel_size=0.2, deskew=True,
                    host_downsample=True, quantize_upload=True,
                    raw_capacity=8192),
    lio=dict(estimator="icp", frame_gap_seconds=0.0),
)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("ts_scale", [1.0, 200.0])
def test_quantized_buffers_match_jax(dtype, ts_scale):
    """Both routes' int16 buffers, with times in [0,1] and in [0,200] (past
    the grid: clipped at 32767 / 256 = 127.996)."""
    cfg_dict = dict(CFG, dtype=dtype)
    pts, ts = _scan()
    ts = ts * np.float32(ts_scale)
    with jax.enable_x64(dtype == "float64"):
        jpipe = jpl.LIOPipeline(jcfg_mod.from_dict(cfg_dict))
        j_raw = jpipe._pack_frame(0.1, pts, ts)[0]
        j_pre = jpipe._stage_scan_pre_untimed(pts, ts)
        j_pre_plain = jpipe._stage_scan_pre_untimed(pts, None)
    tpipe = tpl.LIOPipeline(tcfg_mod.from_dict(cfg_dict), device="cpu")
    t_raw = tpipe._pack_frame(0.1, pts, ts)[0]
    t_pre = tpipe._stage_scan_pre_untimed(pts, ts)
    t_pre_plain = tpipe._stage_scan_pre_untimed(pts, None)
    tpipe.close()
    assert t_raw.dtype == np.int16 and t_raw.tobytes() == j_raw.tobytes()
    for (tb, tn), (jb, jn) in ((t_pre, j_pre), (t_pre_plain, j_pre_plain)):
        assert tn == jn > 100
        assert tb.dtype == np.int16 and tb.tobytes() == jb.tobytes()
    assert t_pre[0].shape == (4096, 4) and t_pre_plain[0].shape == (4096, 3)
    top = int(t_raw[:, 3].max())
    assert top == (32767 if ts_scale > 128 else round(float(ts.max()) * 256))
    pre_top = int(t_pre[0][:, 3].max())
    assert pre_top == 32767 if ts_scale > 128 else 200 < pre_top <= top


def test_quantize_is_the_grid():
    buf = np.array([[0.001953125, -0.0019531, 127.99, -200.0]], np.float32)
    np.testing.assert_array_equal(ingest.quantize(buf), [[0, 0, 32765, -32768]])
    back = tpl.dequantize(torch.tensor([[256, -32768, 1]], dtype=torch.int16),
                          torch.float64)
    np.testing.assert_array_equal(back.numpy(), [[1.0, -128.0, 2.0 ** -8]])


def test_quantize_upload_keeps_the_config_bound():
    """The config refuses a max_range past the int16 grid, as the JAX
    package's does; subt_mrs_fast stays inside it."""
    cfg = tcfg_mod.from_dict(CFG)
    assert cfg.preprocess.quantize_upload
    with pytest.raises(ValueError, match="quantize_upload"):
        dataclasses.replace(cfg.preprocess, max_range=130.0)
