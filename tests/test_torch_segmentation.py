"""The port's range-image segmentation against the JAX package's.

Inputs are motion-distorted raycast sweeps (`io/datasets.raycast_sweep`,
SyntheticWorld(extent=60, seed=5), every 15th to 45th azimuth column) in
the HDL-64 and VLP-16 ray patterns, padded into fixed buffers, cut at 9 m
or 80 m. Their rays lie on the sensor's ring angles, so a point's row sits
on a rounding edge: the port's float32 `project` must round each step as
the JAX package's compiled CPU code does (glibc's atan2f, fused
multiply-adds, reciprocal multiplication, correctly rounded roots), and
every output is compared for equality:
- `project` in float32, and in float64, where the JAX package keeps only
  the cells whose nearest range survives its float32 scatter (about half;
  the port copies that);
- `ground_mask`, `label_components` (labels identical) and
  `segment_cloud` with and without timestamps (same points, same order);
- `atan2f` and `fma` on their own, bit for bit;
- the port's `raycast_sweep` against the JAX package's: its poses are
  interpolated in float32 by two implementations, so the same rays hit
  (the same count, the same times) and the points agree to 1e-4 m.

Run as a script, it prints what the rounding decides on a full-width sweep
(`main`):

    JAX_PLATFORMS=cpu python tests/test_torch_segmentation.py
"""

import pathlib
import sys
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from svnicp_tpu.core import segmentation as jseg  # noqa: E402
from svnicp_tpu.io import datasets as jdatasets  # noqa: E402
from svnicp_tpu_torch.core import segmentation as tseg  # noqa: E402
from svnicp_tpu_torch.io import datasets as tdatasets  # noqa: E402

torch.set_num_threads(2)

PATTERNS = {  # raycast_sweep's ray pattern for each preset
    "hdl64": {},
    "vlp16": dict(n_scan=16, horizon=1800, ang_res_y=2.0, ang_bottom=15.1),
}


def sweep(sensor: str, col_step: int, max_range: float, cap: int, seed: int = 1):
    """(points [cap,3] f32, valid [cap], times [cap] f32) of one sweep."""
    world = tdatasets.SyntheticWorld(extent=60.0, seed=5)
    _, rots, trans = tdatasets.synthetic_trajectory(30, dt=0.01, speed=1.5,
                                                    seed=5, ramp_seconds=1.0)
    pts, tau, _ = tdatasets.raycast_sweep(
        world._surfaces, rots[10], trans[10], rots[20], trans[20],
        col_step=col_step, dropout=0.05, max_range=max_range,
        rng=np.random.default_rng(seed), **PATTERNS[sensor])
    n = min(len(pts), cap)
    buf = np.zeros((cap, 3), np.float32)
    buf[:n] = pts[:n]
    ts = np.zeros(cap, np.float32)
    ts[:n] = tau[:n]
    return buf, np.arange(cap) < n, ts


CASES = [("hdl64", 15, 80.0), ("hdl64", 45, 9.0), ("vlp16", 15, 80.0)]


def _both(case, dtype):
    """The case's sweep as numpy arrays in `dtype` (made into JAX arrays
    inside each test's x64 scope) and as tensors, with both presets."""
    sensor, col_step, max_range = case
    pts, valid, ts = sweep(sensor, col_step, max_range, 16384)
    np_dt = np.float64 if dtype == "float64" else np.float32
    arrays = (pts.astype(np_dt), valid, ts.astype(np_dt))
    tin = tuple(torch.from_numpy(a) for a in arrays)
    return arrays, tin, getattr(jseg, sensor.upper()), getattr(tseg, sensor.upper())


def _eq(a, b, what):
    a, b = np.asarray(a), b.numpy()
    assert a.shape == b.shape, what
    np.testing.assert_array_equal(b, a, err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", CASES)
def test_project_ground_labels_match_jax(case, dtype):
    arrays, tin, js, ts_ = _both(case, dtype)
    with jax.enable_x64(dtype == "float64"):
        jin = [jnp.asarray(a) for a in arrays]
        ji = jseg.project(*jin[:2], js, jin[2])
        jg = jseg.ground_mask(ji, js)
        jl = jseg.label_components(ji, ji.valid & ~jg, js)
        ji = [np.asarray(a) for a in ji]
        jg, jl = np.asarray(jg), np.asarray(jl)
    ti = tseg.project(*tin[:2], ts_, tin[2])
    for a, b, what in zip(ji, ti, ("rng", "pts", "valid", "ts")):
        _eq(a, b, what)
    assert ti.rng.dtype == torch.float32
    assert int(ti.valid.sum()) > 200
    tg = tseg.ground_mask(ti, ts_)
    _eq(jg, tg, "ground")
    tl = tseg.label_components(ti, ti.valid & ~tg, ts_)
    _eq(jl, tl, "labels")
    assert len(np.unique(jl)) > 10


def test_project_float64_keeps_the_jax_cell_count():
    """The JAX package tests each point against its float32 scatter in
    float64, so a range that rounds up loses to itself: about half the cells
    stay empty. The port keeps the same cells."""
    counts = {}
    for dtype in ("float32", "float64"):
        arrays, tin, js, ts_ = _both(CASES[0], dtype)
        with jax.enable_x64(dtype == "float64"):
            jin = [jnp.asarray(a) for a in arrays]
            want = int(jseg.project(*jin[:2], js).valid.sum())
        counts[dtype] = int(tseg.project(*tin[:2], ts_).valid.sum())
        assert counts[dtype] == want
    assert counts["float64"] < 0.7 * counts["float32"]


@pytest.mark.parametrize("with_ts", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_segment_cloud_matches_jax(dtype, with_ts):
    arrays, tin, js, ts_ = _both(CASES[0], dtype)
    kw_t = dict(timestamps=tin[2]) if with_ts else {}
    with jax.enable_x64(dtype == "float64"):
        jin = [jnp.asarray(a) for a in arrays]
        kw_j = dict(timestamps=jin[2]) if with_ts else {}
        out_j = jseg.segment_cloud(*jin[:2], js, 8192, **kw_j)
        out_j = jax.tree.map(np.asarray, out_j)
    out_t = tseg.segment_cloud(*tin[:2], ts_, 8192, **kw_t)
    if with_ts:
        (cj, tsj), (ct, tst) = out_j, out_t
        _eq(tsj, tst, "timestamps")
    else:
        cj, ct = out_j, out_t
    _eq(cj.points, ct.points, "points")
    _eq(cj.valid, ct.valid, "valid")
    assert int(ct.valid.sum()) > 100


def test_atan2f_is_the_cpu_backends():
    rng = np.random.default_rng(0)
    y = (rng.normal(size=400_000) * rng.choice([1e-3, 1.0, 1e3], 400_000)).astype(np.float32)
    x = (rng.normal(size=400_000) * rng.choice([1e-4, 1.0, 1e4], 400_000)).astype(np.float32)
    x[:50], y[50:100], x[100:150] = 0.0, 0.0, 1.0
    x[150:160], y[160:170] = -0.0, -0.0
    want = np.asarray(jnp.arctan2(jnp.asarray(y), jnp.asarray(x)))
    got = tseg.atan2f(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_fma_rounds_once():
    rng = np.random.default_rng(1)
    a, b, c = (rng.normal(size=3000).astype(np.float32) * s for s in (3.0, 7.0, 50.0))
    got = tseg.fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        near = np.float32(float(exact))
        cands = (np.nextafter(near, np.float32(-np.inf)), near,
                 np.nextafter(near, np.float32(np.inf)))
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.array(v).view(np.int32)) & 1))
        assert got[i] == best, i


@pytest.mark.parametrize("sensor,col_step", [("hdl64", 15), ("vlp16", 5)])
def test_raycast_sweep_matches_jax(sensor, col_step):
    world = tdatasets.SyntheticWorld(extent=60.0, seed=5)
    _, rots, trans = tdatasets.synthetic_trajectory(30, dt=0.01, speed=1.5,
                                                    seed=5, ramp_seconds=1.0)
    args = (world._surfaces, rots[10], trans[10], rots[20], trans[20])
    kw = dict(col_step=col_step, dropout=0.05, **PATTERNS[sensor])
    want = jdatasets.raycast_sweep(*args, rng=np.random.default_rng(2), **kw)
    got = tdatasets.raycast_sweep(*args, rng=np.random.default_rng(2), **kw)
    assert got[0].shape == want[0].shape and len(got[0]) > 1000
    moved = int((np.abs(got[0] - want[0]).max(1) > 1e-6).sum())
    print(f"{sensor}: {moved} of {len(got[0])} points differ by more than 1e-6 m")
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[1], want[1])
    for a, b in zip(got[2], want[2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def main() -> None:
    """How the range image's float32 rounding decides its cells (run this
    file as a script): on sweep 2 of `chip_smoke.proxy_sequence` at full
    width, the valid cells and configs/tpu_features.yaml's picks (n_edge,
    n_planar, n_ground) of the JAX package and of the port in float32 and
    float64, and of the port with torch's plain float32 operations in place
    of the written-out rounding; and how often the JAX package's CPU atan2f,
    torch's atan2 and torch's CPU sqrt differ from the correctly rounded
    value on that sweep. About a minute on the CPU."""
    import os

    import chip_smoke
    from svnicp_tpu.core import features as jfeat
    from svnicp_tpu_torch import config as cfg_mod
    from svnicp_tpu_torch.runtime import pipeline as pl

    seg = tseg

    cfg = cfg_mod.from_yaml(os.path.join(ROOT, "configs", "tpu_features.yaml"))
    cap = cfg.preprocess.raw_capacity
    events, _, _ = chip_smoke.proxy_sequence(3)
    _, pts, _, tau = chip_smoke.proxy_frames(events)[2]
    buf = np.zeros((cap, 3), np.float32)
    buf[: len(pts)] = pts
    ts = np.zeros(cap, np.float32)
    ts[: len(pts)] = tau
    valid = np.arange(cap) < len(pts)

    def picks(sel):
        return tuple(int(x) for x in sel[3:])

    for dtype in ("float32", "float64"):
        np_dt = np.float32 if dtype == "float32" else np.float64
        arrays = (buf.astype(np_dt), valid, ts.astype(np_dt))
        with jax.enable_x64(dtype == "float64"):
            jp, jv, jt = (jnp.asarray(a) for a in arrays)
            cells = int(jseg.project(jp, jv, jseg.HDL64, jt).valid.sum())
            sel = jfeat.select_features(jp, jv, jt, jseg.HDL64, cfg.icp.source_capacity,
                                        max_range=cfg.preprocess.max_range)
        print(f"JAX {dtype}: {cells} cells, picks {picks(sel)}")
        tin = [torch.from_numpy(a) for a in arrays]
        print(f"port {dtype}: {int(seg.project(*tin[:2], seg.HDL64, tin[2]).valid.sum())} "
              f"cells, picks {picks(pl.select_features(cfg, *tin))}")

    tin = [torch.from_numpy(a) for a in (buf, valid, ts)]
    written = (seg._atan2, seg.fma, seg.div, seg.sqrt)
    seg._atan2, seg.sqrt = torch.atan2, torch.sqrt
    seg.fma = lambda a, b, c: a * b + c
    seg.div = lambda x, c: x / c
    try:
        print(f"port float32 with torch's plain operations: "
              f"{int(seg.project(*tin[:2], seg.HDL64, tin[2]).valid.sum())} cells, "
              f"picks {picks(pl.select_features(cfg, *tin))}")
    finally:
        seg._atan2, seg.fma, seg.div, seg.sqrt = written

    p = pts[:, :3]
    h = np.sqrt(p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]).astype(np.float32)
    exact = np.arctan2(p[:, 2].astype(np.float64), h.astype(np.float64)).astype(np.float32)
    xla = np.asarray(jnp.arctan2(jnp.asarray(p[:, 2]), jnp.asarray(h)))
    print(f"atan2 of the elevations: the JAX package's CPU atan2f differs from the "
          f"correctly rounded value on {np.mean(xla != exact):.1%} of {len(p)} points; "
          f"torch's on {np.mean(torch.atan2(torch.from_numpy(p[:, 2].copy()), torch.from_numpy(h)).numpy() != exact):.1%}")
    sq = (p * p).sum(1).astype(np.float32)
    print(f"torch's CPU float32 sqrt is not correctly rounded on "
          f"{np.mean(torch.sqrt(torch.from_numpy(sq)).numpy() != np.sqrt(sq)):.2%} of the "
          f"squared ranges")


if __name__ == "__main__":
    main()
