"""Motion-distorted sweeps (`scan.sweep: true`): float32 [N,4] scans whose
4th column is each point's time in the sweep, each point seen from the
pose of its own time, mid-sweep ground truth, and the port's deskew with
the true motion bringing a sweep back onto the world's surfaces. The
generic SVGD operating point (`configs/generic_svgd.yaml`: deskew on, the
raw route) runs the sweep drive through the window's feeder at a cut
size."""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from lio_bench.harness import cell, drive, window

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[2]
FRAMES = 8
SWEEP = {"scan": {"sweep": True, "points": 3000, "max_range": 80.0}}


def traffic(noise=None):
    tr = cell.merge(cell.load_yaml(cell.BENCH / "traffic" / "live_10hz_60m.yaml"), SWEEP)
    if noise is not None:
        tr["scan"]["noise"] = noise
    return tr


def make(tr, seed=2**33 + 9):
    return drive.make_drive(tr, seed, FRAMES, 30, *drive.prior_box({}))


def surface_gap(tr, points_world):
    """Each point's distance to the nearest surface of the traffic's world."""
    w = tr["world"]
    world = drive.SyntheticWorld(extent=float(w["extent"]), n_walls=int(w["n_walls"]),
                                 n_boxes=int(w["n_boxes"]), seed=int(w["seed"]))
    best = np.full(len(points_world), np.inf)
    for o, u, v, ul, vl in world._surfaces:
        q = points_world - o
        a = np.clip(q @ u, 0.0, ul)[:, None]
        b = np.clip(q @ v, 0.0, vl)[:, None]
        best = np.minimum(best, np.linalg.norm(q - a * u - b * v, axis=1))
    return best


def true_motion(tr, k):
    """log(T_{k-1}^-1 T_k) between the stamps' poses of the route."""
    t = tr["trajectory"]
    _, rots, trans = drive.synthetic_trajectory(
        FRAMES, dt=1.0 / float(tr["scan_rate_hz"]), speed=float(t["speed"]),
        turn_rate=float(t["turn_rate"]), seed=int(t["seed"]),
        ramp_seconds=float(t["ramp_seconds"]))
    return drive.se3_log(rots[k - 1].T @ rots[k], rots[k - 1].T @ (trans[k] - trans[k - 1]))


def in_world(d, k, points):
    return points.astype(np.float64) @ d.rots[k].T + d.trans[k]


def test_sweeps_are_float32_with_times_in_the_period():
    tr = traffic()
    d = make(tr)
    period = 1.0 / float(tr["scan_rate_hz"])
    for s in d.scans:
        assert s.dtype == np.float32 and s.ndim == 2 and s.shape[1] == 4
        assert s.shape[0] == 3000
        assert 0.0 <= s[:, 3].min() and s[:, 3].max() <= np.float32(period)
        assert s[:, 3].max() - s[:, 3].min() > 0.95 * period
    assert np.array_equal(make(tr).scans[1], d.scans[1])      # the same seed, the same sweep


def test_the_ground_truth_is_the_mid_sweep_pose():
    tr = traffic()
    d = make(tr)
    snap = drive.make_drive(cell.merge(tr, {"scan": {"sweep": False}}), 1, FRAMES, 30,
                            *drive.prior_box({}))
    assert np.array_equal(d.times, snap.times)
    assert np.array_equal(d.trans[0], snap.trans[0]) and np.array_equal(d.rots[0], snap.rots[0])
    for k in range(1, FRAMES):
        rm, tm = drive.se3_exp(0.5 * true_motion(tr, k))
        assert np.allclose(d.rots[k], snap.rots[k - 1] @ rm, atol=1e-12)
        assert np.allclose(d.trans[k], snap.rots[k - 1] @ tm + snap.trans[k - 1], atol=1e-12)


def test_frame_zero_is_undistorted_and_later_sweeps_are():
    """Without noise, frame 0 lies on the world's surfaces at its pose as
    it is; a later sweep does so only once deskewed (to the deskew's
    min-max normalisation of the times, which stretches the sweep's first
    and last firing, ~1e-4 of the period apart from 0 and 1, onto 0 and 1:
    a few tenths of a millimetre at 80 m)."""
    from svnicp_tpu_torch.core import pointcloud as pc

    tr = traffic(noise=0.0)
    d = make(tr)
    assert surface_gap(tr, in_world(d, 0, d.scans[0][:, :3])).max() < 1e-4
    for k in (1, FRAMES - 1):
        s = torch.from_numpy(d.scans[k]).double()
        fixed = pc.deskew(s[:, :3], torch.ones(len(s), dtype=torch.bool), s[:, 3],
                          torch.from_numpy(true_motion(tr, k))).numpy()
        assert surface_gap(tr, in_world(d, k, fixed)).max() < 1e-3
        assert surface_gap(tr, in_world(d, k, d.scans[k][:, :3])).max() > 0.02


def test_deskew_with_the_true_motion_restores_the_cloud_within_the_noise():
    from svnicp_tpu_torch.core import pointcloud as pc

    tr = traffic()
    noise = float(tr["scan"]["noise"])
    d = make(tr)
    for k in range(2, FRAMES):
        s = torch.from_numpy(d.scans[k]).double()
        fixed = pc.deskew(s[:, :3], torch.ones(len(s), dtype=torch.bool), s[:, 3],
                          torch.from_numpy(true_motion(tr, k))).numpy()
        gap = surface_gap(tr, in_world(d, k, fixed))
        raw = surface_gap(tr, in_world(d, k, d.scans[k][:, :3]))
        assert np.sqrt((gap ** 2).mean()) < 1.1 * noise and gap.max() < 5 * noise
        assert np.sqrt((raw ** 2).mean()) > 1.5 * noise


def test_generic_svgd_runs_the_sweep_drive_through_the_feeder():
    """configs/generic_svgd.yaml's settings, capacities cut for the CPU:
    every frame of the sweep drive gets a pose with align_ok."""
    from svnicp_tpu_torch import config
    from svnicp_tpu_torch.runtime.pipeline import LIOPipeline

    doc = yaml.safe_load((ROOT / "configs" / "generic_svgd.yaml").read_text())
    assert doc["icp"]["method"] == "svgd" and doc["preprocess"]["deskew"] is True
    cfg = config.from_dict(cell.merge(copy.deepcopy(doc), {
        "icp": {"source_capacity": 512, "target_capacity": 4096},
        "map": {"capacity": 16384}, "preprocess": {"raw_capacity": 8192}}))
    tr = traffic()
    d = drive.make_drive(tr, 2**33 + 11, FRAMES, cfg.icp.particle_count,
                         *drive.prior_box(doc["icp"]))
    feeder = window.Feeder(LIOPipeline(cfg, device="cpu"), d, torch.from_numpy(d.particles))
    for k in range(FRAMES):
        feeder.imu(k)
        host, iterations, ok = feeder.scan(k)
        assert host is not None and ok, k
        assert np.isfinite(host).all() and (k == 0 or iterations >= 1)
    # the deskew ran on the raw route: each sweep's times reached the pipeline
    assert len(feeder.pipe.outputs) == FRAMES


@pytest.mark.parametrize("seed", [0, 2**40 + 3])
def test_a_sweep_drive_judged_with_deskew_off_reads_its_first_three_columns(seed):
    from lio_bench.reference import svn_odometry as ref

    d = make(traffic(), seed)
    cfg = cell.load_yaml(cell.BENCH / "configs" / "subt_mrs_fullmap.yaml")["pipeline"]
    ops = ref.Ops(ref.Precision(), "cpu")
    four = ref.stage(ops, d.scans[2], cfg)
    three = ref.stage(ops, np.ascontiguousarray(d.scans[2][:, :3]), cfg)
    for a, b in zip(four, three):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
