"""The drive: the same seed gives the same inputs, another seed other
scans and draws over the same route, and seeds beyond 32 bits work."""

import numpy as np

from lio_bench.harness import cell, drive

TRAFFIC = {"kind": "replay", "frames": 6, "scan_rate_hz": 10,
           "world": {"extent": 60.0, "n_walls": 14, "n_boxes": 10, "seed": 7},
           "trajectory": {"speed": 1.5, "turn_rate": 0.08, "ramp_seconds": 1.0, "seed": 7},
           "scan": {"points": 2000, "max_range": 100.0, "noise": 0.02},
           "imu": {"rate_hz": 100}}


def make(seed):
    return drive.make_drive(TRAFFIC, seed, 6, 10, *drive.prior_box({}))


def test_same_seed_same_drive():
    a, b = make(2**33 + 17), make(2**33 + 17)
    assert all(np.array_equal(x, y) for x, y in zip(a.scans, b.scans))
    assert np.array_equal(a.particles, b.particles)
    assert np.array_equal(a.trans, b.trans)
    assert len(a.imu[1]) == 10 and len(a.imu[0]) == 1


def test_other_seed_other_scans_and_draws_same_route():
    a, b = make(1), make(2)
    assert not np.array_equal(a.scans[3], b.scans[3])
    assert not np.array_equal(a.particles, b.particles)
    assert np.array_equal(a.trans, b.trans) and np.array_equal(a.times, b.times)
    assert [s.shape for s in a.scans] == [s.shape for s in b.scans]


def test_scan_stamps_and_imu_stamps_line_up():
    d = make(3)
    assert np.allclose(np.diff(d.times), 0.1)
    for k in range(1, 6):
        stamps = [t for t, _, _ in d.imu[k]]
        assert stamps[-1] == d.times[k] and stamps[0] > d.times[k - 1]


def test_live_drive_covers_warm_up_and_window():
    tr = dict(TRAFFIC, kind="live", rate_hz=10, warmup_frames=12)
    assert drive.frame_count(tr, 30) == 12 + 300 + 10
    assert cell.merge({"a": {"b": 1, "c": 2}}, {"a": {"b": 3}}) == {"a": {"b": 3, "c": 2}}
