"""The yardstick of the two cells stays where it was: the drives that the
traffic files give (the first frames' scans, ground truth, IMU samples and
particle draws, digested) and the judge's numbers for one seed of each
cell at the cut sizes the other tests use, both recorded before the drive
learnt sweeps and the judge learnt to load the reference a configuration
names. A traffic file without `scan.sweep` has to give the same bytes."""

import copy
import hashlib

import numpy as np
import pytest
import torch

from lio_bench.harness import cell, drive, judge
from lio_bench.tests.conftest import SMALL
from lio_bench.tests.test_lio_bench_subt_fullmap import CUT

torch.set_num_threads(2)

DIGESTS = {   # 6 frames of 2,000-point scans, seed 2**33 + 5
    ("live_10hz_100m_imu", 10):
        "83805345db50df1fdbcb22d104fba4e7e348a2b6ef25e5ac249ce7fc6b48d98e",
    ("live_10hz_60m", 30):
        "3dd11f4d85164a625e1aa591f325a8b002d2ce37b24919887f3d4029725b4e62",
    ("replay_100m_imu", 10):
        "83805345db50df1fdbcb22d104fba4e7e348a2b6ef25e5ac249ce7fc6b48d98e",
    ("replay_60m", 30):
        "3dd11f4d85164a625e1aa591f325a8b002d2ce37b24919887f3d4029725b4e62",
}

JUDGED = {
    "geode_alpha.live10hz": (2**32 + 3, 1.0, SMALL, {
        "guess_gap_m": 6.720190994068416e-07, "pose_gap_m": 6.627960771031777e-07,
        "reg_t_gap_m": 0.0010564026674586811, "reg_r_gap_rad": 2.973082718763844e-05,
        "var_gap_rel": 0.1989394707728813, "conv_t_gap_m": 0.0010500228625426535,
        "conv_r_gap_rad": 2.973082718763844e-05, "stop_ratio": 1.0618129518150683,
        "map_mismatch": 0.0, "_ref_failed": 0, "_sampled": 3}),
    "subt_mrs_fullmap.live10hz": (2**32 + 20, 0.5, CUT, {
        "guess_gap_m": 5.432754814449294e-07, "pose_gap_m": 5.321525224531597e-07,
        "reg_t_gap_m": 0.0006957128706393648, "reg_r_gap_rad": 1.966150853481564e-05,
        "var_gap_rel": 0.04355346708694965, "conv_t_gap_m": 0.0006957128706393648,
        "conv_r_gap_rad": 1.966150853481564e-05, "stop_ratio": 0.0,
        "map_mismatch": 0.0, "_ref_failed": 0, "_sampled": 3}),
}


def digest(d: drive.Drive) -> str:
    h = hashlib.sha256()
    for a in (d.times, d.rots, d.trans, d.particles, *d.scans):
        h.update(np.ascontiguousarray(a).tobytes())
    for window in d.imu:
        for t, acc, gyro in window:
            h.update(np.float64(t).tobytes())
            h.update(np.asarray(acc).tobytes())
            h.update(np.asarray(gyro).tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name,particles", list(DIGESTS), ids=lambda x: str(x))
def test_a_traffic_file_gives_the_drive_it_gave(name, particles):
    tr = cell.merge(cell.load_yaml(cell.BENCH / "traffic" / f"{name}.yaml"),
                    {"scan": {"points": 2000}})
    assert "sweep" not in tr["scan"]
    d = drive.make_drive(tr, 2**33 + 5, 6, particles, *drive.prior_box({}))
    assert digest(d) == DIGESTS[(name, particles)]
    assert all(s.dtype == np.float32 and s.shape[1] == 3 for s in d.scans)


@pytest.mark.parametrize("name", list(JUDGED))
def test_the_judge_gives_the_numbers_it_gave(name, monkeypatch):
    seed, seconds, cut, want = JUDGED[name]
    got = {}
    orig = judge.judge

    def kept(*args, **kwargs):
        got.update(orig(*args, **kwargs))
        return got

    monkeypatch.setattr(judge, "judge", kept)
    r = cell.run_cell(name, seed, seconds, False, device="cpu", overrides=copy.deepcopy(cut))
    assert r["correct"] is True, r["checks"]
    assert {k: got[k] for k in want} == want
