"""The SubT-MRS deployment at its full map (`lio_bench/configs/
subt_mrs_fullmap.yaml`: the constant-velocity ICP estimator, SVN with 30
particles over the source, stop 1e-4, 0.2 m voxels of one point, map and
registration target of equal capacity) through the port's `LIOPipeline` on
the raw route, held frame by frame to the benchmark's plain reference
(`lio_bench/reference/svn_odometry.py`, which imports neither JAX nor the
program) in float64 on the CPU.

The drive is the benchmark's own (`lio_bench/harness/drive.py`, the
`live_10hz_60m` traffic) with 2,500-point scans, and the capacities are
cut alike: the map and the target hold the cut drive whole, as 2^20 rows
hold the live drive on the card, so no frame sheds a map row or leaves a
map point out of stage 1. The reference follows the run's state as the
benchmark's judge does: the next guess is made from the run's poses, and
each stage works from the run's own input to it (the run's staged source
and map cloud, the map as the run left it), so every comparison is of one
stage's arithmetic: on every frame the constant-velocity guess, the
target the map query cuts (rows in order), the stage-1 candidates, the
ensemble mean and variance after the run's iterations, the published pose,
and the map's rows in order after the insert. The staged clouds are held to
the reference's staging as sets of rows: their order is the hash order of
their voxel keys, and on an exact voxel edge (a float32 scan coordinate
such as 22.5 on the 0.3 m grid) the program's key, which multiplies by the
reciprocal of the voxel size as the JAX package's compiled code does, and
the reference's, which divides, can differ by one, which reorders the
rows without changing them. Two witnesses, one at half the map's capacity
and one at half the target's, shed map rows and leave target rows out,
and the two still agree (both shed and compact by the same hashes). Stage 1's plain path is also held to the reference's candidates at
a target of 131,072 rows with k=100.

Tolerances: the float64 program and the float64 reference compute the same
sums in different orders, so they differ by rounding alone, a few units in
the last place of each operation (~1e-16 relative); 100 iterations of the
SVN loop carry that to at most ~1e-12 m. Every limit below is 1e-9 (of a
metre, a radian, or relative for the variances): a thousand times that
rounding and a million times below what the float32 program reads against
the reference on the card (~1e-3 m).
"""

import copy
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from lio_bench.harness import drive as drive_mod
from lio_bench.reference import svn_odometry as ref
from svnicp_tpu_torch import config as cfg_mod
from svnicp_tpu_torch.core import svn, voxmap
from svnicp_tpu_torch.kernels import nn
from svnicp_tpu_torch.runtime import pipeline as pl

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
N_FRAMES = 4
CAPACITY = 4096          # holds the cut drive whole (the test asserts it)
TOL = 1e-9


def _config(capacity: int) -> dict:
    doc = yaml.safe_load((ROOT / "lio_bench/configs/subt_mrs_fullmap.yaml").read_text())
    cfg = copy.deepcopy(doc["pipeline"])
    assert cfg["map"]["capacity"] == cfg["icp"]["target_capacity"] == 2**20
    cfg["icp"].update(source_capacity=256, target_capacity=capacity)
    cfg["map"]["capacity"] = capacity
    cfg["preprocess"]["raw_capacity"] = 4096
    cfg["dtype"] = "float64"
    return cfg


def _drive():
    tr = yaml.safe_load((ROOT / "lio_bench/traffic/live_10hz_60m.yaml").read_text())
    tr["scan"]["points"] = 2500
    icp = _config(CAPACITY)["icp"]
    return drive_mod.make_drive(tr, 2**33 + 7, N_FRAMES, int(icp["particle_count"]),
                                *drive_mod.prior_box(icp))


def _run(cfg: dict, drv, monkeypatch):
    """The port's pass over the drive, with each stage-1 call's operands and
    candidates, each map insert's cloud, and the map after each frame."""
    calls, clouds = [], []
    cands, insert = svn._candidates, voxmap.insert

    def kept_candidates(icp, source, src_valid, target, tgt_valid, r0, t0):
        out = cands(icp, source, src_valid, target, tgt_valid, r0, t0)
        calls.append((source, src_valid, target, tgt_valid) + tuple(out))
        return out

    def kept_insert(vmap, scan, *args):
        clouds.append(scan)
        return insert(vmap, scan, *args)

    monkeypatch.setattr(svn, "_candidates", kept_candidates)
    monkeypatch.setattr(voxmap, "insert", kept_insert)
    pipe = pl.LIOPipeline(cfg_mod.from_dict(cfg), device="cpu")
    maps = []
    for k in range(N_FRAMES):
        pipe.feed_scan(float(drv.times[k]), drv.scans[k],
                       init_particles=drv.particles[k])
        maps.append(pipe.state.vmap)
    pipe.close()
    return pipe.outputs, calls, clouds, maps


def _same_rows(a_pts, a_valid, b_pts, b_valid, a_key=None, b_key=None):
    """The same rows in the same order (and keys), to TOL metres."""
    assert torch.equal(a_valid.cpu(), b_valid.cpu())
    if a_key is not None:
        assert torch.equal(a_key.to(torch.int64), b_key.to(torch.int64))
    gap = (a_pts.double() - b_pts.double())[a_valid].abs().max() if a_valid.any() else 0.0
    assert float(gap) <= TOL, float(gap)


def _same_set(a_pts, a_valid, b_pts, b_valid):
    """The same rows, in any order (a staged cloud: see the module's note)."""
    a, b = (np.unique(p[v].double().numpy(), axis=0)
            for p, v in ((a_pts, a_valid), (b_pts, b_valid)))
    assert int(a_valid.sum()) == int(b_valid.sum()) == len(a) == len(b)
    assert np.abs(a - b).max() <= TOL


def _follow(cfg: dict, drv, outs, calls, clouds, maps) -> dict:
    """The reference along the run's state; asserts every frame's parity and
    returns the largest gap of each kind."""
    ops = ref.Ops(ref.Precision(torch.float64), "cpu")
    icp, pp, mcfg = cfg["icp"], cfg["preprocess"], cfg["map"]
    vmap = ref.VoxelMap.empty(int(mcfg["capacity"]), ops)
    eye, zero = torch.eye(3, dtype=torch.float64), torch.zeros(3, dtype=torch.float64)
    gaps = dict.fromkeys(("guess", "mean", "var", "pose"), 0.0)
    poses = []
    assert len(clouds) == N_FRAMES and len(calls) == N_FRAMES - 1
    for k in range(N_FRAMES):
        out, cloud = outs[k], clouds[k]
        cropped, to_map, source = ref.stage(ops, drv.scans[k], cfg)
        if k == 0:
            guess_r, guess_t = eye, zero
            _same_set(cloud.points, cloud.valid, *cropped)
        else:
            pr, pt = poses[k - 2] if k >= 2 else (eye, zero)
            guess_r, guess_t = ref.constant_velocity_guess(
                *poses[k - 1], pr, pt, float(drv.times[k]), float(drv.times[k - 1]),
                float(drv.times[k - 2]) if k >= 2 else 0.0, k)
            src, src_valid, tgt, tgt_valid, cand, cand_valid = calls[k - 1]
            _same_set(src, src_valid, *source)
            _same_set(cloud.points, cloud.valid, *to_map)
            target = ref.map_query(vmap, guess_t, float(pp["max_range"]) + 10.0,
                                   int(icp["target_capacity"]))
            _same_rows(tgt, tgt_valid, *target)
            run_source = (src.double(), src_valid)
            at_guess = ops.mm(run_source[0], guess_r.T) + guess_t
            want, want_valid = ref.candidates(ops, at_guess, src_valid, *target,
                                              int(icp["knn_count"]))
            _same_rows(cand, cand_valid, want, want_valid)
            reg = ref.register(ops, icp, run_source, target, guess_r, guess_t,
                               drv.particles[k], follow=int(out.icp_iterations))
            assert reg.iterations == out.icp_iterations      # the same stop
            m = reg.followed.mean
            gaps["mean"] = max(gaps["mean"], float(np.abs(
                out.particles.mean(0).numpy() - m).max()))
            gaps["var"] = max(gaps["var"], float(np.max(
                np.abs(out.var_icp.numpy() - reg.followed.var) / reg.followed.var)))
            want_r, want_t = ref.compose(guess_r, guess_t, ref.so3_exp(ops.t(m[3:])),
                                         ops.t(m[:3]))
            gaps["pose"] = max(gaps["pose"], float((out.pose_t - want_t).abs().max()),
                               float((out.pose_r - want_r).abs().max()))
            assert out.align_ok
        gaps["guess"] = max(gaps["guess"], float((out.guess_t - guess_t).abs().max()),
                            float((out.guess_r - guess_r).abs().max()))
        # the run's state from here on, as the benchmark's judge follows it
        pose_r, pose_t = out.pose_r.double(), out.pose_t.double()
        vmap = ref.map_insert(ops, vmap, cloud.points.double(), cloud.valid, pose_r,
                              pose_t, mcfg)
        poses.append((pose_r, pose_t))
        _same_rows(maps[k].points, maps[k].valid, vmap.points, vmap.valid,
                   maps[k].key, vmap.key)
    assert all(v <= TOL for v in gaps.values()), gaps
    return gaps


@pytest.fixture(scope="module")
def drive():
    return _drive()


def test_the_cut_drive_fits_whole_and_matches_the_reference(drive, monkeypatch):
    cfg = _config(CAPACITY)
    outs, calls, clouds, maps = _run(cfg, drive, monkeypatch)
    assert len(outs) == N_FRAMES and len(calls) == N_FRAMES - 1
    # the deployment's two guarantees: no map row shed, no target row left out
    assert [int(o.map_dropped) for o in outs] == [0] * N_FRAMES
    assert [int(o.target_overflow) for o in outs] == [0] * N_FRAMES
    rows = [int(m.valid.sum()) for m in maps]
    assert rows == [int(o.map_points) for o in outs]
    assert CAPACITY // 2 < rows[-1] < CAPACITY and rows == sorted(rows)
    # every frame runs the loop (SubT's stop is strict: most reach the cap)
    assert all(o.icp_iterations >= 1 for o in outs[1:])
    _follow(cfg, drive, outs, calls, clouds, maps)


@pytest.mark.parametrize("cut", ["map", "target"])
def test_at_half_the_capacity_both_shed_alike(cut, drive, monkeypatch):
    """The witnesses: at half the capacity the map sheds rows for capacity
    (the target, as large as the map, cannot overflow it), or at half the
    target capacity the map query leaves selected rows out; the reference,
    shedding and compacting by the same hashes, still agrees frame by
    frame."""
    cfg = _config(CAPACITY // 2 if cut == "map" else CAPACITY)
    if cut == "target":
        cfg["icp"]["target_capacity"] = CAPACITY // 2
    outs, calls, clouds, maps = _run(cfg, drive, monkeypatch)
    dropped = sum(int(o.map_dropped) for o in outs)
    overflow = sum(int(o.target_overflow) for o in outs)
    assert (dropped > 0, overflow > 0) == (cut == "map", cut == "target")
    _follow(cfg, drive, outs, calls, clouds, maps)


def test_stage_one_plain_path_matches_the_reference_at_a_large_target():
    """B1's plain version (what the CPU runs) against the reference's
    candidates at 131,072 target rows, k=100 (blocks of 128 rows dealt to
    100 groups, the target padded to 131,200), a third of them invalid,
    with an exact duplicate so that a tie is averaged."""
    rng = np.random.default_rng(20)
    nt, b, k = 131072, 48, 100
    tgt = torch.from_numpy(rng.uniform(-60, 60, (nt, 3)))
    tgt[77] = tgt[5]                                    # a tie in one group
    tv = torch.from_numpy(rng.random(nt) < 0.66)
    tv[[5, 77]] = True
    src = torch.from_numpy(rng.uniform(-50, 50, (b, 3)))
    src[0] = tgt[5] + 1e-3
    sv = torch.from_numpy(rng.random(b) < 0.9)
    sv[0] = True
    cand, d2 = nn.bucketed_candidates_plain(src, tgt, sv, tv, k)
    ops = ref.Ops(ref.Precision(torch.float64), "cpu")
    want, want_valid = ref.candidates(ops, src, sv, tgt, tv, k)
    assert ref.block_size(nt, k) == 128
    valid = torch.isfinite(d2)
    assert torch.equal(valid, want_valid) and int(valid.sum()) == int(sv.sum()) * k
    assert float((cand - want)[valid].abs().max()) <= TOL
    dist = ((want - src[:, None, :]) ** 2).sum(-1)
    assert float((d2 - dist)[valid].abs().max() / dist[valid].max()) <= TOL
