"""The cell `subt_mrs_fullmap.live10hz` (the SubT-MRS deployment with its
map and registration target at 2^20 rows, fed live at 10 Hz) on the CPU at
a cut size, the look for a card skipped: the map and the target cut alike,
so they hold the cut drive whole as 2^20 rows hold the live drive on the
card. The sound timed path is `correct`, and reads 0 for the size
guarantees the configuration states; each fault of `harness/faults.py`
planted under it, and the control (the plain reference in TF32 put in the
program's place), are not. The untraced line reports the cell's end-to-end
metrics, and a traced one leaves the stage-1 roofline out on the CPU,
where no B1 kernel runs."""

import copy
import types

import pytest
import torch

from lio_bench import control
from lio_bench.harness import cell, faults

torch.set_num_threads(2)

NAME = "subt_mrs_fullmap.live10hz"
# capacities cut alike, and large enough to hold the cut drive whole;
# 2,000-point scans, a 0.5 s window (5 scans) after 2 warm-up frames. A
# 512-row source registers about as the card's 8,192 rows do (float32 gaps
# ~1 mm against the reference); at 256 rows the float32 registration is
# poorly conditioned and its gaps reach the card's limits
CUT = {"pipeline": {"icp": {"source_capacity": 512, "target_capacity": 16384},
                    "map": {"capacity": 16384},
                    "preprocess": {"raw_capacity": 4096}},
       "traffic": {"scan": {"points": 2000}, "warmup_frames": 2, "check_frames": 3,
                   "trace_start": 1, "trace_frames": 3}}
SEED = 2**32 + 20
SECONDS = 0.5


@pytest.fixture
def cut():
    return copy.deepcopy(CUT)


@pytest.fixture(scope="module")
def sound():
    return cell.run_cell(NAME, SEED, SECONDS, False, device="cpu",
                         overrides=copy.deepcopy(CUT))


def test_the_sound_timed_path_is_correct(sound):
    assert sound["correct"] is True, sound["checks"]
    assert sound["attempted"] == 5 and sound["failed"] == 0


def test_the_result_reports_the_cells_end_to_end_metrics(sound):
    assert set(sound["metrics"]) == {"latency_ms_p95", "setup_s"}


@pytest.mark.parametrize("fault", list(faults.FAULTS))
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch, cut):
    faults.FAULTS[fault](monkeypatch.setattr)
    r = cell.run_cell(NAME, SEED, SECONDS, False, device="cpu", overrides=cut)
    assert r["correct"] is False, r["checks"]


def test_the_stated_size_guarantees_are_checked(sound):
    """SubT's configuration states that no map row is shed and that the
    target takes every map point in reach: both counts are checked, on
    every frame, with the limit 0; GEODE's states neither."""
    for name in ("map_dropped", "target_overflow"):
        assert sound["checks"][name] == {"value": 0, "limit": 0.0}
    assert not {"map_dropped", "target_overflow"} & set(
        cell.limits(cell.find_cell("geode_alpha.live10hz")))


def test_half_the_capacity_sheds_map_rows_and_is_not_correct(cut):
    """Map and target cut to 12,288 rows, which the cut drive fills to ~65%
    (~8,000 rows) as the live drive fills ~66% of 2^20 on the card: the
    sound run sheds nothing, and the program at half the stated capacities
    sheds map rows, which the check of the map guarantee catches."""
    cut["pipeline"]["icp"]["target_capacity"] = cut["pipeline"]["map"]["capacity"] = 12288
    r = cell.run_cell(NAME, SEED, SECONDS, False, device="cpu", overrides=copy.deepcopy(cut))
    assert r["correct"] is True, r["checks"]
    assert r["checks"]["map_dropped"]["value"] == r["checks"]["target_overflow"]["value"] == 0
    patch = faults.Patch()
    faults.half_capacity(patch.setattr)
    try:
        r = cell.run_cell(NAME, SEED, SECONDS, False, device="cpu", overrides=cut)
    finally:
        patch.undo()
    assert r["correct"] is False and r["checks"]["map_dropped"]["value"] > 0, r["checks"]


def test_the_tf32_control_is_not_correct(cut):
    r = control.control_numbers(NAME, 5, 4, "cpu", cut)
    assert r["correct"] is False, r["numbers"]


def test_a_traced_run_leaves_the_stage1_roofline_out_on_the_cpu(cut):
    """The probe keeps each stage-1 call's valid rows and reads the
    program's stage-1 counter, but no B1 kernel ran, so the share has no
    device time to stand on; the metrics the CPU feeds are there."""
    r = cell.run_cell(NAME, SEED + 1, SECONDS, True, device="cpu", overrides=cut)
    assert r["correct"] is True, r["checks"]
    assert "candidates_roofline_pct" not in r["metrics"]
    assert {"stage_ms_per_frame", "align_iters_per_frame",
            "host_syncs_per_frame"} <= set(r["metrics"])
    mod = cell.metric_module("candidates_roofline_pct")
    assert mod.bound_s(8192, 2**20, 8192, 2**20, 100) == pytest.approx(
        8.0 * 8192 * 2**20 / 67e12)


def _stage1_run(calls, kernel_s, counted=True):
    from svnicp_tpu_torch.runtime import profiling

    trace = profiling.Trace()
    if counted:
        trace.counters["svnicp.candidates.scores"] = sum(b * nt for _, _, b, nt, _ in calls)
    state = {"calls": [(torch.tensor(s), torch.tensor(t), b, nt, k)
                       for s, t, b, nt, k in calls], "trace": trace}
    return types.SimpleNamespace(probes={"candidates_roofline_pct": state},
                                 trace=types.SimpleNamespace(kernel_s=kernel_s))


def test_the_stage1_roofline_counts_valid_pairs_not_padding():
    """Two calls over a 2^20-row target, 600,000 and 650,000 rows valid
    (the map's fill over a traced stretch): the bound counts 8 operations
    per pair of valid rows, so the padding the kernel scores is no work,
    and a program without the stage-1 counter reads nothing."""
    mod = cell.metric_module("candidates_roofline_pct")
    calls = [(8192, 600_000, 8192, 2**20, 100), (8000, 650_000, 8192, 2**20, 100)]
    kernel_s = {"stage1_prep_kernel": 0.0002, "void stage1_kernel<100>": 0.0038,
                "point_moments_kernel": 1.0}
    need = 8.0 * (8192 * 600_000 + 8000 * 650_000) / 67e12
    got = mod.read(_stage1_run(calls, kernel_s))
    assert got == pytest.approx(100.0 * need / 0.004)
    full = mod.read(_stage1_run([(8192, 2**20, 8192, 2**20, 100)] * 2, kernel_s))
    assert got < 0.64 * full
    assert mod.read(_stage1_run(calls, kernel_s, counted=False)) is None
    assert mod.read(_stage1_run(calls, {"point_moments_kernel": 1.0})) is None


def test_the_stage1_probe_leaves_the_kernel_wrappers_in_place():
    """B1's wrapper counts its launches on the module's own function
    object, so the probe wraps the stage-1 entry above it and leaves every
    kernel wrapper as it found it."""
    from svnicp_tpu_torch.kernels import knn, nn

    mod = cell.metric_module("candidates_roofline_pct")
    b1, entry = nn.bucketed_candidates, knn.find_candidate_points
    state = {}
    with mod.probe(state, None):
        assert nn.bucketed_candidates is b1 and hasattr(b1, "launches")
        assert knn.find_candidate_points is not entry
    assert knn.find_candidate_points is entry
