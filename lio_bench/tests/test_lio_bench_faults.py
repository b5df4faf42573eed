"""The comparison that decides `correct` fails what it must fail: a run
of a cell on the CPU at a cut size (the look for a card skipped) with the
timed path broken underneath (`harness/faults.py`), and the control, the
plain reference in TF32 put in the program's place. Both configurations
are held to it: GEODE's live cell, and the replay cells kept for a later
benchmark (conftest's `PARKED`). (A cell on one card has no exchange
between cards to leave out.)"""

import pytest

from lio_bench import control
from lio_bench.harness import cell, faults

CELLS = ["geode_alpha.live10hz", "geode_alpha.replay", "subt_mrs.replay"]


@pytest.mark.parametrize("name", CELLS)
def test_the_sound_timed_path_is_correct(name, small, parked):
    """The same cut-down run with nothing broken passes, so the failures
    below are the faults'."""
    r = cell.run_cell(name, 2**32 + 3, 1.0, False, device="cpu", overrides=small)
    assert r["correct"] is True, r["checks"]


@pytest.mark.parametrize("fault", list(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch, small, parked):
    faults.FAULTS[fault](monkeypatch.setattr)
    r = cell.run_cell(name, 2**32 + 3, 1.0, False, device="cpu", overrides=small)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_tf32_control_is_not_correct(name, small, parked):
    r = control.control_numbers(name, 5, 10, "cpu", small)
    assert r["correct"] is False, r["numbers"]


def test_the_program_readings_match_a_live_run(small):
    """control.py's reading of the program (the live pass fed unpaced)
    gives the numbers a run of the live cell gives on the same seed: the
    pipeline's outputs do not depend on the sensor's pacing."""
    name = "geode_alpha.live10hz"
    run = cell.run_cell(name, 11, 1.0, False, device="cpu", overrides=small)
    got = control.program_numbers(name, 11, "cpu", overrides=small, seconds=1.0)
    for k, v in run["checks"].items():
        if k != "failed_frames":
            assert got["numbers"][k] == pytest.approx(v["value"], rel=1e-9, abs=1e-12), k
