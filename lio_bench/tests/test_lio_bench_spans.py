"""The per-layer metrics that read the program's own spans and counters
(`svnicp_tpu_torch/runtime/profiling.py`), on a traced run of the live
cell at the cut size on the CPU: the four the CPU feeds read positive
numbers, the map's device time reads nothing without a card, and a
program without the spans leaves all five out of the line."""

import pytest

from lio_bench.harness import cell

SPAN_METRICS = ("align_launch_ms_per_iter", "align_wait_ms_per_iter",
                "filter_ms_per_frame", "host_syncs_per_frame")


@pytest.fixture(scope="module")
def traced():
    from lio_bench.tests.conftest import SMALL

    return cell.run_cell("geode_alpha.live10hz", 2**31 + 11, 1.0, True, device="cpu",
                         overrides=SMALL)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metrics_read_positive_numbers_on_the_cpu(traced, name):
    assert traced["correct"], traced["checks"]
    assert traced["metrics"][name]["value"] > 0


def test_map_device_time_reads_nothing_without_a_card(traced):
    assert "map_device_ms_per_frame" not in traced["metrics"]


def test_syncs_cover_every_iteration_and_the_launch_is_the_self_time(traced):
    m = {k: v["value"] for k, v in traced["metrics"].items()}
    # one stop read per iteration, besides the degeneracy, align_ok and upload ones
    assert m["host_syncs_per_frame"] > m["align_iters_per_frame"]
    assert m["align_launch_ms_per_iter"] > m["align_wait_ms_per_iter"] > 0


def test_a_program_without_spans_leaves_them_out(monkeypatch, small):
    from svnicp_tpu_torch.runtime import profiling

    monkeypatch.delattr(profiling, "tracing")
    r = cell.run_cell("geode_alpha.live10hz", 7, 1.0, True, device="cpu",
                      overrides=small)
    assert {"stage_ms_per_frame", "align_iters_per_frame"} <= set(r["metrics"])
    assert not set(r["metrics"]) & set(SPAN_METRICS + ("map_device_ms_per_frame",))
