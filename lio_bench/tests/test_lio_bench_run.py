"""A whole run of a cell on the CPU at a cut size (the harness's look for a
card skipped): the result line's keys, a cell added as files alone, and
the refusal without a card."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from lio_bench.harness import cell

ROOT = Path(__file__).resolve().parents[2]
CONTRACT = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name,metrics", [
    ("geode_alpha.live10hz", {"latency_ms_p95", "setup_s"}),
    ("subt_mrs.replay", {"frames_per_s", "frame_ms_p95", "setup_s"})])
def test_result_has_the_contract_keys_and_the_checks_last(name, metrics, small, parked):
    r = cell.run_cell(name, 2**33 + 1, 1.0, False, device="cpu", overrides=small)
    assert list(r) == CONTRACT + ["checks"]
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(r["metrics"]) == metrics
    assert all(set(v) == {"value", "unit"} for v in r["metrics"].values())
    assert r["attempted"] >= 1 and r["failed"] == 0
    json.dumps(r, allow_nan=False)


def test_traced_run_adds_busy_window_and_breakdown(small):
    r = cell.run_cell("geode_alpha.live10hz", 5, 1.0, True, device="cpu", overrides=small)
    assert list(r) == CONTRACT + ["breakdown", "checks"]
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(r["breakdown"]["idle_gaps"]) <= 10
    # the per-layer metrics a CPU trace can feed; device ones read nothing
    assert {"stage_ms_per_frame", "align_iters_per_frame"} <= set(r["metrics"])
    assert "moments_roofline_pct" not in r["metrics"]


def test_a_cell_added_as_files_runs_with_no_code_edit(tmp_path, small):
    """A new traffic file, limits file and manifest entry in a copy of the
    benchmark's files are found by name."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for sub in ("configs", "traffic", "metrics", "limits", "reference"):
        shutil.copytree(ROOT / "lio_bench" / sub, tmp_path / "lio_bench" / sub)
    tr = cell.load_yaml(ROOT / "lio_bench/traffic/live_10hz_100m_imu.yaml")
    tr["scan"]["max_range"] = 40.0
    (tmp_path / "lio_bench/traffic/live_10hz_40m_imu.yaml").write_text(json.dumps(tr))
    shutil.copy(ROOT / "lio_bench/limits/geode_alpha.live10hz.json",
                tmp_path / "lio_bench/limits/geode_alpha.live40m.json")
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["workloads"].append({"name": "geode_alpha.live40m", "config": "geode_alpha",
                             "traffic": "live_10hz_40m_imu", "chips": 1,
                             "why": "a test cell"})
    for m in man["end_to_end"] + man["per_layer"]:
        if "geode_alpha.live10hz" in m.get("workloads", []):
            m["workloads"].append("geode_alpha.live40m")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    c = cell.find_cell("geode_alpha.live40m", tmp_path)
    assert cell.traffic(c, tmp_path)["scan"]["max_range"] == 40.0
    r = cell.run_cell("geode_alpha.live40m", 9, 1.0, False, device="cpu", root=tmp_path,
                      overrides=small)
    assert r["attempted"] >= 1 and "latency_ms_p95" in r["metrics"]


def test_without_a_card_the_command_fails_and_prints_no_result():
    p = subprocess.run([sys.executable, str(ROOT / "lio_bench/run.py"), "--workload",
                        "geode_alpha.live10hz", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_in_a_directory_of_the_benchmark_alone_the_command_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "lio_bench", tmp_path / "lio_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "lio_bench/run.py", "--workload",
                        "geode_alpha.live10hz", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True, timeout=300,
                       cwd=tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_traced_run_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    r = cell.run_cell("geode_alpha.live10hz", 77, 6.0, True)
    assert r["device"]["busy_s"] > 0
    assert 0 < r["metrics"]["moments_roofline_pct"]["value"] <= 100
    assert 0 < r["metrics"]["device_idle_pct.live"]["value"] < 100
    assert r["correct"], r["checks"]
