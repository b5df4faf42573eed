"""Shared settings of the benchmark's own tests: the cut-down sizes at which
a cell runs on the CPU (the CUDA kernels' plain versions), so a whole run
takes seconds."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__)))))

# capacities cut so a frame is milliseconds on the CPU; scans of 3,000 points
SMALL = {"pipeline": {"icp": {"source_capacity": 512, "target_capacity": 4096},
                      "map": {"capacity": 16384},
                      "preprocess": {"raw_capacity": 8192}},
         "traffic": {"frames": 10, "scan": {"points": 3000}, "warmup_frames": 2,
                     "check_frames": 3, "trace_start": 1, "trace_frames": 3}}


@pytest.fixture
def small():
    import copy

    return copy.deepcopy(SMALL)


# The replay cells that BENCHMARK.json leaves out for now (their frame
# rates spread with the host's speed by more than half the largest bound
# the contract allows; PERF.md): their files stay under lio_bench/, and
# the tests run them through this manifest addition, as a later benchmark
# would add them.
PARKED = {
    "configs": [
        {"name": "subt_mrs", "source": "LIS-TU-Berlin/SVN-ICP svn-icp/config/"
         "subt-mrs.yaml:4-35 (SubT-MRS dataset), as translated in configs/subt_mrs.yaml",
         "file": "lio_bench/configs/subt_mrs.yaml", "reduced": [],
         "why": "pure ICP, SVN P=30 over an 8,192-row source, stop 1e-4"}],
    "workloads": [
        {"name": "geode_alpha.replay", "config": "geode_alpha",
         "traffic": "replay_100m_imu", "chips": 1, "why": "closed-loop replay"},
        {"name": "subt_mrs.replay", "config": "subt_mrs", "traffic": "replay_60m",
         "chips": 1, "why": "closed-loop replay"}],
    "end_to_end": [
        {"name": "frames_per_s", "unit": "frames/s", "better": "higher", "bound": 0.25,
         "source": "host_clock", "workloads": ["geode_alpha.replay", "subt_mrs.replay"]},
        {"name": "frame_ms_p95", "unit": "ms", "better": "lower", "bound": 0.25,
         "source": "host_clock", "workloads": ["geode_alpha.replay", "subt_mrs.replay"]}],
    "per_layer": [
        {"name": "device_idle_pct", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "device (H100)", "moves": "frames_per_s",
         "workloads": ["geode_alpha.replay", "subt_mrs.replay"]}],
}


def with_parked(man: dict) -> dict:
    out = {k: (list(v) if isinstance(v, list) else v) for k, v in man.items()}
    for group, entries in PARKED.items():
        out[group] = out[group] + [e for e in entries
                                   if e["name"] not in {x["name"] for x in out[group]}]
    return out


@pytest.fixture
def parked(monkeypatch):
    """BENCHMARK.json with the parked replay cells added."""
    from lio_bench.harness import cell

    real = cell.manifest
    monkeypatch.setattr(cell, "manifest", lambda root=cell.ROOT: with_parked(real(root)))
