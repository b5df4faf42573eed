"""BENCHMARK.json against the contract's limits, and every name in it
resolving to its own file under lio_bench/."""

import json
import re
from pathlib import Path

import pytest

from lio_bench.harness import cell

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
        "per_layer"}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(MAN) == KEYS
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= MAN["run_seconds"] <= 51 and isinstance(MAN["run_seconds"], int)
    assert 1 <= len(MAN["paths"]) <= 16 and 1 <= len(MAN["command"]) <= 32
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.endswith("_torch")
               for p in MAN["paths"])
    assert all(_line(w) and not w.startswith("/") and ".." not in w
               for w in MAN["command"])


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units_use_the_allowed_characters(group):
    names = [e["name"] for e in MAN[group]]
    assert len(names) == len(set(names))
    for e in MAN[group]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and group != "end_to_end" and group != "per_layer":
                assert _line(e[key]), (e["name"], key)
        if "layer" in e:
            assert _line(e["layer"])


def test_entries_have_just_the_contract_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")


def test_every_cell_reports_setup_another_end_to_end_and_a_layer_metric():
    for w in MAN["workloads"]:
        e2e = [m["name"] for m in MAN["end_to_end"] if cell.reports(m, w["name"], MAN)]
        layer = [m for m in MAN["per_layer"] if cell.reports(m, w["name"], MAN)]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for m in layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_every_workload_resolves_its_files_by_name(w):
    c = cell.find_cell(w["name"])
    cfg = cell.load_yaml(c.config_file)
    entry = next(x for x in MAN["configs"] if x["name"] == w["config"])
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
    assert cfg["guarantees"] and cfg["assumed"]
    assert (ROOT / "lio_bench" / "reference" / f"{cfg['reference']}.py").exists()
    assert cell.traffic(c)["kind"] in ("replay", "live")
    assert set(cell.limits(c)) >= {"reg_t_gap_m", "var_gap_rel", "map_mismatch"}
    for m in c.metrics:
        mod = cell.metric_module(m["name"])
        assert (mod.UNIT, mod.SOURCE, mod.BETTER) == (m["unit"], m["source"], m["better"])
        if "layer" in m:
            assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])


def test_frozen_configs_load_through_the_port():
    from svnicp_tpu_torch import config

    from lio_bench.harness import judge

    for c in MAN["configs"]:
        doc = cell.load_yaml(ROOT / c["file"])
        d = doc["pipeline"]
        assert config.from_dict(d).dtype == "float32"
        judge.check_supported(cell.reference_module(doc["reference"]), d)
