"""A configuration names its plain reference, and the judge runs that one:
a reference module found by name under `lio_bench/reference/`, with its
own table of the options it implements. A name with no module is refused
before the drive is made."""

import copy
import shutil
from pathlib import Path

import pytest

from lio_bench.harness import cell, drive, judge
from lio_bench.reference import svn_odometry

ROOT = Path(__file__).resolve().parents[2]
NAME = "geode_alpha.live10hz"

# the table the judge held before each reference declared its own
SVN_SUPPORTED = {
    "icp": {"method": "svn", "residual": "point_to_point", "candidate_method": "bucketed",
            "match_count": 0, "prior_information": False, "stein_kernel": True,
            "svn_full_grad": False, "convergence_metric": "grad_norm",
            "adaptive_prior": False, "use_minibatch": False},
    "preprocess": {"deskew": False, "use_segmentation": False, "feature_select": False,
                   "host_downsample": False, "quantize_upload": False},
    "lio": {"cov_filter": "none", "use_const_cov": False, "init_from_motion": False,
            "textbook_phi": False},
    "map": {"sharded": False},
}

COUNTING = '''"""svn_odometry, counting its registrations."""
from lio_bench.reference import svn_odometry as base
from lio_bench.reference.svn_odometry import *  # noqa: F403

CALLS = []


def register(*args, **kwargs):
    CALLS.append(kwargs.get("follow"))
    return base.register(*args, **kwargs)
'''


def tree(tmp_path: Path, reference: str) -> Path:
    """A checkout's benchmark whose GEODE configuration names `reference`."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "lio_bench", tmp_path / "lio_bench",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    path = tmp_path / "lio_bench" / "configs" / "geode_alpha.yaml"
    text = path.read_text()
    assert "\nreference: svn_odometry\n" in text
    path.write_text(text.replace("\nreference: svn_odometry\n", f"\nreference: {reference}\n"))
    (tmp_path / "lio_bench" / "reference" / "counting.py").write_text(COUNTING)
    return tmp_path


def test_svn_odometry_declares_the_table_the_judge_held():
    assert svn_odometry.SUPPORTED == SVN_SUPPORTED


def test_the_judge_runs_the_reference_the_configuration_names(tmp_path, small):
    root = tree(tmp_path, "counting")
    c = cell.find_cell(NAME, root)
    ref = cell.reference(c)
    assert ref is cell.reference_module("counting", root) and ref.CALLS == []
    r = cell.run_cell(NAME, 2**32 + 3, 1.0, False, device="cpu", root=root,
                      overrides=copy.deepcopy(small))
    assert r["correct"] is True, r["checks"]
    # one registration per sampled frame, each following the run's count
    assert len(ref.CALLS) == 3 and all(isinstance(f, int) for f in ref.CALLS)


def test_an_unknown_reference_is_refused_before_the_drive(tmp_path, small, monkeypatch):
    root = tree(tmp_path, "no_such_reference")

    def made(*args, **kwargs):
        raise AssertionError("the drive was made")

    monkeypatch.setattr(drive, "make_drive", made)
    with pytest.raises(cell.CellError, match="no_such_reference"):
        cell.run_cell(NAME, 1, 1.0, False, device="cpu", root=root, overrides=small)
    with pytest.raises(cell.CellError):
        cell.reference_module("../harness/judge", ROOT)


def test_the_supported_options_are_the_references_own(tmp_path):
    """The judge checks a configuration against the table of the reference
    it names, not a table of its own."""
    d = cell.load_yaml(ROOT / "lio_bench" / "configs" / "geode_alpha.yaml")["pipeline"]
    judge.check_supported(svn_odometry, d)
    root = tree(tmp_path, "counting")
    (root / "lio_bench" / "reference" / "svgd_only.py").write_text(
        "from lio_bench.reference.svn_odometry import *  # noqa: F403\n"
        "SUPPORTED = {'icp': {'method': 'svgd'}}\n")
    with pytest.raises(ValueError, match="icp.method"):
        judge.check_supported(cell.reference_module("svgd_only", root), d)
