"""The port's JSONL records (`svnicp_tpu_torch/io/records.py`) against the
JAX package's `svnicp_tpu/io/records.py`: for the same frame values (a
FrameOutput of float32 tensors in the port, numpy arrays in the JAX
package), `frame_records` gives equal records and `JSONLWriter` equal
lines, in ICP and KF mode and with a particle history
(`save_particles`); `ParametersRecord.from_config` equals the JAX
package's for the same YAML; `quaternion_from_matrix` takes every branch
alike.
"""

import io
import pathlib
import types

import numpy as np
import pytest
import torch

from svnicp_tpu import config as jcfg
from svnicp_tpu.io import records as jrec
from svnicp_tpu_torch import config as tcfg
from svnicp_tpu_torch.core import geometry as tgeo
from svnicp_tpu_torch.io import records as trec
from svnicp_tpu_torch.runtime import pipeline as tpl

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _frame(seed: int, iterations: int, history_rows: int, p: int = 6):
    """One frame's values as numpy float32 arrays, keyed by FrameOutput field."""
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return rng.normal(size=shape).astype(np.float32)

    rot = tgeo.so3_exp(torch.tensor(rng.normal(size=3), dtype=torch.float32)).numpy()
    vals = dict(pose_r=rot, pose_t=f32(3), guess_r=rot, guess_t=f32(3),
                velocity=f32(3), particles=f32(p, 6),
                weights=np.full(p, 1.0 / p, np.float32), var_icp=f32(6),
                var_mean=f32(6), var_max_sliding=f32(6), var_random_walk=f32(6),
                cov=f32(6, 6), icp_grad_norm=np.float32(0.01),
                map_points=np.int64(1234), map_dropped=np.int64(0),
                target_overflow=np.int64(0), kf_gain=f32(15, 6),
                kf_cov_diag=f32(15), history=f32(history_rows, p, 6))
    return vals, iterations


def _outputs(vals, iterations):
    t = {k: torch.from_numpy(np.asarray(v).copy()) for k, v in vals.items()}
    port = tpl.FrameOutput(icp_iterations=iterations, align_ok=True, imu_dropped=0, **t)
    jax_like = types.SimpleNamespace(icp_iterations=np.int32(iterations),
                                     align_ok=np.bool_(True), **vals)
    return port, jax_like


def _lines(mod, recs) -> str:
    buf = io.StringIO()
    mod.JSONLWriter(buf).write_all(recs)
    return buf.getvalue()


@pytest.mark.parametrize("kf,history_rows,iterations", [
    (False, 0, 12), (True, 0, 7), (False, 20, 9), (True, 20, 0)])
def test_frame_records_and_lines_equal(kf, history_rows, iterations):
    port, jax_like = _outputs(*_frame(kf + history_rows, iterations, history_rows))
    got = trec.frame_records(0.25, port, include_kf_gain=kf)
    want = jrec.frame_records(0.25, jax_like, include_kf_gain=kf)
    assert [type(r).__name__ for r in got] == [type(r).__name__ for r in want]
    names = [type(r).__name__ for r in got]
    assert ("KFGainRecord" in names) == kf
    assert ("ParticleHistoryRecord" in names) == (history_rows > 0 and iterations > 0)
    assert _lines(trec, got) == _lines(jrec, want)
    runtime = [m.RuntimeRecord(stamp=0.25, preprocessing_time=0.001,
                               steinicp_time=0.02, finish_iter=iterations)
               for m in (trec, jrec)]
    assert _lines(trec, runtime[:1]) == _lines(jrec, runtime[1:])


@pytest.mark.parametrize("config", ["tpu_plane", "geode_alpha", "generic_svgd",
                                    "tpu_features", None])
def test_parameters_record_equal(config):
    if config is None:
        tc, jc = tcfg.PipelineConfig(), jcfg.PipelineConfig()
    else:
        path = str(ROOT / "configs" / f"{config}.yaml")
        tc, jc = tcfg.from_yaml(path), jcfg.from_yaml(path)
    got = trec.ParametersRecord.from_config(tc)
    want = jrec.ParametersRecord.from_config(jc)
    assert _lines(trec, [got]) == _lines(jrec, [want])


def test_quaternion_branches():
    rng = np.random.default_rng(5)
    mats = [np.eye(3), np.diag([1.0, -1.0, -1.0]), np.diag([-1.0, 1.0, -1.0]),
            np.diag([-1.0, -1.0, 1.0])]
    for _ in range(20):
        w = rng.normal(size=3)
        w *= rng.uniform(2.5, 3.1) / np.linalg.norm(w)    # near pi: trace < 0
        mats.append(tgeo.so3_exp(torch.from_numpy(w)).numpy())
    for m in mats:
        assert trec.quaternion_from_matrix(m) == jrec.quaternion_from_matrix(m)
