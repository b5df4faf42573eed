"""The port's spans and counters (`svnicp_tpu_torch/runtime/profiling.py`):

- off (the default) a span is one shared no-op context and nothing is
  recorded; counters count only inside `tracing()`;
- spans nest with their parents, self times and frame indices, on the
  stage-ahead worker's thread too; nested `tracing()` contexts share one
  recording; the StageTimer's stages are spans timed by the same clock
  reads;
- under a CPU `torch.profiler` every `svnicp.*` span is a CPU operation
  and not a user annotation (which the profiler would draw on the
  device's timeline as well);
- a traced float64 KF drive on the CPU (geode_alpha's filter, point-to-
  point SVN at a cut size) has each layer span once in every frame, one
  `svnicp.align.iter` and one `svnicp.sync.stop` per iteration, no child
  longer than its parent, and outputs bitwise equal to the same drive
  untraced;
- the ICP estimator's frames each open one `svnicp.predict` (a KF frame
  none), and stage 1 counts B x Nt scores and Nt target rows a call.
"""

import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from svnicp_tpu_torch import config as cfg_mod
from svnicp_tpu_torch.core.imu import GRAVITY
from svnicp_tpu_torch.io import datasets
from svnicp_tpu_torch.runtime import pipeline as pl
from svnicp_tpu_torch.runtime import profiling

torch.set_num_threads(2)

N_FRAMES = 6
IMU_PER_FRAME = 5
CFG = dict(
    icp=dict(method="svn", residual="point_to_point", particle_count=8,
             iterations=100, max_dist=3.0, knn_count=16, early_stop=True,
             convergence_threshold=5e-4, source_capacity=256,
             target_capacity=4096, use_pallas=True),
    map=dict(voxel_size=1.0, max_points_per_voxel=20, max_range=300.0,
             capacity=8192),
    preprocess=dict(min_range=2.0, max_range=100.0, voxel_size=1.0,
                    raw_capacity=4096),
    lio=dict(estimator="kf", frame_gap_seconds=0.0,
             extrinsic_t=[0.0961, -0.1338, 0.3032],
             extrinsic_R=[0.9999, 0.0049, 0.0153, -0.0050, 1.0000, 0.0021,
                          -0.0153, -0.0022, 0.9999]),
    dtype="float64",
)
# the layer spans of a registered frame on the raw route, each once
LAYERS = ("svnicp.frame", "svnicp.stage", "svnicp.dispatch", "svnicp.preprocess",
          "svnicp.filter.predict", "svnicp.map.query", "svnicp.candidates",
          "svnicp.align", "svnicp.filter.update", "svnicp.map.insert")


def _drive():
    world = datasets.SyntheticWorld(extent=30.0, seed=1)
    n_imu = (N_FRAMES - 1) * IMU_PER_FRAME + 1
    times, rots, trans = datasets.synthetic_trajectory(
        n_imu, dt=0.1 / IMU_PER_FRAME, speed=1.0, seed=1)
    imu = datasets.synthetic_imu(times, rots, trans, GRAVITY)
    rng = np.random.default_rng(1)
    frames = range(0, n_imu, IMU_PER_FRAME)
    scans = [(float(times[i]), world.scan_at(rng, rots[i], trans[i], n_points=2500))
             for i in frames]
    draws = [None] + [np.random.default_rng(10 + k).uniform(-0.1, 0.1, (8, 6))
                      for k in range(1, N_FRAMES)]
    return scans, imu, draws


def _run(cfg_dict, traced: bool):
    scans, imu, draws = _drive()
    pipe = pl.LIOPipeline(cfg_mod.from_dict(cfg_dict), device="cpu")
    trace = None
    with profiling.tracing() if traced else contextlib.nullcontext() as trace:
        j = 0
        for k, (t, points) in enumerate(scans):
            while j < len(imu) and imu[j][0] <= t:
                pipe.feed_imu(*imu[j])
                j += 1
            pipe.feed_scan(t, points, init_particles=draws[k])
        pipe.close()
    return pipe, trace


@pytest.fixture(scope="module")
def runs():
    return _run(CFG, True), _run(CFG, False)


def test_off_records_nothing_and_shares_one_noop():
    x = torch.zeros(3)
    a = profiling.span("svnicp.a")
    b = profiling.span("svnicp.b", on=x, frame=3)
    assert a is b and not isinstance(a, profiling.Span)
    with a:
        profiling.count("svnicp.n", 4)
    with profiling.tracing() as trace:
        pass
    assert trace.spans == [] and trace.counters == {}
    assert profiling._recording is None


def test_spans_nest_with_parents_self_times_and_frames():
    with profiling.tracing() as trace:
        with profiling.span("svnicp.frame", frame=7):
            time.sleep(0.002)
            with profiling.span("svnicp.align"):
                for _ in range(2):
                    with profiling.span("svnicp.align.iter"):
                        time.sleep(0.001)
                        with profiling.span("svnicp.sync.stop"):
                            time.sleep(0.001)
        with profiling.span("svnicp.frame", frame=8):
            pass
    names = [s.name for s in trace.spans]
    assert names == ["svnicp.frame", "svnicp.align"] + [
        "svnicp.align.iter", "svnicp.sync.stop"] * 2 + ["svnicp.frame"]
    s = trace.spans
    assert [x.parent for x in s] == [None, 0, 1, 2, 1, 4, None]
    assert [x.frame for x in s] == [7] * 6 + [8]
    for i, x in enumerate(s):
        kids = [c for c in s if c.parent == i]
        assert x.self_ns == x.ns - sum(c.ns for c in kids)
        assert x.self_ns >= 0 and sum(c.ns for c in kids) <= x.ns
        assert x.device_ms is None
    assert s[0].self_ns >= 2e6 and s[2].self_ns >= 1e6


def test_worker_thread_spans_carry_their_own_frame():
    ready = threading.Event()

    def worker():
        with profiling.span("svnicp.stage", frame=6):
            with profiling.span("svnicp.inner"):
                ready.set()

    with profiling.tracing() as trace:
        with profiling.span("svnicp.frame", frame=5):
            th = threading.Thread(target=worker)
            th.start()
            th.join(timeout=10)
            assert not th.is_alive() and ready.is_set()
    by = {s.name: s for s in trace.spans}
    assert by["svnicp.stage"].parent is None and by["svnicp.stage"].frame == 6
    assert by["svnicp.inner"].frame == 6
    assert trace.spans[by["svnicp.inner"].parent].name == "svnicp.stage"
    assert by["svnicp.stage"].thread != by["svnicp.frame"].thread
    assert by["svnicp.frame"].frame == 5


def test_nested_tracing_contexts_share_one_recording():
    with profiling.tracing() as outer:
        with profiling.span("svnicp.before"):
            pass
        with profiling.tracing() as inner:
            assert profiling._recording is not None
            with profiling.span("svnicp.inside"):
                profiling.count("svnicp.n", 2)
        assert profiling._recording is not None
        profiling.count("svnicp.n")
    assert profiling._recording is None
    assert [s.name for s in outer.spans] == ["svnicp.before", "svnicp.inside"]
    assert [s.name for s in inner.spans] == ["svnicp.inside"]
    assert outer.counters == {"svnicp.n": 3} and inner.counters == {"svnicp.n": 2}


def test_counters_count():
    with profiling.tracing() as trace:
        for n in (1, 2, 3):
            profiling.count("svnicp.imu_samples", n)
        profiling.count("svnicp.other")
    profiling.count("svnicp.imu_samples", 100)      # off again: not counted
    assert trace.counters == {"svnicp.imu_samples": 6, "svnicp.other": 1}


def test_stage_timer_stages_are_spans_on_the_same_clock_reads():
    timer = profiling.StageTimer()
    with profiling.tracing() as trace:
        with timer.span("preprocess", frame=2):
            time.sleep(0.001)
        with timer.span("dispatch"):
            pass
    stage, dispatch = trace.spans
    assert (stage.name, stage.frame) == ("svnicp.stage", 2)
    assert dispatch.name == "svnicp.dispatch"
    assert timer.last["preprocess"] == stage.ns * 1e-9
    assert timer.last["dispatch"] == dispatch.ns * 1e-9
    with timer.span("preprocess"):               # off: timed, not recorded
        pass
    assert timer.counts["preprocess"] == 2 and len(trace.spans) == 2


def test_profiler_sees_spans_as_cpu_ops_not_user_annotations():
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.tracing() as trace:
            with profiling.span("svnicp.frame", on=torch.ones(2)):
                with profiling.span("svnicp.align"):
                    torch.ones(4).sum()
    ours = [e for e in prof.events() if e.name.startswith("svnicp.")]
    assert sorted(e.name for e in ours) == ["svnicp.align", "svnicp.frame"]
    for e in ours:
        assert e.device_type == DeviceType.CPU and not e.is_user_annotation
    assert len(trace.spans) == 2


def test_traced_drive_has_each_layer_span_once_per_frame(runs):
    (pipe, trace), _ = runs
    iters = [o.icp_iterations for o in pipe.outputs]
    assert len(iters) == N_FRAMES and all(o.align_ok for o in pipe.outputs)
    assert min(iters[1:]) >= 1
    frames = trace.named("svnicp.frame")
    assert [s.frame for s in frames] == list(range(N_FRAMES))
    for k in range(1, N_FRAMES):
        mine = [s.name for s in trace.spans if s.frame == k]
        for name in LAYERS:
            assert mine.count(name) == 1, (k, name)
        assert mine.count("svnicp.align.iter") == iters[k]
        assert mine.count("svnicp.sync.stop") == iters[k]
        assert mine.count("svnicp.upload") == 2          # the scan, the IMU window
        assert mine.count("svnicp.sync.degenerate") == 1
        assert mine.count("svnicp.sync.align_ok") == 2
    assert len(trace.named("svnicp.align.iter")) == sum(iters)
    assert len(trace.named("svnicp.sync.stop")) == sum(iters)
    # stage 1 counts B x Nt and Nt per call, from the capacities
    icp = CFG["icp"]
    calls = N_FRAMES - 1
    # the CPU's align rounds are one pass each, issued op by op
    assert trace.counters == {
        "svnicp.imu_samples": IMU_PER_FRAME * (N_FRAMES - 1),
        "svnicp.candidates.scores": calls * icp["source_capacity"] * icp["target_capacity"],
        "svnicp.candidates.target_rows": calls * icp["target_capacity"],
        "svnicp.align.eager_rounds": sum(iters),
        "svnicp.map.run_searches": N_FRAMES + calls}     # each insert, each query
    assert len(trace.named("svnicp.map.insert")) == N_FRAMES
    assert len(trace.named("svnicp.map.query")) == calls
    assert len(trace.named("svnicp.candidates")) == calls
    # the constant-velocity guess's span is the ICP estimator's alone
    assert trace.named("svnicp.predict") == []
    for i, s in enumerate(trace.spans):
        kids = [c for c in trace.spans if c.parent == i]
        assert sum(c.ns for c in kids) <= s.ns and s.self_ns >= 0
        for c in kids:
            assert s.start_ns <= c.start_ns <= c.end_ns <= s.end_ns
            assert c.frame == s.frame and c.thread == s.thread
    # the StageTimer's stages are the trace's spans
    stages = trace.named("svnicp.stage")
    assert [s.ns * 1e-9 for s in stages] == [
        ft["preprocessing_time"] for ft in pipe.frame_timings]


def test_icp_frame_opens_one_predict_span_and_counts_stage_one():
    """The ICP estimator's frames (the bootstrap's too) each open one
    `svnicp.predict` around the constant-velocity guess, under the step's
    dispatch; each stage-1 call adds B x Nt scores and Nt target rows."""
    cfg = dict(CFG, lio=dict(estimator="icp", frame_gap_seconds=0.0))
    pipe, trace = _run(cfg, True)
    assert len(pipe.outputs) == N_FRAMES and all(o.align_ok for o in pipe.outputs)
    predict = trace.named("svnicp.predict")
    assert [s.frame for s in predict] == list(range(N_FRAMES))
    for s in predict:
        assert trace.spans[s.parent].name == "svnicp.dispatch"
        assert s.device_ms is None                      # no card: no events
    icp = CFG["icp"]
    cands = trace.named("svnicp.candidates")
    assert [s.frame for s in cands] == list(range(1, N_FRAMES))
    assert trace.counters == {
        "svnicp.candidates.scores": len(cands) * icp["source_capacity"]
        * icp["target_capacity"],
        "svnicp.candidates.target_rows": len(cands) * icp["target_capacity"],
        "svnicp.align.eager_rounds": sum(o.icp_iterations for o in pipe.outputs),
        "svnicp.map.run_searches": len(trace.named("svnicp.map.insert"))
        + len(trace.named("svnicp.map.query"))}
    assert not trace.named("svnicp.filter.predict") and not trace.named(
        "svnicp.filter.update")


def test_stage_one_counters_follow_each_call_shape():
    """The counters read the tensors' shapes, call by call."""
    from svnicp_tpu_torch.core import svn

    icp = cfg_mod.from_dict(CFG).icp
    eye, zero = torch.eye(3, dtype=torch.float64), torch.zeros(3, dtype=torch.float64)
    rng = np.random.default_rng(3)
    with profiling.tracing() as trace:
        for b, nt in ((40, 300), (17, 1000)):
            src = torch.from_numpy(rng.normal(size=(b, 3)))
            tgt = torch.from_numpy(rng.normal(size=(nt, 3)))
            svn._candidates(icp, src, torch.ones(b, dtype=torch.bool), tgt,
                            torch.ones(nt, dtype=torch.bool), eye, zero)
    assert trace.counters == {"svnicp.candidates.scores": 40 * 300 + 17 * 1000,
                              "svnicp.candidates.target_rows": 1300}


def test_traced_drive_outputs_equal_the_untraced_bitwise(runs):
    (traced, _), (plain, none) = runs
    assert none is None
    assert len(traced.outputs) == len(plain.outputs) == N_FRAMES
    for a, b in zip(traced.outputs, plain.outputs):
        for name in ("pose_r", "pose_t", "guess_r", "guess_t", "var_icp", "cov",
                     "particles", "kf_cov_diag", "kf_gain", "velocity"):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
        assert a.icp_iterations == b.icp_iterations and a.align_ok == b.align_ok
    for name in ("points", "key", "valid"):
        assert torch.equal(getattr(traced.state.vmap, name),
                           getattr(plain.state.vmap, name)), name


def test_stage_ahead_worker_spans_carry_the_staged_frame():
    cfg = dict(CFG, preprocess=dict(CFG["preprocess"], host_downsample=True),
               stage_ahead=True)
    pipe, trace = _run(cfg, True)
    assert len(pipe.outputs) == N_FRAMES
    main = trace.named("svnicp.frame")[0].thread
    stages = trace.named("svnicp.stage")
    # frame 0 (the bootstrap) stages on the calling thread, the rest on the worker
    assert [s.frame for s in stages] == list(range(N_FRAMES))
    assert all(s.thread != main and s.parent is None for s in stages[1:])
    # frame k's feed dispatches frame k-1; flush() dispatches the last
    for s in trace.named("svnicp.dispatch")[1:]:
        root = s
        while root.parent is not None:
            root = trace.spans[root.parent]
        assert s.frame == (root.frame - 1 if root.name == "svnicp.frame"
                           else N_FRAMES - 1)
        inside = [c for c in trace.spans if c.parent == trace.spans.index(s)]
        assert inside and all(c.frame == s.frame for c in inside)
    assert [o.icp_iterations for o in pipe.outputs][1:] == [
        len([s for s in trace.named("svnicp.align.iter") if s.frame == k])
        for k in range(1, N_FRAMES)]


def test_stage_ahead_trace_equals_untraced(runs):
    cfg = dict(CFG, preprocess=dict(CFG["preprocess"], host_downsample=True),
               stage_ahead=True)
    traced, _ = _run(cfg, True)
    plain, _ = _run(cfg, False)
    for a, b in zip(traced.outputs, plain.outputs):
        assert torch.equal(a.pose_t, b.pose_t) and torch.equal(a.var_icp, b.var_icp)

