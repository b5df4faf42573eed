"""The SVN align loop's driver (`svn.align_loop`) against the loop it
replaces, written out here: one pass at a time with a host read of the
stop statistic after each.

- `svn.align`, in rounds of m device-frozen passes (one read of the stop
  flags a round): the AlignResult must be the same bit for bit
  (particles, mean, var, cov, grad_norm, iterations) in float32 and
  float64 with m of 1, 3 and 8 (the CPU runs m = 1; the card runs
  `svn.ALIGN_CHUNK`), for a frame that stops inside a round, one that
  stops on a round's last pass, one that runs to the cap, one with
  early_stop off and a degenerate set.
- `svn.align_with_history`, one round of every pass: each row of the
  history is the particles after its pass, the rows after the stop
  repeat the final particles, and the AlignResult is `align`'s.
- The mesh's loop (`sharding.sharded_align` on a (2, 2) mesh of CPU
  shards), one pass a round: bit-equal to the per-pass loop over
  `sharding._sharded_iteration`, with and without history.

The thresholds are set from the frame's own sequence of stop statistics,
so each case stops where it is meant to; one case puts the threshold a
quarter ulp above a float32 statistic, where only a float64 comparison
stops.

Three noise-free planes (the crisp problem of tests/test_torch_svn.py),
P=8 against the candidates of 256 source points, K=16, on the CPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from svnicp_tpu_torch.config import SteinICPConfig
from svnicp_tpu_torch.core import geometry as geo
from svnicp_tpu_torch.core import svn
from svnicp_tpu_torch.parallel import sharding
from svnicp_tpu_torch.parallel.mesh import PARTICLE_AXIS, POINT_AXIS

torch.set_num_threads(2)

P, B, K, CAP = 8, 256, 16, 20
ICP = SteinICPConfig(method="svn", residual="point_to_point", particle_count=P,
                     iterations=CAP, max_dist=3.0, knn_count=K, use_pallas=True,
                     convergence_threshold=0.0, source_capacity=B,
                     target_capacity=2048)
ROUTES = {
    "plane": dict(residual="point_to_plane"),
    "plain_update": dict(stein_kernel=False),
    "xla": dict(use_pallas=False),
}


def _frame(dtype, residual="point_to_point", use_pallas=True):
    """(source, src_valid, cand_pts, cand_valid, r0, t0, init) of one frame."""
    rng = np.random.default_rng(2)

    def sample(n):
        u = rng.uniform(-6, 6, size=(n, 3))
        which = rng.integers(0, 3, n)
        u[which == 0, 2] = 0.0
        u[which == 1, 1] = 4.0
        u[which == 2, 0] = -3.0
        return torch.tensor(u, dtype=dtype)

    src, tgt = sample(B), sample(2048)
    r, t = geo.se3_exp(torch.tensor([0.1, -0.05, 0.02, 0.01, 0.0, 0.02], dtype=dtype))
    tgt = tgt @ r.T + t
    lb, ub = np.array(ICP.init_lb), np.array(ICP.init_ub)
    init = torch.tensor(lb + (ub - lb) * rng.random((P, 6)), dtype=dtype)
    src_valid = torch.ones(B, dtype=torch.bool)
    r0, t0 = torch.eye(3, dtype=dtype), torch.zeros(3, dtype=dtype)
    cfg = dataclasses.replace(ICP, residual=residual, use_pallas=use_pallas)
    cand_pts, cand_valid = svn._candidates(cfg, src, src_valid, tgt,
                                           torch.ones(2048, dtype=torch.bool), r0, t0)
    return [src, src_valid, cand_pts, cand_valid, r0, t0, init]


def per_pass(cfg, args, rows=None):
    """The loop with a host read after every pass -> (AlignResult, the stop
    statistics read, as floats); the particles after each pass are
    appended to `rows` when it is given."""
    source, src_valid, cand_pts, cand_valid, r0, t0, init = args
    r, t, degenerate, prep, prior = svn._start(cfg, source, src_valid, cand_pts,
                                               cand_valid, r0, t0, init)
    if degenerate:
        return svn.ensemble_result(r, t, 0, float("inf")), []
    it, done, stops = 0, False, []
    grad_norm = torch.tensor(float("inf"), dtype=source.dtype)
    while not done and it < cfg.iterations:
        r, t, grad_norm, stop = svn._svn_iteration(cfg, prep, source, src_valid,
                                                   prior, r0, t0, r, t)
        it += 1
        stops.append(float(stop))
        if rows is not None:
            rows.append(svn.particle_coords(r, t))
        if cfg.early_stop:
            done = float(stop) < cfg.convergence_threshold
    return svn.ensemble_result(r, t, it, grad_norm), stops


def chunked(cfg, args, m, monkeypatch):
    monkeypatch.setattr(svn, "_chunk", lambda device: m)
    return svn.align(cfg, *args)


def history_of(want, rows):
    """The history the per-pass loop's rows make: the particles after each
    pass, then its final particles repeated to the cap."""
    return torch.stack(rows + [want.particles] * (CAP - len(rows)))


def assert_same(got, want):
    assert got.iterations == want.iterations
    assert isinstance(got.iterations, int)
    for name in ("particles", "weights", "mean", "var", "cov", "grad_norm"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), (name, a, b)


def records(stops):
    """1-based passes whose statistic is below every earlier one, with the
    least earlier statistic."""
    out, low = [], float("inf")
    for n, s in enumerate(stops, 1):
        if s < low:
            out.append((n, low))
            low = s
    return out


def threshold_stopping_at(stops, m, on_last_pass):
    """A threshold at which the per-pass loop stops at a pass inside a round
    of m (or on a round's last pass), at pass 2 or later, before the cap."""
    for n, low in records(stops):
        if 2 <= n < CAP and (n % m == 0) == on_last_pass:
            return n, 0.5 * (stops[n - 1] + low)
    raise AssertionError(f"no pass to stop at for m={m}: {stops}")


@pytest.fixture(scope="module", params=[torch.float32, torch.float64],
                ids=["f32", "f64"])
def frame(request):
    args = _frame(request.param)
    _, stops = per_pass(dataclasses.replace(ICP, early_stop=False), args)
    assert len(stops) == CAP
    return args, stops


def set_up(case, args, stops, m):
    """The configuration and frame of a case, and the passes it runs."""
    if case in ("inside_a_round", "on_a_rounds_last_pass"):
        on_last = case == "on_a_rounds_last_pass" or m == 1
        want_iters, thr = threshold_stopping_at(stops, m, on_last)
        return dataclasses.replace(ICP, convergence_threshold=thr), args, want_iters
    if case == "to_the_cap":
        return ICP, args, CAP
    if case == "early_stop_off":
        return (dataclasses.replace(ICP, early_stop=False, convergence_threshold=1.0),
                args, CAP)
    args = list(args)
    args[1] = torch.zeros_like(args[1])
    args[1][:3] = True
    return ICP, args, 0


@pytest.mark.parametrize("m", [1, 3, 8])
@pytest.mark.parametrize("case", ["inside_a_round", "on_a_rounds_last_pass",
                                  "to_the_cap", "early_stop_off", "degenerate"])
def test_rounds_equal_the_per_pass_loop(frame, case, m, monkeypatch):
    args, stops = frame
    cfg, args, want_iters = set_up(case, args, stops, m)
    want, _ = per_pass(cfg, args)
    got = chunked(cfg, args, m, monkeypatch)
    assert want.iterations == want_iters
    assert_same(got, want)
    if case == "degenerate":
        assert torch.isinf(got.grad_norm)


@pytest.mark.parametrize("m", [1, 3, 8])
def test_float32_statistic_just_under_the_threshold_stops(m, monkeypatch):
    """The threshold a quarter ulp above a float32 statistic: it rounds to
    that statistic in float32, where `stop < threshold` is false; in
    float64, as the host compares float(stop), it is true and the loop stops
    there."""
    args = _frame(torch.float32)
    cfg, n = quarter_ulp_above(args)
    want, _ = per_pass(cfg, args)
    assert want.iterations == n
    assert_same(chunked(cfg, args, m, monkeypatch), want)


def quarter_ulp_above(args):
    """The configuration whose threshold lies a quarter ulp above the
    float32 statistic of a pass n inside the cap, and n."""
    _, stops = per_pass(dataclasses.replace(ICP, early_stop=False), args)
    n, low = next((n, low) for n, low in records(stops) if 2 <= n < CAP)
    s = np.float32(stops[n - 1])
    thr = float(s) + float(np.spacing(s)) / 4
    assert thr < low and np.float32(thr) == s
    assert not bool(torch.tensor(s) < thr)      # what a float32 comparison says
    return dataclasses.replace(ICP, convergence_threshold=thr), n


@pytest.mark.parametrize("route", ["plane", "plain_update", "xla"])
def test_rounds_on_the_other_routes(route, monkeypatch):
    """The plane residual, the plain update and the XLA route run the same
    rounds uncaptured: a stop inside a round of 3, in float64."""
    opts = ROUTES[route]
    args = _frame(torch.float64, opts.get("residual", "point_to_point"),
                  opts.get("use_pallas", True))
    base = dataclasses.replace(ICP, **opts)
    _, stops = per_pass(dataclasses.replace(base, early_stop=False), args)
    n, thr = threshold_stopping_at(stops, 3, on_last_pass=False)
    cfg = dataclasses.replace(base, convergence_threshold=thr)
    want, _ = per_pass(cfg, args)
    assert want.iterations == n
    assert_same(chunked(cfg, args, 3, monkeypatch), want)


def test_cpu_runs_one_pass_a_round():
    """The CPU reads after every pass (m = 1): no frozen pass is computed."""
    assert svn._chunk(torch.device("cpu")) == 1
    assert svn._chunk(torch.device("cuda", 0)) == svn.ALIGN_CHUNK > 1


def test_rounds_are_counted_and_read_as_the_replayed_share(monkeypatch):
    """On the CPU every round is issued op by op: `svnicp.align.eager_rounds`
    counts them, no graph is captured or replayed, and
    `align_graph_replay_pct` reads 0; rounds replayed from a graph read as
    their share; a program that counts no round (before the graph) reads
    nothing."""
    import types

    from lio_bench.harness import cell
    from svnicp_tpu_torch.runtime import profiling

    args = _frame(torch.float64)
    with profiling.tracing() as tr:
        res = chunked(ICP, args, 1, monkeypatch)
    assert tr.counters["svnicp.align.eager_rounds"] == res.iterations == CAP
    assert len(tr.named("svnicp.align.iter")) == CAP
    assert not {"svnicp.align.graph_captures", "svnicp.align.graph_replays"} & set(tr.counters)
    metric = cell.metric_module("align_graph_replay_pct")

    def read(counters):
        trace = profiling.Trace(counters=counters)
        return metric.read(types.SimpleNamespace(
            probes={"align_graph_replay_pct": {"trace": trace}}))

    assert read(tr.counters) == 0.0
    assert read({"svnicp.align.graph_replays": 39}) == 100.0
    assert read({"svnicp.align.graph_replays": 3, "svnicp.align.eager_rounds": 1}) == 75.0
    assert read({"svnicp.candidates.scores": 5}) is None
    assert metric.read(types.SimpleNamespace(probes={})) is None


@pytest.mark.parametrize("case", ["inside_a_round", "to_the_cap", "early_stop_off",
                                  "degenerate"])
def test_history_equals_the_per_pass_loop(frame, case):
    """`align_with_history` runs one round of every pass: row n is the
    particles after pass n, the rows after the stop repeat the final
    particles, and its AlignResult is the per-pass loop's and `align`'s."""
    args, stops = frame
    cfg, args, want_iters = set_up(case, args, stops, 1)
    rows = []
    want, _ = per_pass(cfg, args, rows)
    got, history = svn.align_with_history(cfg, *args)
    assert want.iterations == want_iters
    assert_same(got, want)
    assert_same(svn.align(cfg, *args), want)
    assert history.dtype == want.particles.dtype
    assert torch.equal(history, history_of(want, rows))


def test_history_stops_on_a_float32_statistic_just_under_the_threshold():
    """The history loop compares in float64 as `align` does: with the
    threshold a quarter ulp above a float32 statistic it stops there."""
    args = _frame(torch.float32)
    cfg, n = quarter_ulp_above(args)
    rows = []
    want, _ = per_pass(cfg, args, rows)
    got, history = svn.align_with_history(cfg, *args)
    assert want.iterations == got.iterations == n
    assert_same(got, want)
    assert torch.equal(history, history_of(want, rows))


MESH = sharding.make_mesh(2, 2, devices=["cpu"] * 4)
MESH_SPECS = (POINT_AXIS,) * 4 + (None, None, PARTICLE_AXIS)


def mesh_per_pass(cfg, args):
    """`sharding.sharded_align`'s body with its loop written out: a host read
    of the stop statistic after every `sharding._sharded_iteration` ->
    (AlignResult, the statistics read, the gathered particles after each
    pass)."""
    stops, rows = [], []

    def body(coll, source, src_valid, cand_pts, cand_valid, r0, t0, init):
        first = coll.axis_index(PARTICLE_AXIS) == coll.axis_index(POINT_AXIS) == 0
        prep = sharding.shard_prep(cfg, source, src_valid, cand_pts, cand_valid)
        r, t = geo.so3_exp(init[:, 3:]), init[:, :3].contiguous()
        it, done = 0, False
        grad_norm = torch.tensor(float("inf"), dtype=source.dtype)
        while not done and it < cfg.iterations:
            r, t, grad_norm, stop = sharding._sharded_iteration(
                coll, cfg, source, src_valid, prep, r0, t0, r, t)
            it += 1
            coords = coll.all_gather(svn.particle_coords(r, t), PARTICLE_AXIS, tiled=True)
            if first:
                stops.append(float(stop))
                rows.append(coords)
            if cfg.early_stop:
                done = float(stop) < cfg.convergence_threshold
        return sharding.ensemble_outputs(coll, r, t, it, grad_norm, None)

    outs = MESH.run(body, args, MESH_SPECS, sharding.RESULT_SPECS)
    return sharding.to_result(outs, False), stops, rows


@pytest.fixture(scope="module", params=[torch.float32, torch.float64],
                ids=["f32", "f64"])
def mesh_frame(request):
    args = _frame(request.param)
    _, stops, _ = mesh_per_pass(dataclasses.replace(ICP, early_stop=False), args)
    assert len(stops) == CAP
    return args, stops


@pytest.mark.parametrize("case", ["inside_a_round", "to_the_cap", "early_stop_off",
                                  "history"])
def test_mesh_loop_equals_the_per_pass_loop(mesh_frame, case):
    """The mesh runs svn's driver with one pass a round (with history, one
    round of every pass): the same AlignResult bit for bit as a host read
    after every sharded pass, one eager round a pass on each shard, and
    with history the gathered particles after each pass."""
    from svnicp_tpu_torch.runtime import profiling

    args, stops = mesh_frame
    history = case == "history"
    cfg, args, want_iters = set_up("inside_a_round" if history else case, args,
                                   stops, 1)
    want, _, rows = mesh_per_pass(cfg, args)
    with profiling.tracing() as tr:
        got = sharding.sharded_align(MESH, cfg, *args, history=history)
    assert want.iterations == want_iters
    if history:
        got, hist = got
        assert torch.equal(hist, history_of(want, rows))
    assert_same(got, want)
    rounds = 1 if history else want.iterations
    assert tr.counters["svnicp.align.eager_rounds"] == MESH.size * rounds
