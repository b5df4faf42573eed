"""The port's pose graph (`svnicp_tpu_torch/runtime/posegraph.py`) against
the JAX package's `svnicp_tpu/runtime/posegraph.py`, both fed the same
float64 numpy poses and covariances (a drifted 24-keyframe circle):

- keyframing (nodes, edges, information matrices) and `loop_candidates`
  are identical;
- `optimize` (float32 Gauss-Newton on both sides) agrees within 2e-4 m
  and 2e-4 rad per node after 8 steps, with the Huber kernel on and off
  (measured ~1e-5: float32 rounding of two implementations of the same
  solve, amplified by the 6N x 6N system's conditioning);
- `prune_loop_edges` removes the same edges;
- an edge whose measurement equals the current relative pose has an exact
  zero residual, and its forward-mode Jacobian is finite.
"""

import numpy as np
import pytest
import torch

from svnicp_tpu.runtime import posegraph as jpg
from svnicp_tpu_torch.runtime import posegraph as tpg

torch.set_num_threads(2)

KW = dict(keyframe_trans_threshold=0.5, keyframe_rot_threshold=0.3,
          loop_radius=2.0, loop_min_separation=8, cov_floor=4e-4, huber_delta=3.0)


def _rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _drifted_circle(n=96, seed=0):
    """Poses on a 4 m circle with compounding heading drift, and per-frame
    SPD covariances -> [(stamp, r, t, cov)]."""
    rng = np.random.default_rng(seed)
    out = []
    yaw_err = 0.0
    for i in range(n):
        th = 2 * np.pi * i / (n - 8)
        yaw_err += 0.002 + 0.001 * rng.normal()
        r = _rot_z(th + yaw_err)
        t = np.array([4 * np.sin(th), 4 - 4 * np.cos(th), 0.0]) * (1 + 0.03 * yaw_err)
        t += 0.01 * rng.normal(size=3)
        a = rng.normal(size=(6, 6)) * 1e-3
        out.append((0.1 * i, r, t, a @ a.T + 1e-5 * np.eye(6)))
    return out


def _build(mod, frames):
    g = mod.PoseGraph(**KW)
    added = [g.maybe_add_keyframe(*f) for f in frames]
    return g, added


@pytest.fixture(scope="module")
def graphs():
    frames = _drifted_circle()
    (jg, ja), (tg, ta) = _build(jpg, frames), _build(tpg, frames)
    return jg, ja, tg, ta


def test_keyframes_and_candidates_equal(graphs):
    jg, ja, tg, ta = graphs
    assert ja == ta and sum(ta) > 20
    np.testing.assert_array_equal(np.stack(jg.nodes_r), np.stack(tg.nodes_r))
    np.testing.assert_array_equal(np.stack(jg.nodes_t), np.stack(tg.nodes_t))
    assert jg.stamps == tg.stamps and len(jg.edges) == len(tg.edges)
    for a, b in zip(jg.edges, tg.edges):
        assert a[:2] == b[:2]
        for x, y in zip(a[2:], b[2:]):
            np.testing.assert_array_equal(x, y)
    assert jg.loop_candidates() == tg.loop_candidates() != []
    for cov in (None, np.diag(np.arange(1.0, 7.0)) * 1e-4):
        np.testing.assert_array_equal(jg._information(cov), tg._information(cov))


def _with_loops(g, bad: bool):
    """Loop edges from the last keyframes to the first ones at their true
    relative pose (the drift-free circle), and with `bad` one edge 3 m off."""
    n = len(g.nodes_r)
    for i, j in [(0, n - 1), (1, n - 1), (0, n - 2)]:
        rel_r = g.nodes_r[i].T @ g.nodes_r[j] @ _rot_z(-0.05)
        rel_t = g.nodes_r[i].T @ (g.nodes_t[j] - g.nodes_t[i]) + np.array([0.3, -0.2, 0.0])
        g.add_loop_edge(i, j, rel_r, rel_t, np.eye(6) * 1e-3)
    if bad:
        g.add_loop_edge(2, n - 3, np.eye(3), np.array([3.0, 0.0, 0.0]), np.eye(6) * 1e-3)


@pytest.mark.parametrize("huber", [3.0, 0.0])
def test_optimize_agrees_float32(huber):
    frames = _drifted_circle()
    jg, _ = _build(jpg, frames)
    tg, _ = _build(tpg, frames)
    for g in (jg, tg):
        g.huber_delta = huber
        _with_loops(g, bad=True)
    before = np.stack(tg.nodes_t)
    jg.optimize(iterations=8)
    tg.optimize(iterations=8)
    jt, tt = np.stack(jg.nodes_t), np.stack(tg.nodes_t)
    jr, tr = np.stack(jg.nodes_r), np.stack(tg.nodes_r)
    assert np.abs(tt - before).max() > 0.1          # the loops moved the graph
    np.testing.assert_allclose(tt, jt, rtol=0, atol=2e-4)
    np.testing.assert_allclose(tr, jr, rtol=0, atol=2e-4)
    # node 0 is clamped: it comes back as its float32 rounding
    np.testing.assert_array_equal(tt[0], before[0].astype(np.float32))


def test_prune_removes_the_same_edges():
    frames = _drifted_circle()
    gs = []
    for mod in (jpg, tpg):
        g, _ = _build(mod, frames)
        _with_loops(g, bad=True)
        gs.append(g)
    for chi in (15.0, 60.0, 1e4):
        removed = [g.prune_loop_edges(chi) for g in gs]
        assert removed[0] == removed[1], chi
        assert [e[:2] for e in gs[0].edges] == [e[:2] for e in gs[1].edges]
    assert len(gs[1].edges) < len(frames)


def test_zero_residual_edge_has_finite_jacobian():
    frames = _drifted_circle()
    g, _ = _build(tpg, frames)
    n = len(g.nodes_r)
    i, j = 0, n - 1
    g.add_loop_edge(i, j, g.nodes_r[i].T @ g.nodes_r[j],
                    g.nodes_r[i].T @ (g.nodes_t[j] - g.nodes_t[i]))
    f64 = torch.float64
    r = torch.tensor(np.stack(g.nodes_r), dtype=f64)
    t = torch.tensor(np.stack(g.nodes_t), dtype=f64)
    e = g.edges[-1]
    res = tpg._edge_residual(r[i], t[i], r[j], t[j], torch.tensor(e[2], dtype=f64),
                             torch.tensor(e[3], dtype=f64))
    assert torch.all(res.abs() < 1e-12)

    def residual(xi):
        xi = xi.reshape(2, 6)
        (ri, rj), (ti, tj) = tpg._retract(r[[i, j]], t[[i, j]], xi)
        return tpg._edge_residual(ri, ti, rj, tj, torch.tensor(e[2], dtype=f64),
                                  torch.tensor(e[3], dtype=f64))

    jac = torch.func.jacfwd(residual)(torch.zeros(12, dtype=f64))
    assert torch.isfinite(jac).all() and jac.abs().max() > 0.5
    # the same at float32 through one whole Gauss-Newton step of the graph
    for dtype in (torch.float32, torch.float64):
        args = [torch.tensor(np.stack(x), dtype=dtype) for x in (
            g.nodes_r, g.nodes_t, [e[2] for e in g.edges], [e[3] for e in g.edges],
            [e[4] for e in g.edges])]
        ei = torch.tensor([e[0] for e in g.edges])
        ej = torch.tensor([e[1] for e in g.edges])
        r1, t1 = tpg.gauss_newton_step(args[0], args[1], ei, ej, *args[2:], 3.0)
        assert torch.isfinite(r1).all() and torch.isfinite(t1).all()
