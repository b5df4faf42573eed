"""Keyframe pose graph with Gauss-Newton on the device (port of
`svnicp_tpu/runtime/posegraph.py`).

Keyframes are taken by translation and rotation distance; each consecutive
pair gets an odometry edge whose information is the inverse of the ICP
covariance (its diagonal floored); loop candidates come from a radius
search over keyframe positions with a minimum index separation, and the
caller verifies them by registration and adds the relative pose as a loop
edge. `optimize` runs Gauss-Newton over all SE(3) nodes (the first fixed)
with residual e_ij = log(Z_ij^-1 T_i^-1 T_j), Huber weights on the
whitened edge norm, and the dense 6N x 6N normal equations solved on the
device, in float32 whatever the pipeline's dtype, as the JAX package does.
The host side (nodes, edges, keyframing, pruning) is numpy in float64.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from svnicp_tpu_torch.core import geometry as geo


@dataclasses.dataclass
class PoseGraph:
    """Host-side container; `optimize` runs on `device`."""

    keyframe_trans_threshold: float = 2.0
    keyframe_rot_threshold: float = 0.3   # [rad]
    loop_radius: float = 4.0
    loop_min_separation: int = 20
    # the edge covariance's diagonal is floored before inversion (the raw
    # ICP particle covariance is overconfident), and edges are robustified
    # by a Huber kernel on the whitened residual norm inside the GN loop
    cov_floor: float = 4e-4
    huber_delta: float = 3.0
    device: torch.device | str = "cpu"
    # the host-side residuals (the keyframe rotation distance, the pruning
    # chi) are computed in this dtype: the JAX package builds them from
    # float64 numpy as jax arrays, float32 unless x64 is on, which its
    # float64 pipeline runs with; so the pipeline's working dtype
    host_dtype: torch.dtype = torch.float32

    def __post_init__(self):
        self.nodes_r: list[np.ndarray] = []
        self.nodes_t: list[np.ndarray] = []
        self.stamps: list[float] = []
        # each edge: (i, j, rel_r, rel_t, information [6,6])
        self.edges: list[tuple[int, int, np.ndarray, np.ndarray, np.ndarray]] = []

    # ------------------------------------------------------------------ build

    def maybe_add_keyframe(self, stamp: float, pose_r, pose_t, cov=None) -> bool:
        """Add a keyframe when far enough from the last one, chaining an
        odometry edge weighted by the ICP covariance."""
        pose_r = np.asarray(pose_r, np.float64)
        pose_t = np.asarray(pose_t, np.float64)
        if self.nodes_r:
            last_r, last_t = self.nodes_r[-1], self.nodes_t[-1]
            dt = np.linalg.norm(pose_t - last_t)
            dr = np.linalg.norm(geo.so3_log(torch.tensor(
                last_r.T @ pose_r, dtype=self.host_dtype)).numpy())
            if dt < self.keyframe_trans_threshold and dr < self.keyframe_rot_threshold:
                return False
            rel_r = last_r.T @ pose_r
            rel_t = last_r.T @ (pose_t - last_t)
            self.edges.append((len(self.nodes_r) - 1, len(self.nodes_r), rel_r, rel_t,
                               self._information(cov)))
        self.nodes_r.append(pose_r)
        self.nodes_t.append(pose_t)
        self.stamps.append(stamp)
        return True

    def _information(self, cov) -> np.ndarray:
        if cov is None:
            return np.eye(6)
        c = np.asarray(cov, np.float64) + self.cov_floor * np.eye(6)
        return np.linalg.inv(c)

    def loop_candidates(self) -> list[tuple[int, int]]:
        """Index pairs (j, i) of the newest keyframe i and the keyframes j
        more than loop_min_separation before it within loop_radius."""
        n = len(self.nodes_t)
        if n < self.loop_min_separation + 2:
            return []
        pos = np.stack(self.nodes_t)
        i = n - 1
        d = np.linalg.norm(pos[: i - self.loop_min_separation] - pos[i], axis=1)
        return [(int(j), i) for j in np.nonzero(d < self.loop_radius)[0]]

    def add_loop_edge(self, i: int, j: int, rel_r, rel_t, cov=None) -> None:
        self.edges.append((i, j, np.asarray(rel_r, np.float64),
                           np.asarray(rel_t, np.float64), self._information(cov)))

    def prune_loop_edges(self, chi_threshold: float) -> int:
        """Drop the loop edges (non-consecutive pairs) whose whitened
        residual norm at the current nodes exceeds chi_threshold -> the
        number removed. The recovery path after a rejected re-anchor: the
        edges that drove it leave the graph, or every later optimize
        re-derives the same correction. The residual is computed in
        float32, as the JAX package computes it (its arrays are float32
        without x64), so an edge at the threshold goes the same way."""
        keep = []
        removed = 0
        for e in self.edges:
            i, j, zr, zt, info = e
            if j - i == 1:      # odometry edges are never pruned
                keep.append(e)
                continue
            args = [torch.tensor(np.asarray(a), dtype=self.host_dtype) for a in (
                self.nodes_r[i], self.nodes_t[i], self.nodes_r[j], self.nodes_t[j],
                zr, zt)]
            res = _edge_residual(*args).numpy()
            chi = float(np.sqrt(max(res @ np.asarray(info, np.float64) @ res, 0.0)))
            if chi > chi_threshold:
                removed += 1
            else:
                keep.append(e)
        self.edges = keep
        return removed

    # --------------------------------------------------------------- optimize

    def optimize(self, iterations: int = 10) -> None:
        """Gauss-Newton over all nodes (the first fixed), in place."""
        n = len(self.nodes_r)
        if n < 2 or not self.edges:
            return

        def dev(a, dtype=torch.float32):
            return torch.tensor(np.asarray(a), dtype=dtype, device=self.device)

        ei = dev([e[0] for e in self.edges], torch.int64)
        ej = dev([e[1] for e in self.edges], torch.int64)
        zr = dev(np.stack([e[2] for e in self.edges]))
        zt = dev(np.stack([e[3] for e in self.edges]))
        info = dev(np.stack([e[4] for e in self.edges]))
        r, t = dev(np.stack(self.nodes_r)), dev(np.stack(self.nodes_t))
        for _ in range(iterations):
            r, t = gauss_newton_step(r, t, ei, ej, zr, zt, info, float(self.huber_delta))
        r, t = r.cpu().numpy(), t.cpu().numpy()
        self.nodes_r = [np.asarray(x, np.float64) for x in r]
        self.nodes_t = [np.asarray(x, np.float64) for x in t]

    def trajectory(self) -> np.ndarray:
        """[K,4,4] keyframe poses."""
        mats = np.tile(np.eye(4), (len(self.nodes_r), 1, 1))
        for m, r, t in zip(mats, self.nodes_r, self.nodes_t):
            m[:3, :3] = r
            m[:3, 3] = t
        return mats


def _edge_residual(ri, ti, rj, tj, zr, zt):
    """e = log(Z^-1 (T_i^-1 T_j)) in [rho, omega] order; broadcasts over a
    leading edge axis."""
    rit = ri.transpose(-1, -2)
    rij = rit @ rj
    tij = (rit @ (tj - ti)[..., None])[..., 0]
    zrt = zr.transpose(-1, -2)
    return geo.se3_log(zrt @ rij, (zrt @ (tij - zt)[..., None])[..., 0])


def _retract(r, t, xi):
    """T_k <- T_k exp(xi_k) for every node: (r_k dR, t_k + r_k J_l rho);
    broadcasts over leading axes."""
    dr = geo.so3_exp(xi[..., 3:])
    jl = geo.so3_left_jacobian(xi[..., 3:])
    return r @ dr, t + (r @ (jl @ xi[..., :3, None]))[..., 0]


def _edge_jacobians(ri, ti, rj, tj, zr, zt):
    """Every edge's residual Jacobian [E,6,12] in the local updates of its
    two nodes (xi_i, xi_j), by forward mode at zero: 12 dual copies of one
    update pair, copy k with tangent e_k, applied to every edge's own two
    nodes (an edge's residual depends on no other node), so copy k's
    output tangent is column k of every edge's block. (`torch.func.jacfwd`
    gives the same values; its first call costs seconds.)"""
    import torch.autograd.forward_ad as fwad

    eye = torch.eye(12, dtype=ri.dtype, device=ri.device)
    with fwad.dual_level():
        xi = fwad.make_dual(torch.zeros_like(eye), eye).reshape(12, 2, 1, 6)
        ri2, ti2 = _retract(ri, ti, xi[:, 0])
        rj2, tj2 = _retract(rj, tj, xi[:, 1])
        res = _edge_residual(ri2, ti2, rj2, tj2, zr, zt)              # [12,E,6]
        return fwad.unpack_dual(res).tangent.permute(1, 2, 0)


def gauss_newton_step(r, t, ei, ej, zr, zt, info, huber_delta: float):
    """One Gauss-Newton step of the graph: the residuals' Jacobian in the
    per-node local updates by forward mode at xi = 0 (per edge over its two
    nodes, which is the whole Jacobian: an edge's residual depends on no
    other node), Huber weights on the whitened edge norms (IRLS,
    re-evaluated every step), the normal equations with node 0 clamped and
    a 1e-5 Levenberg diagonal, a dense solve, and the retraction."""
    n, n_edges = r.shape[0], ei.shape[0]
    res_e = _edge_residual(r[ei], t[ei], r[ej], t[ej], zr, zt)          # [E,6]
    jac_ij = _edge_jacobians(r[ei], t[ei], r[ej], t[ej], zr, zt)       # [E,6,12]
    rows = torch.arange(n_edges, device=r.device)
    jac = r.new_zeros((n_edges, n, 6, 6))                                # [E,N,6,6]
    jac[rows, ei] = jac_ij[..., :6]
    jac[rows, ej] = jac_ij[..., 6:]
    jac_e = jac.permute(0, 2, 1, 3).reshape(n_edges, 6, n * 6)          # [E,6,N*6]
    w_info = info
    if huber_delta > 0:
        chi = torch.sqrt(torch.clamp_min(
            torch.einsum("ei,eij,ej->e", res_e, info, res_e), 1e-12))
        w = torch.clamp_max(huber_delta / chi, 1.0)
        w_info = info * w[:, None, None]
    wj = torch.einsum("eij,ejm->eim", w_info, jac_e)
    h = torch.einsum("ein,eim->nm", jac_e, wj)
    g = torch.einsum("eim,ei->m", wj, res_e)
    mask = torch.ones(n * 6, dtype=r.dtype, device=r.device)
    mask[:6] = 0.0
    h = h * mask[:, None] * mask[None, :] + torch.diag(1e-5 + (1.0 - mask) * 1e5)
    dx = -torch.linalg.solve(h, g * mask).reshape(n, 6)
    return _retract(r, t, dx)
