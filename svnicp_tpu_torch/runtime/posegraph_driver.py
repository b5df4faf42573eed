"""The pose-graph side of the host driver: keyframing, loop verification
and the live re-anchor (port of `svnicp_tpu/runtime/posegraph_driver.py`;
`LIOPipeline` mixes it in).

The graph (`runtime/posegraph.py`) runs beside odometry: a keyframe's
stored cloud is registered against an earlier keyframe's by SVN-ICP to
verify a loop candidate; after a closure the graph is optimized, and with
`posegraph.reanchor` the last keyframe's correction rigidly moves the
persistent state (poses, the ESKF's nav state, the voxel map). The rails of
the JAX package are kept: a non-finite or oversized correction is
rejected, the graph then rolls back, and the loop edges that drove it are
pruned. With the map in key-range blocks over a mesh (map.sharded) the
map moves distributed (`voxmap_sharded.sharded_reanchor`).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from svnicp_tpu_torch.config import PipelineConfig


def _reanchor_state(cfg: PipelineConfig, state, delta_r: torch.Tensor,
                    delta_t: torch.Tensor, move_map: bool = True):
    """The odometry state moved rigidly by a world-frame correction: the
    pose history, the ESKF nav state (the velocity rotated; the covariance
    untouched, as every error state of this filter is body-frame) and,
    unless `move_map` is False (the sharded map moves by its own
    collectives), the voxel map, its keys recomputed
    (`pointcloud.voxel_key`) and the table stable-sorted by key, carrying
    x, y and z, as `lax.sort(num_keys=1, is_stable=True)` does, so the rows
    keep the order the map's run broadcasts rely on."""
    from svnicp_tpu_torch.core import imu as imu_mod
    from svnicp_tpu_torch.core import voxmap
    from svnicp_tpu_torch.core.pointcloud import INVALID_KEY, voxel_key

    dtype = state.pose_t.dtype
    dr = delta_r.to(dtype)
    dt = delta_t.to(dtype)

    def move(r, t):
        return dr @ r, dr @ t + dt

    pose_r, pose_t = move(state.pose_r, state.pose_t)
    prev_r, prev_t = move(state.prev_r, state.prev_t)
    nav = state.eskf.nav
    nav_r, nav_t = move(nav.r, nav.t)
    ekf = state.eskf._replace(nav=imu_mod.NavState(nav_r, nav_t, dr @ nav.v))
    state = state._replace(pose_r=pose_r, pose_t=pose_t, prev_r=prev_r,
                           prev_t=prev_t, eskf=ekf)
    if not move_map:
        return state
    vm = state.vmap
    pts = vm.points @ dr.T + dt[None, :]
    key = torch.where(vm.valid, voxel_key(pts, cfg.map.voxel_size),
                      torch.full_like(vm.key, INVALID_KEY))
    skey, order = torch.sort(key, stable=True)
    valid = skey != INVALID_KEY
    new_map = voxmap.VoxelMap(torch.where(valid[:, None], pts[order], 0.0), skey, valid)
    return state._replace(vmap=new_map)


class PoseGraphDriver:
    """Mixin for LIOPipeline: keyframe selection, loop-candidate search and
    verification, live re-anchoring. Expects the attributes LIOPipeline's
    constructor sets (posegraph, _keyframe_clouds, loop_closures,
    reanchors, reanchors_rejected, reanchor_drops, loop_edges_pruned, mesh,
    state, cfg)."""

    _KF_CLOUD_SIZE = 2048

    def _update_posegraph(self, t: float, out, raw_points) -> None:
        """Keyframe selection (reading the frame's pose and covariance on the
        host), then loop search and verification against the stored
        keyframe clouds (the scan as fed, strided to 2,048 rows); after an
        accepted closure, or every optimize_every keyframes once a closure
        exists, optimize and re-anchor."""
        added = self.posegraph.maybe_add_keyframe(
            t, out.pose_r.cpu().numpy(), out.pose_t.cpu().numpy(),
            out.cov.cpu().numpy())
        if not added:
            return
        pts = np.asarray(raw_points, np.float32)
        if len(pts) > self._KF_CLOUD_SIZE:
            step = len(pts) // self._KF_CLOUD_SIZE
            pts = pts[::step][: self._KF_CLOUD_SIZE]
        pad = np.zeros((self._KF_CLOUD_SIZE, 3), np.float32)
        pad[: len(pts)] = pts
        valid = np.zeros(self._KF_CLOUD_SIZE, bool)
        valid[: len(pts)] = True
        self._keyframe_clouds.append((pad, valid))

        kf_idx = len(self.posegraph.nodes_r) - 1
        accepted = False
        for old, cur in self.posegraph.loop_candidates()[:2]:
            z = self._verify_loop(old, cur)
            if z is not None:
                rel_r, rel_t, cov = z
                self.posegraph.add_loop_edge(old, cur, rel_r, rel_t, cov)
                self.loop_closures.append((old, cur))
                accepted = True
        if accepted or (
            kf_idx > 0 and kf_idx % self.cfg.posegraph.optimize_every == 0
            and self.loop_closures
        ):
            # snapshot every node: a rejected correction rolls the whole
            # graph back, or its nodes would sit in the optimized frame
            # while new keyframes arrive in the uncorrected live one
            snap_r = [r.copy() for r in self.posegraph.nodes_r]
            snap_t = [t.copy() for t in self.posegraph.nodes_t]
            self.posegraph.optimize(iterations=8)
            if self.cfg.posegraph.reanchor:
                rejected_before = self.reanchors_rejected
                self._reanchor_live(snap_r[-1], snap_t[-1])
                if self.reanchors_rejected != rejected_before:
                    self.posegraph.nodes_r = snap_r
                    self.posegraph.nodes_t = snap_t
                    self.loop_edges_pruned += self.posegraph.prune_loop_edges(
                        5.0 * self.cfg.posegraph.huber_delta)

    def _reanchor_live(self, before_r: np.ndarray, before_t: np.ndarray) -> None:
        """Apply the last keyframe's optimization delta T_opt T_before^-1 to
        the live state, so closures correct future odometry too."""
        after_r = self.posegraph.nodes_r[-1]
        after_t = self.posegraph.nodes_t[-1]
        delta_r = after_r @ before_r.T
        delta_t = after_t - delta_r @ before_t
        if (np.linalg.norm(delta_t) < 1e-6
                and np.linalg.norm(delta_r - np.eye(3)) < 1e-6):
            return
        self.apply_reanchor(delta_r, delta_t)

    def apply_reanchor(self, delta_r, delta_t) -> None:
        """Rigidly move the live state by a world-frame correction. A
        correction that is non-finite, translates by more than
        `posegraph.max_reanchor_correction` or rotates by more than 1 rad
        is rejected and counted, not applied: a lost run's spurious loops
        must not destroy the state that could still recover. The sharded
        map moves distributed (per-block re-key and the rebalance ring
        pass; the boundaries stay); rows shed on a block's overflow are
        counted in `reanchor_drops`, which the replicated move never has."""
        bound = self.cfg.posegraph.max_reanchor_correction
        dr_np, dt_np = np.asarray(delta_r), np.asarray(delta_t)
        cos_a = np.clip((np.trace(dr_np) - 1.0) / 2.0, -1.0, 1.0)
        if not (np.isfinite(dr_np).all() and np.isfinite(dt_np).all()
                and np.linalg.norm(dt_np) <= bound
                and np.arccos(cos_a) <= 1.0):
            self.reanchors_rejected += 1
            return
        dtype = self.state.pose_t.dtype
        dr = torch.tensor(dr_np, dtype=dtype, device=self.device)
        dt = torch.tensor(dt_np, dtype=dtype, device=self.device)
        sharded_map = self.mesh is not None and self.cfg.map.sharded
        self.state = _reanchor_state(self.cfg, self.state, dr, dt,
                                     move_map=not sharded_map)
        if sharded_map:
            import sys

            from svnicp_tpu_torch.parallel import voxmap_sharded as vms

            new_map, dropped = vms.sharded_reanchor(
                self.mesh, self.state.vmap, self.state.split_keys, dr, dt,
                self.cfg.map.voxel_size)
            self.state = self.state._replace(vmap=new_map)
            if int(dropped):
                print(f"[svnicp] WARNING: sharded reanchor dropped {int(dropped)} "
                      f"map rows on shard-capacity overflow (parity loss vs the "
                      f"replicated move)", file=sys.stderr)
            self.reanchor_drops += int(dropped)
        self.reanchors += 1

    def _verify_loop(self, old: int, cur: int):
        """Register keyframe `cur`'s cloud onto keyframe `old`'s at the
        graph's relative guess, with the loop settings of `posegraph`
        (`loop_use_pallas` picks the kernel route) -> (rel_r, rel_t, cov),
        or None when the result is non-finite or its grad norm is above
        loop_max_grad. The particles are numpy draws seeded by `cur`, as in
        the JAX package."""
        from svnicp_tpu_torch.core import geometry as geo
        from svnicp_tpu_torch.core import svn

        src_pts, src_valid = self._keyframe_clouds[cur]
        tgt_pts, tgt_valid = self._keyframe_clouds[old]
        r_old = np.asarray(self.posegraph.nodes_r[old])
        t_old = np.asarray(self.posegraph.nodes_t[old])
        r_cur = np.asarray(self.posegraph.nodes_r[cur])
        t_cur = np.asarray(self.posegraph.nodes_t[cur])
        guess_r = r_old.T @ r_cur
        guess_t = r_old.T @ (t_cur - t_old)

        pg = self.cfg.posegraph
        loop_cfg = dataclasses.replace(
            self.cfg.icp, particle_count=pg.loop_particles,
            iterations=pg.loop_iterations, knn_count=pg.loop_knn,
            early_stop=True, use_pallas=pg.loop_use_pallas,
            source_capacity=self._KF_CLOUD_SIZE,
            target_capacity=self._KF_CLOUD_SIZE)
        p = pg.loop_particles
        dtype = self.state.pose_t.dtype

        def dev(a, dt=dtype):
            return torch.tensor(np.asarray(a), dtype=dt, device=self.device)

        res = svn.register(
            loop_cfg, dev(src_pts), dev(src_valid, torch.bool), dev(tgt_pts),
            dev(tgt_valid, torch.bool), dev(guess_r), dev(guess_t),
            dev(np.random.default_rng(cur).uniform(-0.05, 0.05, (p, 6))))
        if not bool(torch.isfinite(res.mean).all()) or (
            float(res.grad_norm) > pg.loop_max_grad
        ):
            return None
        rc = geo.so3_exp(res.mean[3:]).cpu().numpy()
        tc = res.mean[:3].cpu().numpy()
        return guess_r @ rc, guess_r @ tc + guess_t, res.cov.cpu().numpy()

    def optimized_trajectory(self) -> np.ndarray:
        """[K,4,4] optimized keyframe trajectory (empty without the graph)."""
        if self.posegraph is None:
            return np.zeros((0, 4, 4))
        return self.posegraph.trajectory()
