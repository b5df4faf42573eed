"""Carry odometry state between the JAX package and this port.

This system has no weights: what a run carries from frame to frame is the
OdometryState (voxel map, poses and stamps, the variance rings, the filter
state, the frame index) plus the per-frame particle draws. The draws cannot
be reproduced from JAX's PRNG, so parity runs pass them through
`init_particles`; the state goes through numpy with these functions.

Fields are keyed by their path in the JAX `OdometryState` pytree, joined
with dots ("vmap.points", "eskf.nav.r", "rings.count", "split_keys",
...). The JAX PRNG key ("rng") has no counterpart here and is ignored;
the port's generator is seeded from `seed`. A state without "split_keys"
(the map not sharded) gets an empty [0] set.
"""

from __future__ import annotations

import numpy as np
import torch

from svnicp_tpu_torch.core import eskf as eskf_mod
from svnicp_tpu_torch.core import imu as imu_mod
from svnicp_tpu_torch.core import smoother, voxmap
from svnicp_tpu_torch.runtime.pipeline import OdometryState

_IGNORED = ("rng",)


def state_from_numpy(fields: dict[str, np.ndarray], device, seed: int = 0
                     ) -> OdometryState:
    """Build the port's OdometryState from the JAX state's leaves."""
    missing = [k for k in _TENSOR_FIELDS + _INT_FIELDS if k not in fields]
    if missing:
        raise KeyError(f"state fields missing: {missing}")
    unknown = set(fields) - set(_TENSOR_FIELDS + _INT_FIELDS) - {"split_keys"} - {
        k for k in fields if k.split(".")[0] in _IGNORED}
    if unknown:
        raise KeyError(f"unknown state fields: {sorted(unknown)}")

    def t(name, dtype=None):
        v = torch.tensor(np.asarray(fields[name]), device=device)
        return v if dtype is None else v.to(dtype)

    nav = imu_mod.NavState(t("eskf.nav.r"), t("eskf.nav.t"), t("eskf.nav.v"))
    rng = torch.Generator(device=device)
    rng.manual_seed(seed)
    return OdometryState(
        vmap=voxmap.VoxelMap(t("vmap.points"), t("vmap.key", torch.int32),
                             t("vmap.valid", torch.bool)),
        eskf=eskf_mod.ESKFState(nav, t("eskf.bg"), t("eskf.ba"), t("eskf.cov"),
                                t("eskf.process_noise"), t("eskf.gain")),
        pose_r=t("pose_r"), pose_t=t("pose_t"), prev_r=t("prev_r"),
        prev_t=t("prev_t"), pose_time=t("pose_time"), prev_time=t("prev_time"),
        rings=smoother.VarianceRings(t("rings.mean_ring"), t("rings.max_ring"),
                                     int(fields["rings.count"])),
        rng=rng, frame_idx=int(fields["frame_idx"]),
        split_keys=(t("split_keys", torch.int32) if "split_keys" in fields
                    else torch.zeros((0,), dtype=torch.int32, device=device)))


def state_to_numpy(state: OdometryState) -> dict[str, np.ndarray]:
    """The port's state as numpy arrays under the same field paths."""
    def leaf(path):
        obj = state
        for part in path.split("."):
            obj = getattr(obj, part)
        return obj

    out = {k: leaf(k).detach().cpu().numpy() for k in _TENSOR_FIELDS}
    out["rings.count"] = np.asarray(state.rings.count, np.int32)
    out["frame_idx"] = np.asarray(state.frame_idx, np.int32)
    out["split_keys"] = state.split_keys.detach().cpu().numpy()
    return out


_TENSOR_FIELDS = [
    "vmap.points", "vmap.key", "vmap.valid", "eskf.nav.r", "eskf.nav.t",
    "eskf.nav.v", "eskf.bg", "eskf.ba", "eskf.cov", "eskf.process_noise",
    "eskf.gain", "pose_r", "pose_t", "prev_r", "prev_t", "pose_time",
    "prev_time", "rings.mean_ring", "rings.max_ring",
]
_INT_FIELDS = ["rings.count", "frame_idx"]
