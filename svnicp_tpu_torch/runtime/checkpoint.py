"""Checkpoint and resume of the odometry state (port of
`svnicp_tpu/runtime/checkpoint.py`).

The state (voxel map, ESKF, pose history, variance rings, frame index) is
saved to one compressed .npz under the dotted field names of
`convert.state_to_numpy`, with the particle generator's state beside them,
so a run resumes mid-sequence and continues as it would have. A
pipeline's checkpoint adds its host counters (`extra_*`) and, with the
pose graph, the keyframes, edges, keyframe clouds and closures (`pg_*`),
under the JAX package's keys.
"""

from __future__ import annotations

import numpy as np
import torch

_RNG = "rng_state"
_EXTRA = "extra_"


def save_state(path: str, state, extra: dict | None = None) -> None:
    """Write an OdometryState (and `extra` host values) to `path` (.npz)."""
    from svnicp_tpu_torch import convert

    payload = {f"state.{k}": v for k, v in convert.state_to_numpy(state).items()}
    payload[_RNG] = state.rng.get_state().numpy()
    for k, v in (extra or {}).items():
        payload[_EXTRA + k] = np.asarray(v)
    np.savez_compressed(path, **payload)


def load_state(path: str, template):
    """Read a state saved by `save_state` onto `template`'s device ->
    (state, extra dict). Every field's shape and dtype are checked against
    the template, so a checkpoint of another configuration raises instead
    of corrupting the run."""
    from svnicp_tpu_torch import convert

    want = convert.state_to_numpy(template)
    with np.load(path) as data:
        fields = {}
        for name, ref in want.items():
            arr = data[f"state.{name}"]
            if arr.shape != ref.shape or arr.dtype != ref.dtype:
                raise ValueError(
                    f"checkpoint field {name}: shape/dtype {arr.shape}/{arr.dtype} "
                    f"does not match the state's {ref.shape}/{ref.dtype} "
                    "(different config?)")
            fields[name] = arr
        rng_state = torch.from_numpy(data[_RNG].copy())
        extra = {k[len(_EXTRA):]: data[k] for k in data.files if k.startswith(_EXTRA)}
    state = convert.state_from_numpy(fields, template.pose_t.device)
    state.rng.set_state(rng_state)
    return state, extra


def save_pipeline(path: str, pipe) -> None:
    """Checkpoint a LIOPipeline's resumable state, with the pose graph
    (keyframes, edges, keyframe clouds, closures) when it is on."""
    extra = {
        "frames": pipe._frames,
        "last_frame_time": pipe._last_frame_time or -1.0,
        "last_imu_time": pipe._last_imu_time or -1.0,
    }
    pg = pipe.posegraph
    if pg is not None and pg.nodes_r:
        extra["pg_nodes_r"] = np.stack(pg.nodes_r)
        extra["pg_nodes_t"] = np.stack(pg.nodes_t)
        extra["pg_stamps"] = np.asarray(pg.stamps)
        if pg.edges:
            extra["pg_edge_ij"] = np.asarray([(e[0], e[1]) for e in pg.edges])
            extra["pg_edge_r"] = np.stack([e[2] for e in pg.edges])
            extra["pg_edge_t"] = np.stack([e[3] for e in pg.edges])
            extra["pg_edge_info"] = np.stack([e[4] for e in pg.edges])
        if pipe._keyframe_clouds:
            extra["pg_clouds"] = np.stack([c for c, _ in pipe._keyframe_clouds])
            extra["pg_cloud_valid"] = np.stack([v for _, v in pipe._keyframe_clouds])
        extra["pg_loops"] = (np.asarray(pipe.loop_closures)
                             if pipe.loop_closures else np.zeros((0, 2), np.int64))
    save_state(path, pipe.state, extra=extra)


def load_pipeline(path: str, pipe) -> None:
    """Restore a LIOPipeline checkpointed by `save_pipeline` into `pipe`,
    which must be built with the same configuration."""
    state, extra = load_state(path, pipe.state)
    pipe.state = state
    pipe._frames = int(extra["frames"])
    lft = float(extra["last_frame_time"])
    pipe._last_frame_time = None if lft < 0 else lft
    lit = float(extra["last_imu_time"])
    pipe._last_imu_time = None if lit < 0 else lit
    if pipe.posegraph is not None and "pg_nodes_r" in extra:
        pg = pipe.posegraph
        pg.nodes_r = list(extra["pg_nodes_r"])
        pg.nodes_t = list(extra["pg_nodes_t"])
        pg.stamps = list(extra["pg_stamps"])
        pg.edges = []
        if "pg_edge_ij" in extra:
            for (i, j), r, t, info in zip(extra["pg_edge_ij"], extra["pg_edge_r"],
                                          extra["pg_edge_t"], extra["pg_edge_info"]):
                pg.edges.append((int(i), int(j), r, t, info))
        if "pg_clouds" in extra:
            pipe._keyframe_clouds = list(zip(extra["pg_clouds"],
                                             extra["pg_cloud_valid"]))
        pipe.loop_closures = [tuple(x) for x in extra["pg_loops"]]
