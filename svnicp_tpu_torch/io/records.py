"""Per-frame records serialized to JSONL (port of `svnicp_tpu/io/records.py`).

The reference's `stein_msgs` ROS messages and its 13 publishers
(ref: stein_msgs/msg/{SteinParticle,SteinParticleArray,SteinParameters,
Runtime,Variance}.msg, OdometryPipeline.cpp:89-103) become plain dataclass
records, one JSON line each with a `_type` tag. Field names and layout are
the JAX package's, so a consumer of its JSONL reads the port's; a
FrameOutput's tensors come to the host with `.cpu()` first.
"""

from __future__ import annotations

import dataclasses
import json
from typing import IO, Any

import numpy as np


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array-like as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _tolist(x) -> Any:
    arr = _host(x)
    return arr.tolist() if arr.ndim else arr.item()


def _json_default(o):
    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON serializable: {type(o)}")


@dataclasses.dataclass
class ParticleRecord:
    """ref: stein_msgs/msg/SteinParticle.msg — per-dim particle arrays."""

    stamp: float
    x: list
    y: list
    z: list
    roll: list
    pitch: list
    yaw: list
    weights: list

    @staticmethod
    def from_particles(stamp: float, particles, weights) -> "ParticleRecord":
        p = _host(particles)  # [P,6] = [t(3), rot(3)]
        return ParticleRecord(
            stamp=stamp, x=p[:, 0].tolist(), y=p[:, 1].tolist(), z=p[:, 2].tolist(),
            roll=p[:, 3].tolist(), pitch=p[:, 4].tolist(), yaw=p[:, 5].tolist(),
            weights=_tolist(weights),
        )


@dataclasses.dataclass
class RuntimeRecord:
    """ref: stein_msgs/msg/Runtime.msg — per-frame stage timings [s]."""

    stamp: float
    preprocessing_time: float
    steinicp_time: float
    knn_time: float = 0.0
    update_time: float = 0.0
    finish_iter: int = 0


@dataclasses.dataclass
class VarianceRecord:
    """ref: stein_msgs/msg/Variance.msg — the 4-way variance comparison."""

    stamp: float
    var_icp: list
    var_mean_filtered: list
    var_maxsliding_filtered: list
    var_random_walk: list


@dataclasses.dataclass
class ParametersRecord:
    """ref: stein_msgs/msg/SteinParameters.msg — hyperparameter echo."""

    optimizer: str
    learning_rate: float
    iterations: int
    batch_size: int
    particle_count: int
    early_stop: bool
    converge_threshold: float
    correspondence_distance: float
    point_range: list
    voxel_size: float
    map_voxel_size: float
    map_voxel_max_points: int
    weight_mean: bool = False

    @staticmethod
    def from_config(cfg) -> "ParametersRecord":
        return ParametersRecord(
            optimizer=cfg.icp.optimizer, learning_rate=cfg.icp.lr,
            iterations=cfg.icp.iterations, batch_size=cfg.icp.batch_size,
            particle_count=cfg.icp.particle_count, early_stop=cfg.icp.early_stop,
            converge_threshold=cfg.icp.convergence_threshold,
            correspondence_distance=cfg.icp.max_dist,
            point_range=[cfg.preprocess.min_range, cfg.preprocess.max_range],
            voxel_size=cfg.preprocess.voxel_size, map_voxel_size=cfg.map.voxel_size,
            map_voxel_max_points=cfg.map.max_points_per_voxel,
        )


@dataclasses.dataclass
class ParticleHistoryRecord:
    """ref: stein_msgs/msg/SteinParticleArray.msg — the full per-iteration
    particle trajectories (/svnicp/all_particles publisher fed by
    particle_stack_, OdometryPipeline.cpp:966-985). Each per-dim field is
    [iters][P]; only the iterations actually run are included (updates are
    frozen after convergence)."""

    stamp: float
    iterations: int
    x: list
    y: list
    z: list
    roll: list
    pitch: list
    yaw: list

    @staticmethod
    def from_history(stamp: float, history, iterations: int) -> "ParticleHistoryRecord":
        h = _host(history)[: max(int(iterations), 1)]   # [it,P,6]
        return ParticleHistoryRecord(
            stamp=stamp, iterations=int(iterations),
            x=h[:, :, 0].tolist(), y=h[:, :, 1].tolist(), z=h[:, :, 2].tolist(),
            roll=h[:, :, 3].tolist(), pitch=h[:, :, 4].tolist(),
            yaw=h[:, :, 5].tolist(),
        )


@dataclasses.dataclass
class KFGainRecord:
    """ref: the KF gain + covariance debug publisher
    (/svnicp/kf_gain, OdometryPipeline.cpp:789-795): the [15,6] Kalman gain,
    the post-update state covariance diagonal, and the ICP measurement
    covariance that produced them."""

    stamp: float
    gain: list          # [15][6]
    kf_cov_diag: list   # [15]
    icp_cov: list       # [6][6] particle covariance fed to the update


@dataclasses.dataclass
class OdometryRecord:
    """Pose + twist + covariance (ref: nav_msgs Odometry publisher :861-920)."""

    stamp: float
    position: list
    quaternion: list       # [w,x,y,z]
    velocity: list
    covariance: list       # 36 entries row-major


def quaternion_from_matrix(r: np.ndarray) -> list:
    """[w,x,y,z] from a 3x3 rotation matrix."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return [0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
                (r[1, 0] - r[0, 1]) / s]
    i = int(np.argmax(np.diag(r)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(r[i, i] - r[j, j] - r[k, k] + 1.0, 1e-12)) * 2
    q = [0.0, 0.0, 0.0, 0.0]
    q[0] = (r[k, j] - r[j, k]) / s
    q[i + 1] = 0.25 * s
    q[j + 1] = (r[j, i] + r[i, j]) / s
    q[k + 1] = (r[k, i] + r[i, k]) / s
    return q


def frame_records(stamp: float, out, include_particles: bool = True,
                  include_kf_gain: bool = False):
    """Expand a pipeline FrameOutput into its record set. The particle
    history record is emitted whenever the output carries one
    (cfg.save_particles); the KF gain echo is opt-in (kf mode only)."""
    recs = [
        OdometryRecord(
            stamp=stamp,
            position=_tolist(out.pose_t),
            quaternion=quaternion_from_matrix(_host(out.pose_r)),
            velocity=_tolist(out.velocity),
            covariance=_host(out.cov).reshape(-1).tolist(),
        ),
        VarianceRecord(
            stamp=stamp,
            var_icp=_tolist(out.var_icp),
            var_mean_filtered=_tolist(out.var_mean),
            var_maxsliding_filtered=_tolist(out.var_max_sliding),
            var_random_walk=_tolist(out.var_random_walk),
        ),
    ]
    if include_particles:
        recs.append(ParticleRecord.from_particles(stamp, out.particles, out.weights))
    history = getattr(out, "history", None)
    if history is not None and history.shape[0] > 0 and int(out.icp_iterations) > 0:
        recs.append(ParticleHistoryRecord.from_history(
            stamp, history, int(out.icp_iterations)))
    if include_kf_gain:
        recs.append(KFGainRecord(
            stamp=stamp,
            gain=_host(out.kf_gain).tolist(),
            kf_cov_diag=_tolist(out.kf_cov_diag),
            icp_cov=_host(out.cov).tolist(),
        ))
    return recs


class JSONLWriter:
    """Append records to a JSONL stream, one line per record with a type tag."""

    def __init__(self, fp: IO[str]):
        self._fp = fp

    def write(self, record) -> None:
        payload = dataclasses.asdict(record)
        payload["_type"] = type(record).__name__
        self._fp.write(json.dumps(payload, default=_json_default) + "\n")

    def write_all(self, records) -> None:
        for r in records:
            self.write(r)
