"""15-state error-state Kalman filter (port of `svnicp_tpu/core/eskf.py`).

Error-state ordering [dp(0:3), dv(3:6), dtheta(6:9), dbg(9:12), dba(12:15)]
(ESEKF.cpp:41). Plain 15x15 / 6x6 tensor algebra, no kernels. As in the
JAX package:
- the velocity->attitude block of the transition is the reference's
  `so3_exp(R a) dt` (an exponential of the rotated specific force used as a
  matrix, ESEKF.cpp:47-48) unless `textbook_phi` selects -skew(R a) dt;
- the gain takes the explicit inverse of the innovation covariance;
- the biases are injected at their declared offsets 9:12 / 12:15 (the
  reference's off-by-one is a bug the JAX package fixed).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from svnicp_tpu_torch.config import IMUNoiseConfig, LIOConfig
from svnicp_tpu_torch.core import geometry as geo
from svnicp_tpu_torch.core import imu as imu_mod


class ESKFState(NamedTuple):
    nav: imu_mod.NavState
    bg: torch.Tensor              # [3] gyro bias
    ba: torch.Tensor              # [3] accel bias
    cov: torch.Tensor             # [15,15]
    process_noise: torch.Tensor   # [15,15] last Q (random-walk variance echo)
    gain: torch.Tensor            # [15,6] last Kalman gain


def create(lio: LIOConfig, noise: IMUNoiseConfig, dtype=torch.float32,
           device=None) -> ESKFState:
    """Initial covariance from the configured stds (ref: ESEKF.cpp:23-28);
    the attitude std is in degrees in the configs."""
    d2r = math.pi / 180.0

    def sq(values, scale=1.0):
        return torch.tensor(values, dtype=dtype, device=device).mul(scale) ** 2

    diag = torch.cat([sq(lio.init_pos_std), sq(lio.init_vel_std),
                      sq(lio.init_rot_std, d2r), sq(noise.bg_std),
                      sq(noise.ba_std)])
    zeros3 = torch.zeros(3, dtype=dtype, device=device)
    return ESKFState(
        nav=imu_mod.NavState.identity(dtype, device),
        bg=zeros3, ba=zeros3.clone(),
        cov=torch.diag(diag),
        process_noise=torch.zeros((15, 15), dtype=dtype, device=device),
        gain=torch.zeros((15, 6), dtype=dtype, device=device),
    )


def predict(state: ESKFState, imu_prev: imu_mod.IMUSample,
            imu_cur: imu_mod.IMUSample, noise: IMUNoiseConfig,
            textbook_phi: bool = False) -> ESKFState:
    """Propagate the nav state and covariance over one IMU interval
    (ref: ESEKF.cpp:34-69); `imu_cur` is bias-compensated here."""
    cov = state.cov
    kw = dict(dtype=cov.dtype, device=cov.device)
    imu_cur = imu_mod.compensate(imu_cur, state.ba, state.bg)
    r_prev = state.nav.r
    nav = imu_mod.propagate(state.nav, imu_prev, imu_cur)

    dt = imu_cur.dt
    ra = r_prev @ imu_cur.acc
    phi = torch.eye(15, **kw)
    phi[0:3, 3:6] = torch.eye(3, **kw) * dt
    phi[3:6, 6:9] = (-geo.skew(ra) if textbook_phi else geo.so3_exp(ra)) * dt
    phi[3:6, 12:15] = r_prev * dt
    phi[6:9, 9:12] = -r_prev * dt

    def rot_diag(std):
        d = torch.diag(torch.tensor(std, **kw) ** 2)
        return r_prev @ d @ r_prev.T * dt

    def bias_diag(std):
        return 2.0 * torch.diag(torch.tensor(std, **kw) ** 2) * dt

    q = torch.zeros((15, 15), **kw)
    q[3:6, 3:6] = rot_diag(noise.vel_rw)
    q[6:9, 6:9] = rot_diag(noise.rot_rw)
    q[9:12, 9:12] = bias_diag(noise.bg_std)
    q[12:15, 12:15] = bias_diag(noise.ba_std)
    return state._replace(nav=nav, cov=phi @ cov @ phi.T + q, process_noise=q)


def update(state: ESKFState, icp_cov: torch.Tensor,
           icp_correction: torch.Tensor) -> ESKFState:
    """Fuse the ICP pose observation (ref: ESEKF.cpp:71-99): H selects dp and
    dtheta; the pose injects as T exp(error), the velocity adds R_new dv."""
    cov = state.cov
    h = torch.zeros((6, 15), dtype=cov.dtype, device=cov.device)
    h[0:3, 0:3] = torch.eye(3, dtype=cov.dtype, device=cov.device)
    h[3:6, 6:9] = h[0:3, 0:3]
    s = h @ cov @ h.T + icp_cov
    gain = cov @ h.T @ torch.linalg.inv(s)                     # [15,6]
    delta = gain @ icp_correction                              # [15]
    new_cov = cov - gain @ h @ cov
    nav = state.nav
    r_new, t_new = geo.transform_compose(nav.r, nav.t, geo.so3_exp(delta[6:9]),
                                         delta[0:3])
    v_new = nav.v + r_new @ delta[3:6]
    return state._replace(nav=imu_mod.NavState(r_new, t_new, v_new),
                          bg=state.bg + delta[9:12], ba=state.ba + delta[12:15],
                          cov=new_cov, gain=gain)


def random_walk_variance(state: ESKFState) -> torch.Tensor:
    """Diagonals of the velocity and attitude process-noise blocks
    (ref: ESKF.h:42-45)."""
    q = state.process_noise
    return torch.cat([torch.diagonal(q[3:6, 3:6]), torch.diagonal(q[6:9, 6:9])])
