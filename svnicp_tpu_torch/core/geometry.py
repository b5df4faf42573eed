"""SO(3)/SE(3) Lie-group operations on tensors with any leading batch shape.

Port of `svnicp_tpu/core/geometry.py` (the subset the odometry path uses).
Every function broadcasts over leading axes, so the JAX package's vmapped
`b*` aliases are the same functions here. The guarded Taylor branches are
kept as written there: `_taylor_coeffs_sq` takes the squared angle and only
takes a square root on the guarded side, and `so3_log` returns zero where
sin(angle) ~ 0 at angle ~ pi.
"""

from __future__ import annotations

import torch

_SMALL = 1e-6


def skew(v: torch.Tensor) -> torch.Tensor:
    """[...,3] -> [...,3,3] cross-product (hat) matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def unskew(m: torch.Tensor) -> torch.Tensor:
    """[...,3,3] -> [...,3], inverse of `skew` (vee operator)."""
    return torch.stack([m[..., 2, 1] - m[..., 1, 2],
                        m[..., 0, 2] - m[..., 2, 0],
                        m[..., 1, 0] - m[..., 0, 1]], dim=-1) * 0.5


def _taylor_coeffs_sq(a2: torch.Tensor):
    """(sin a / a, (1-cos a)/a^2, (a-sin a)/a^3) from a^2, Taylor below 1e-6."""
    small = a2 < _SMALL
    a = torch.sqrt(torch.where(small, torch.ones_like(a2), a2))
    sinc = torch.where(small, 1.0 - a2 / 6.0, torch.sin(a) / a)
    cosc = torch.where(small, 0.5 - a2 / 24.0, (1.0 - torch.cos(a)) / (a * a))
    sinc3 = torch.where(small, 1.0 / 6.0 - a2 / 120.0,
                        (a - torch.sin(a)) / (a * a * a))
    return sinc, cosc, sinc3


def _eye_like(w: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=w.dtype, device=w.device)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Axis-angle [...,3] -> rotation [...,3,3]: I + sinc W + cosc W^2."""
    sinc, cosc, _ = _taylor_coeffs_sq(torch.sum(w * w, dim=-1))
    W = skew(w)
    return (_eye_like(w) + sinc[..., None, None] * W
            + cosc[..., None, None] * (W @ W))


def so3_left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian of SO(3): I + cosc W + sinc3 W^2."""
    _, cosc, sinc3 = _taylor_coeffs_sq(torch.sum(w * w, dim=-1))
    W = skew(w)
    return (_eye_like(w) + cosc[..., None, None] * W
            + sinc3[..., None, None] * (W @ W))


def so3_left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse left Jacobian: I - W/2 + (1/a^2 - (1+cos a)/(2 a sin a)) W^2."""
    a2 = torch.sum(w * w, dim=-1)
    small = a2 < _SMALL
    a = torch.sqrt(torch.where(small, torch.ones_like(a2), a2))
    cot_term = torch.where(
        small, 1.0 / 12.0 + a2 / 720.0,
        1.0 / (a * a) - (1.0 + torch.cos(a)) / (2.0 * a * torch.sin(a)))
    W = skew(w)
    return _eye_like(w) - 0.5 * W + cot_term[..., None, None] * (W @ W)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation [...,3,3] -> axis-angle [...,3] (trace formula, atan2 angle).
    Zero where sin(angle)^2 < 1e-12 and cos(angle) < 0 (angle ~ pi)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_a = torch.clamp(0.5 * (tr - 1.0), -1.0, 1.0)
    vee = unskew(R)
    s2 = torch.sum(vee * vee, dim=-1)
    small = s2 < 1e-12
    near_pi = small & (cos_a < 0.0)
    sin_a = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    angle = torch.atan2(sin_a, cos_a)
    factor = torch.where(small, 1.0 + (1.0 - cos_a) / 3.0, angle / sin_a)
    w = factor[..., None] * vee
    return torch.where(near_pi[..., None], torch.zeros_like(w), w)


def euler_zyx_to_matrix(roll: torch.Tensor, pitch: torch.Tensor,
                        yaw: torch.Tensor) -> torch.Tensor:
    """R = Rz(yaw) Ry(pitch) Rx(roll); [...] angles -> [...,3,3]."""
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    return torch.stack([
        torch.stack([cp * cy, sr * sp * cy - cr * sy, sr * sy + cr * sp * cy], dim=-1),
        torch.stack([cp * sy, cr * cy + sr * sp * sy, cr * sp * sy - sr * cy], dim=-1),
        torch.stack([-sp, sr * cp, cr * cp], dim=-1),
    ], dim=-2)


def matrix_to_euler_zyx(R: torch.Tensor) -> torch.Tensor:
    """[...,3,3] -> [...,3] = [roll, pitch, yaw] of R = Rz Ry Rx (ref:
    SVGDICP.cpp:266-272); batched over the leading axes."""
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    sp = torch.clamp(-R[..., 2, 0], -1.0, 1.0)
    pitch = torch.atan2(sp, torch.sqrt(torch.clamp_min(1.0 - sp * sp, 0.0)))
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    return torch.stack([roll, pitch, yaw], dim=-1)


# the JAX package's vmapped aliases; these functions batch already
bmatrix_to_euler = matrix_to_euler_zyx
bso3_exp = so3_exp
bso3_log = so3_log
bso3_left_jacobian = so3_left_jacobian
beuler_to_matrix = euler_zyx_to_matrix


def euler_zyx_partials(roll: torch.Tensor, pitch: torch.Tensor,
                       yaw: torch.Tensor) -> torch.Tensor:
    """dR/d(roll, pitch, yaw) of `euler_zyx_to_matrix` in closed form;
    [...] angles -> [...,3,3,3], the angle on axis -3 (the JAX package takes
    `jax.jacfwd` of the same matrix)."""
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cr, sr = torch.cos(roll), torch.sin(roll)
    zero = torch.zeros_like(cy)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    d_roll = mat([[zero, cr * sp * cy + sr * sy, cr * sy - sr * sp * cy],
                  [zero, cr * sp * sy - sr * cy, -sr * sp * sy - cr * cy],
                  [zero, cr * cp, -sr * cp]])
    d_pitch = mat([[-sp * cy, sr * cp * cy, cr * cp * cy],
                   [-sp * sy, sr * cp * sy, cr * cp * sy],
                   [-cp, -sr * sp, -cr * sp]])
    d_yaw = mat([[-cp * sy, -sr * sp * sy - cr * cy, sr * cy - cr * sp * sy],
                 [cp * cy, sr * sp * cy - cr * sy, sr * sy + cr * sp * cy],
                 [zero, zero, zero]])
    return torch.stack([d_roll, d_pitch, d_yaw], dim=-3)


def se3_exp(xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[...,6] = [rho, omega] -> (R [...,3,3], t = J_l(omega) rho)."""
    rho, omega = xi[..., :3], xi[..., 3:]
    t = (so3_left_jacobian(omega) @ rho[..., None])[..., 0]
    return so3_exp(omega), t


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> [rho, omega] with rho = J_l(omega)^-1 t."""
    omega = so3_log(R)
    rho = (so3_left_jacobian_inv(omega) @ t[..., None])[..., 0]
    return torch.cat([rho, omega], dim=-1)


def transform_compose(Ra, ta, Rb, tb):
    """(Ra,ta) o (Rb,tb): first apply b, then a."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def transform_inverse(R, t):
    Rinv = R.transpose(-1, -2)
    return Rinv, -(Rinv @ t[..., None])[..., 0]


def transform_points(R, t, pts):
    """Apply (R [3,3], t [3]) to pts [...,3]."""
    return (pts.reshape(-1, 3) @ R.T).reshape(pts.shape) + t


def interpolate_pose(R0, t0, R1, t1, alpha):
    """Geodesic interpolation T0 exp(alpha log(T0^-1 T1)) for a scalar
    alpha."""
    xi = se3_log(*transform_compose(*transform_inverse(R0, t0), R1, t1))
    return transform_compose(R0, t0, *se3_exp(alpha * xi))


def kabsch(src: torch.Tensor, tgt: torch.Tensor, w: torch.Tensor):
    """Weighted closed-form rigid alignment (Kabsch / Umeyama), batched:
    src [...,B,3], tgt [...,B,3], w [...,B] -> (R [...,3,3], t [...,3])
    minimising sum_b w_b |R s_b + t - q_b|^2 by the SVD of the weighted
    cross-covariance, with the determinant correction that keeps R proper.
    u diag(1,1,det) vt is unique when the cross-covariance has full rank;
    at a rank-deficient one the singular vectors' signs are the LAPACK's."""
    sw = w.sum(-1).clamp_min(1e-12)
    mu_s = torch.einsum("...b,...bi->...i", w, src) / sw[..., None]
    mu_t = torch.einsum("...b,...bi->...i", w, tgt) / sw[..., None]
    cross = torch.einsum("...b,...bi,...bj->...ij", w, tgt - mu_t[..., None, :],
                         src - mu_s[..., None, :])
    u, _, vt = torch.linalg.svd(cross)
    d = torch.linalg.det(u @ vt)
    ones = torch.ones_like(d)
    corr = torch.diag_embed(torch.stack([ones, ones, d], dim=-1))
    r = u @ (corr @ vt)
    return r, mu_t - (r @ mu_s[..., None])[..., 0]
