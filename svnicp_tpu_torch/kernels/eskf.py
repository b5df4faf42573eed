"""The ESKF's propagation over a frame's IMU window (F1) and its plain version.

The JAX package propagates the filter over a frame's window as one compiled
`lax.scan` (`svnicp_tpu/runtime/pipeline.py:_imu_scan_predict`). The plain
version below is that scan as a Python loop over `core/eskf.predict`, ~80-100
small operations a sample; on the card `propagate` runs the whole window in
one launch of `csrc/eskf_propagate.cu`, in float32 or float64. Both take the
window's rows [n,7] (dt, acc, gyro) in the state's dtype and device, each row
the finish sample of one interval, the previous sample starting as the
first row itself and staying bias-uncompensated.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from svnicp_tpu_torch.core import eskf as eskf_mod
from svnicp_tpu_torch.core import imu as imu_mod
from svnicp_tpu_torch.kernels import _build

_OUT = 15 + 2 * 225   # R [9], t [3], v [3], cov [225], Q [225]


def propagate_plain(ekf: eskf_mod.ESKFState, rows: torch.Tensor, noise,
                    textbook_phi: bool = False) -> eskf_mod.ESKFState:
    """`eskf.predict` over the rows in order, on any device."""
    samples = [imu_mod.IMUSample(r[0], r[1:4], r[4:7]) for r in rows]
    prev = samples[0]
    for cur in samples:
        ekf = eskf_mod.predict(ekf, prev, cur, noise, textbook_phi=textbook_phi)
        prev = cur
    return ekf


def _variances(noise, dtype: torch.dtype) -> ctypes.Array:
    """The four noise diagonals squared in the working dtype, as `predict`
    squares them (`torch.tensor(std, dtype) ** 2`), for the kernel's host
    argument: made once per (diagonals, dtype); the kernel only reads it."""
    stds = (noise.vel_rw, noise.rot_rw, noise.bg_std, noise.ba_std)
    return _squared(tuple(tuple(s) for s in stds), dtype)


@functools.lru_cache(maxsize=16)
def _squared(stds: tuple, dtype: torch.dtype) -> ctypes.Array:
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    var = np.concatenate([np.square(np.asarray(s, np_dtype)) for s in stds])
    return (ctypes.c_double * 12)(*var.astype(np.float64))


def propagate(ekf: eskf_mod.ESKFState, rows: torch.Tensor, noise,
              textbook_phi: bool = False) -> eskf_mod.ESKFState:
    """The propagation in one launch of F1 on the card. The new nav state,
    covariance and process noise are views of one packed output; the biases
    and the gain pass through."""
    cov = ekf.cov
    if cov.device.type != "cuda":
        raise ValueError(f"eskf.propagate: the state is on {cov.device}; the "
                         f"kernel takes CUDA tensors (propagate_plain runs elsewhere)")
    if cov.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"eskf.propagate: {cov.dtype}; the kernel takes float32 "
                        f"or float64")
    n = rows.shape[0]
    if n < 1 or rows.shape != (n, 7):
        raise ValueError(f"eskf.propagate: rows must be [n>=1,7], got {tuple(rows.shape)}")
    nav = ekf.nav
    # the one caller, `pipeline._imu_scan_predict`, casts the rows to the
    # state's dtype and device
    args = [x.contiguous() for x in (rows, nav.r, nav.t, nav.v, cov, ekf.ba)]
    out = torch.empty(_OUT, dtype=cov.dtype, device=cov.device)
    err = _build.library("eskf_propagate.cu").svn_eskf_propagate(
        *(_build.ptr(x) for x in args), _variances(noise, cov.dtype), n,
        int(textbook_phi), int(cov.dtype == torch.float64), _build.ptr(out),
        _build.stream_of(cov))
    _build.check(err, "eskf propagate kernel")
    _build.count_launch(propagate)
    return _unpack(ekf, out)


def _unpack(ekf: eskf_mod.ESKFState, out: torch.Tensor) -> eskf_mod.ESKFState:
    """The state with the kernel's packed output in place of its nav state,
    covariance and process noise (views of `out`)."""
    return ekf._replace(
        nav=imu_mod.NavState(out[0:9].view(3, 3), out[9:12], out[12:15]),
        cov=out[15:240].view(15, 15), process_noise=out[240:].view(15, 15))


propagate.launches = 0
