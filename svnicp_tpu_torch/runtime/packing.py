"""Packed frame outputs and the lazy host facade.

Port of `svnicp_tpu/runtime/packing.py`. The small fields of a FrameOutput
go into one device buffer of the configured dtype and one int32 buffer, in
the JAX package's layout (the tables below are its, copied); the host
reads them through `HostFrameOutput`, which fetches both buffers from the
device once, on first access, with one device-to-host copy into pinned
memory, and serves CPU tensor views after that. A batch of F frames packs
into one [F, _PACK_F32_LEN] and one [F, len(_PACK_I32)] buffer read back by
one copy for all F frames (`pack_outputs`, `host_outputs`).

The fields keep the types the port's FrameOutput gives them, so its
readers (records, the CLI, `trajectory()`) take either: `icp_iterations`
and `imu_dropped` come back as int and `align_ok` as bool, as the port's
step makes them; every other small field is a CPU tensor. The fields
outside the layout (`particles`, `weights`, `history` and the port's
`feature_counts`) pass through as the step made them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_PACK_F32 = (
    ("pose_r", (3, 3)), ("pose_t", (3,)), ("guess_r", (3, 3)),
    ("guess_t", (3,)), ("velocity", (3,)), ("var_icp", (6,)),
    ("var_mean", (6,)), ("var_max_sliding", (6,)), ("var_random_walk", (6,)),
    ("cov", (6, 6)), ("icp_grad_norm", ()), ("kf_gain", (15, 6)),
    ("kf_cov_diag", (15,)),
)
_PACK_I32 = ("icp_iterations", "align_ok", "map_points", "map_dropped",
             "target_overflow", "imu_dropped")
_PACK_OFFSETS = {}
_off = 0
for _name, _shape in _PACK_F32:
    _sz = int(np.prod(_shape)) if _shape else 1
    _PACK_OFFSETS[_name] = (_off, _sz, _shape)
    _off += _sz
_PACK_F32_LEN = _off
del _off, _name, _shape, _sz

# the int32 fields the port's FrameOutput holds as host values
_HOST_TYPED = {"icp_iterations": int, "align_ok": bool, "imu_dropped": int}
_PASS_THROUGH = ("particles", "weights", "history", "feature_counts")

# host-device copies of the batched path: stacked uploads of staged frames
# (runtime/pipeline.py) and read-backs of packed buffers (here)
copies = {"upload": 0, "readback": 0}


class PackedFrameOutput(NamedTuple):
    small: torch.Tensor          # [_PACK_F32_LEN] (or [F, ...]) cfg dtype
    ints: torch.Tensor           # [len(_PACK_I32)] (or [F, ...]) int32
    particles: torch.Tensor      # [P,6] (or a list of F)
    weights: torch.Tensor        # [P]
    history: torch.Tensor        # [H,P,6]
    feature_counts: torch.Tensor | None = None


def _int_fields(out) -> torch.Tensor:
    """The _PACK_I32 fields as one int32 tensor on the output's device; the
    host-typed ones are written by fills, not uploads."""
    device = out.pose_t.device
    vals = []
    for name in _PACK_I32:
        v = getattr(out, name)
        if isinstance(v, torch.Tensor):
            vals.append(v.reshape(()).to(torch.int32))
        else:
            vals.append(torch.full((), int(v), dtype=torch.int32, device=device))
    return torch.stack(vals)


def _small_fields(out) -> torch.Tensor:
    dt = out.pose_t.dtype
    return torch.cat([getattr(out, n).reshape(-1).to(dt) for n, _ in _PACK_F32])


def pack_output(out) -> PackedFrameOutput:
    """One FrameOutput -> its two packed buffers and the pass-through fields."""
    return PackedFrameOutput(_small_fields(out), _int_fields(out), out.particles,
                             out.weights, out.history,
                             getattr(out, "feature_counts", None))


def pack_outputs(outs) -> PackedFrameOutput:
    """F FrameOutputs -> [F, _PACK_F32_LEN] and [F, len(_PACK_I32)] buffers;
    the pass-through fields as lists of F."""
    return PackedFrameOutput(
        torch.stack([_small_fields(o) for o in outs]),
        torch.stack([_int_fields(o) for o in outs]),
        [o.particles for o in outs], [o.weights for o in outs],
        [o.history for o in outs],
        [getattr(o, "feature_counts", None) for o in outs])


class _HostCopy:
    """The host copy of a packed buffer pair, made on first use: on the card
    one device-to-host copy of both (as bytes) into pinned memory; on the
    CPU the buffers themselves."""

    __slots__ = ("_small", "_ints", "_host")

    def __init__(self, small: torch.Tensor, ints: torch.Tensor):
        self._small, self._ints, self._host = small, ints, None

    def get(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self._host is None:
            small, ints = self._small, self._ints
            if small.device.type == "cpu":
                self._host = (small, ints)
            else:
                nb = small.numel() * small.element_size()
                dev = torch.cat([small.reshape(-1).view(torch.uint8),
                                 ints.reshape(-1).view(torch.uint8)])
                host = torch.empty(dev.shape, dtype=torch.uint8, pin_memory=True)
                host.copy_(dev)
                copies["readback"] += 1
                self._host = (host[:nb].view(small.dtype).reshape(small.shape),
                              host[nb:].view(torch.int32).reshape(ints.shape))
            self._small = self._ints = None
        return self._host


class HostFrameOutput:
    """Lazy FrameOutput facade over a packed buffer pair (or one row of a
    batch's): `out.pose_t`, `out.align_ok`, ... all work, read from the
    host copy."""

    __slots__ = ("_copy", "_row", "_pass")

    def __init__(self, packed: PackedFrameOutput, row: int | None = None,
                 copy: _HostCopy | None = None):
        self._copy = copy or _HostCopy(packed.small, packed.ints)
        self._row = row
        self._pass = {n: (getattr(packed, n) if row is None else getattr(packed, n)[row])
                      for n in _PASS_THROUGH}

    def __getattr__(self, name):
        if name in _PASS_THROUGH:
            return self._pass[name]
        if name in _PACK_OFFSETS:
            small = self._copy.get()[0]
            if self._row is not None:
                small = small[self._row]
            off, sz, shape = _PACK_OFFSETS[name]
            return small[off:off + sz].reshape(shape)
        if name in _PACK_I32:
            ints = self._copy.get()[1]
            if self._row is not None:
                ints = ints[self._row]
            v = ints[_PACK_I32.index(name)]
            return _HOST_TYPED[name](v) if name in _HOST_TYPED else v
        raise AttributeError(name)


def host_outputs(packed: PackedFrameOutput) -> list[HostFrameOutput]:
    """The F facades of a packed batch, sharing one read-back."""
    copy = _HostCopy(packed.small, packed.ints)
    return [HostFrameOutput(packed, row=i, copy=copy)
            for i in range(packed.small.shape[0])]
