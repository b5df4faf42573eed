"""Faults planted under a run's timed path, for the readings a limit is set
below (`lio_bench/control.py --fault <name>`) and for the benchmark's own
tests, which see `correct` come out false with each.

Each fault takes a `setattr(obj, name, value)` (pytest's
`monkeypatch.setattr`, or `Patch.setattr` here) and breaks the program
where it works; the judge still reads the configuration as stated.
"""

from __future__ import annotations

import dataclasses


def state_unchanged(setattr) -> None:
    """The align step returns its particles unchanged and says it converged."""
    import torch

    from svnicp_tpu_torch.core import svn

    def frozen(cfg, prep, source, src_valid, prior, r0, t0, r, t):
        zero = torch.zeros((), dtype=source.dtype, device=source.device)
        return r, t, zero, zero

    setattr(svn, "_svn_iteration", frozen)


def half_batch(setattr) -> None:
    """The moments sum over every other source row only (the plain
    version of the kernel, which the CPU runs)."""
    import torch

    from svnicp_tpu_torch.kernels import nn

    orig = nn.point_moments_plain

    def half(params, prep, max_dist):
        keep = (torch.arange(prep.vmask.shape[0], device=prep.vmask.device) % 2 == 0)
        return orig(params, prep._replace(vmask=prep.vmask * keep.to(prep.vmask.dtype)),
                    max_dist)

    setattr(nn, "point_moments_plain", half)


def answer_altered(setattr) -> None:
    """Each published position moved 5 mm where the step produces it."""
    import torch

    from svnicp_tpu_torch.runtime import pipeline

    orig = pipeline.odometry_step

    def moved(*args, **kwargs):
        state, out = orig(*args, **kwargs)
        shift = torch.tensor([0.005, 0.0, 0.0], dtype=out.pose_t.dtype,
                             device=out.pose_t.device)
        return state, out._replace(pose_t=out.pose_t + shift)

    setattr(pipeline, "odometry_step", moved)


def early_stop(setattr) -> None:
    """The align loop stops sooner than the configuration says: at ten
    times its threshold, and at half its cap of iterations."""
    from svnicp_tpu_torch import config

    orig = config.from_dict

    def sooner(data):
        cfg = orig(data)
        icp = dataclasses.replace(cfg.icp,
                                  convergence_threshold=10 * cfg.icp.convergence_threshold,
                                  iterations=cfg.icp.iterations // 2)
        return dataclasses.replace(cfg, icp=icp)

    setattr(config, "from_dict", sooner)


def half_capacity(setattr) -> None:
    """The program holds half the map rows and half the stage-1 target
    rows that the configuration states."""
    from svnicp_tpu_torch import config

    orig = config.from_dict

    def halved(data):
        cfg = orig(data)
        icp = dataclasses.replace(cfg.icp, target_capacity=cfg.icp.target_capacity // 2)
        vmap = dataclasses.replace(cfg.map, capacity=cfg.map.capacity // 2)
        return dataclasses.replace(cfg, icp=icp, map=vmap)

    setattr(config, "from_dict", halved)


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch, answer_altered, early_stop,
                                  half_capacity)}


class Patch:
    """`setattr` that remembers what it replaced; `undo()` puts it back."""

    def __init__(self):
        self._undo = []

    def setattr(self, obj, name, value) -> None:
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self) -> None:
        while self._undo:
            obj, name, value = self._undo.pop()
            setattr(obj, name, value)
