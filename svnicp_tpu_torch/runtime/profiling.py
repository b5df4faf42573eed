"""Stage timing and device tracing (port of `svnicp_tpu/runtime/profiling.py`;
ref: the reference's steady-clock Timer, ICPUtils.h:71-89):

- `StageTimer`: named wall-clock spans with running means;
- `device_trace`: a `torch.profiler` trace of the enclosed region (host
  and CUDA activity) written to a directory, where the JAX package writes
  a `jax.profiler` trace.
"""

from __future__ import annotations

import collections
import contextlib
import time


class StageTimer:
    """Accumulating named timers: `with timer.span("dispatch"): ...`."""

    def __init__(self):
        self.totals: dict[str, float] = collections.defaultdict(float)
        self.counts: dict[str, int] = collections.defaultdict(int)
        self.last: dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1
            self.last[name] = dt

    def means(self) -> dict[str, float]:
        return {k: self.totals[k] / max(self.counts[k], 1) for k in self.totals}

    def report(self) -> str:
        return "  ".join(f"{k}={v * 1000:.1f}ms"
                         for k, v in sorted(self.means().items()))

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
        self.last.clear()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Trace the enclosed region with `torch.profiler` (CPU, and CUDA where
    the card is present) and write it to `log_dir` as a TensorBoard trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
