"""The traced stretch of a `--trace 1` run: `torch.profiler` over a fixed
number of frames inside the window, and what the per-layer readers take
from it.

Busy time is the union of the intervals in which a device operation
(kernel, copy, fill) ran, so it can never exceed the stretch; with one
stream it equals the sum of the operations' device times that the port's
`tools/torch_profile_step.py` adds up. The idle share is 1 - busy / wall,
the wall time taken by the host's clock between two read-backs, so the
stretch starts and ends with the device drained. The breakdown lists the
operations that took the most device time, and the longest idle gaps
summed by what the host was doing: the innermost host operation that
covers the middle of the gap, else the harness span around it. The
frames' own spans (from handing a scan over to its pose read back, the
harness's `feed_scan` and `read_back` spans) give the busy time inside
frames, which leaves out the waits between a live cell's scans.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import heapq
import time

SPAN_PREFIX = "lio_bench."
GAP_FLOOR_US = 20.0     # gaps shorter than a launch are not counted by name


@dataclasses.dataclass
class TraceSummary:
    busy_s: float
    window_s: float
    kernel_s: dict            # device seconds by operation name
    device_ops: list          # [[name, seconds]] top 10
    idle_gaps: list           # [[name, seconds]] top 10
    frame_s: float = 0.0      # wall time inside the frames' own spans
    frame_busy_s: float = 0.0  # ... and the busy time inside them


class Tracer:
    """Callable that opens a traced stretch; `summary()` after it closed.
    `probes` are context managers entered around the stretch (the readers'
    counters)."""

    def __init__(self, probes=(), cuda: bool = True):
        self.probes = list(probes)
        self.cuda = cuda
        self.prof = None
        self.wall_s = 0.0

    @contextlib.contextmanager
    def __call__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        with contextlib.ExitStack() as stack:
            for p in self.probes:
                stack.enter_context(p())
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
            prof = profile(activities=acts)
            prof.start()
            t0 = time.perf_counter()
            try:
                with record_function(SPAN_PREFIX + "stretch"):
                    yield
                if self.cuda:
                    torch.cuda.synchronize()
            finally:
                self.wall_s = time.perf_counter() - t0
                prof.stop()
                self.prof = prof

    def summary(self) -> TraceSummary:
        from torch.autograd import DeviceType

        events = list(self.prof.events())
        dev, cpu, span = [], [], None
        for e in events:
            tr = e.time_range
            if e.name.startswith(SPAN_PREFIX):
                # the harness's spans (on the device's timeline too, as annotations)
                if e.name == SPAN_PREFIX + "stretch" and e.device_type != DeviceType.CUDA:
                    span = (tr.start, tr.end)
                elif e.device_type != DeviceType.CUDA:
                    cpu.append((tr.start, tr.end, e.name))
            elif e.device_type == DeviceType.CUDA:
                dev.append((tr.start, tr.end, e.name))
            else:
                cpu.append((tr.start, tr.end, e.name))
        dev.sort()
        kernel_s = collections.Counter()
        for s, e, name in dev:
            kernel_s[name] += (e - s) * 1e-6
        lo, hi = span if span else ((dev[0][0], dev[-1][1]) if dev else (0.0, 0.0))
        busy, gaps, runs, cur = 0.0, [], [], lo
        for s, e, _ in dev:
            s, e = max(s, lo), min(e, hi)
            if e <= cur:
                continue
            if s > cur:
                gaps.append((cur, s))
            busy += e - max(s, cur)
            runs.append((max(s, cur), e))
            cur = e
        if hi > cur:
            gaps.append((cur, hi))
        frames = _frame_spans(cpu)
        frame_busy = sum(max(0.0, min(e, f1) - max(s, f0))
                         for f0, f1 in frames for s, e in runs if s < f1 and e > f0)
        by_host = collections.Counter()
        for (g0, g1), name in zip(gaps, _gap_names(gaps, cpu)):
            if g1 - g0 >= GAP_FLOOR_US:
                by_host[name] += (g1 - g0) * 1e-6
        return TraceSummary(
            busy_s=busy * 1e-6, window_s=self.wall_s, kernel_s=dict(kernel_s),
            device_ops=[[n, s] for n, s in kernel_s.most_common(10)],
            idle_gaps=[[n, s] for n, s in by_host.most_common(10)],
            frame_s=sum(f1 - f0 for f0, f1 in frames) * 1e-6,
            frame_busy_s=frame_busy * 1e-6)


def _frame_spans(cpu) -> list[tuple[float, float]]:
    """Each frame's interval: a `feed_scan` span's start to the end of the
    `read_back` span after it (a frame that returned no pose has none)."""
    marks = sorted((s, e, n) for s, e, n in cpu
                   if n in (SPAN_PREFIX + "feed_scan", SPAN_PREFIX + "read_back"))
    out, start = [], None
    for s, e, n in marks:
        if n == SPAN_PREFIX + "feed_scan":
            start = s
        elif start is not None:
            out.append((start, e))
            start = None
    return out


def _gap_names(gaps, cpu) -> list[str]:
    """For each gap (in start order) the innermost host event covering its
    middle, preferring the program's operations to the harness's spans."""
    cpu = sorted(cpu)
    names, active, j = [], [], 0
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        while j < len(cpu) and cpu[j][0] <= mid:
            s, e, name = cpu[j]
            heapq.heappush(active, (e, s, name))
            j += 1
        while active and active[0][0] < mid:
            heapq.heappop(active)
        live = [(e - s, n) for e, s, n in active if e >= mid]
        own = [x for x in live if not x[1].startswith(SPAN_PREFIX)]
        ours = [x for x in live if x[1].startswith(SPAN_PREFIX)]
        pick = min(own or ours or [(0.0, "host (untraced Python)")])
        names.append(pick[1])
    return names
