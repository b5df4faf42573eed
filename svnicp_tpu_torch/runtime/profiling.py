"""Stage timing, spans and counters, and device tracing (port of
`svnicp_tpu/runtime/profiling.py`; ref: the reference's steady-clock Timer,
ICPUtils.h:71-89):

- `StageTimer`: named wall-clock spans with running means (the pipeline's
  `preprocess` and `dispatch`, which `LIOPipeline.frame_timings` reads);
- `span(name)` and `count(name, n)`: the program's spans and counters at
  each layer of a frame. They record only inside `tracing()`; outside it a
  span is one test of a module flag and a shared no-op context;
- `tracing()`: turns recording on and fills a `Trace` at its exit;
- `device_trace`: a `torch.profiler` trace of the enclosed region (host
  and CUDA activity) written to a directory, with the program's spans on
  the same clock as the kernels, where the JAX package writes a
  `jax.profiler` trace.

A recorded span holds its name, start and end on `time.perf_counter_ns()`,
the span that encloses it on the same thread, its thread, and the frame
index of the pipeline that opened it (given to the frame's root span, and
to the stage-ahead worker's span, and inherited by the spans inside). A
layer span (`on=` a tensor on the card) also records a pair of CUDA
events on the current stream, without synchronizing, which give the
layer's interval on the device's clock once the stream has drained. While
a `torch.profiler` records, a span also opens a host-only profiler range
(`RecordFunctionFast`, a CPU operation and not a user annotation, so the
profiler draws nothing of it on the device's timeline).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time

import torch

# the pipeline's StageTimer stages under their names in a trace
STAGE_SPANS = {"preprocess": "svnicp.stage", "dispatch": "svnicp.dispatch"}


class _Local(threading.local):
    def __init__(self):
        self.stack: list[Span] = []     # the open spans of this thread


_recording = None                   # the _Recording of the open tracing(), or None
_local = _Local()
_NULL = contextlib.nullcontext()
_free_events: dict[int, list] = collections.defaultdict(list)   # by card, for reuse


class _Recording:
    def __init__(self):
        self.closed: list[Span] = []     # spans in the order they closed
        self.counters: collections.Counter = collections.Counter()
        self.depth = 0


class Span:
    """A span that always reads the clock (`seconds` after its exit) and
    records only inside `tracing()`: the StageTimer's stages and the
    stage-ahead worker's staging, which are timed whether or not tracing
    is on. `span()` is the one that costs nothing when tracing is off."""

    __slots__ = ("name", "on", "frame", "parent", "thread", "t0", "t1",
                 "events", "range", "rec")

    def __init__(self, name: str, on=None, frame: int | None = None):
        self.name, self.on, self.frame = name, on, frame
        self.parent = self.events = self.range = self.rec = None
        self.thread = self.t0 = self.t1 = 0

    def __enter__(self):
        rec = self.rec = _recording
        if rec is not None:
            stack = _local.stack
            if stack:
                self.parent = stack[-1]
                if self.frame is None:
                    self.frame = self.parent.frame
            stack.append(self)
            self.thread = threading.get_ident()
            if torch.autograd._profiler_enabled():
                self.range = torch._C._profiler._RecordFunctionFast(self.name)
                self.range.__enter__()
            if self.on is not None and self.on.is_cuda:
                self.events = _event_pair(self.on.get_device())
                self.events[0].record(self.events[2])
            self.on = None              # keep no tensor alive in the recording
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.perf_counter_ns()
        rec = self.rec
        if rec is not None:
            if self.events is not None:
                self.events[1].record(self.events[2])
            if self.range is not None:
                self.range.__exit__(None, None, None)
            _local.stack.pop()
            rec.closed.append(self)
            self.rec = None
        return False

    @property
    def seconds(self) -> float:
        return (self.t1 - self.t0) * 1e-9


def span(name: str, on=None, frame: int | None = None):
    """A context that records the span `name` while tracing is on, else a
    shared no-op. `on`: a tensor on the layer's device (a layer span: on
    the card it also records the layer's device interval); `frame`: the
    frame index for this span and those inside it, else the enclosing
    span's."""
    if _recording is None:
        return _NULL
    return Span(name, on, frame)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` while tracing is on."""
    rec = _recording
    if rec is not None:
        rec.counters[name] += n


@dataclasses.dataclass(frozen=True)
class SpanRecord:
    name: str
    start_ns: int             # time.perf_counter_ns()
    end_ns: int
    parent: int | None        # index in Trace.spans of the enclosing span
    thread: int
    frame: int | None
    self_ns: int              # the duration less what its children cover
    device_ms: float | None   # a layer span's interval on the device's clock

    @property
    def ns(self) -> int:
        return self.end_ns - self.start_ns


@dataclasses.dataclass
class Trace:
    """The spans (in start order) and counters recorded in one `tracing()`,
    filled at its exit."""

    spans: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)

    def named(self, name: str) -> list[SpanRecord]:
        return [s for s in self.spans if s.name == name]


def _collect(closed: list, t_start: int) -> list[SpanRecord]:
    spans = sorted((s for s in closed if s.t0 >= t_start), key=lambda s: s.t0)
    index = {id(s): i for i, s in enumerate(spans)}
    child_ns = collections.Counter()
    for s in spans:
        if id(s.parent) in index:
            child_ns[id(s.parent)] += s.t1 - s.t0
    return [SpanRecord(s.name, s.t0, s.t1, index.get(id(s.parent)), s.thread,
                       s.frame, s.t1 - s.t0 - child_ns[id(s)], _device_ms(s))
            for s in spans]


def _event_pair(device: int):
    """(start, end, stream): two timing events of the card, reused from
    earlier recordings (creating one costs tens of microseconds), and the
    card's current stream."""
    free = _free_events[device]
    start, end = (free.pop() if free else torch.cuda.Event(enable_timing=True)
                  for _ in range(2))
    return start, end, torch.cuda.current_stream(device)


def _device_ms(s: Span) -> float | None:
    if s.events is None:
        return None
    start, end, stream = s.events
    end.synchronize()
    ms = start.elapsed_time(end)
    _free_events[stream.device_index].extend((start, end))
    return ms


@contextlib.contextmanager
def tracing():
    """Record spans and counters in the enclosed region; yields a `Trace`
    that is filled at the exit. Nested contexts share one recording (each
    gets what was recorded inside it)."""
    global _recording
    if _recording is None:
        _recording = _Recording()
    rec = _recording
    rec.depth += 1
    n0, c0, t_start = len(rec.closed), dict(rec.counters), time.perf_counter_ns()
    trace = Trace()
    try:
        yield trace
    finally:
        rec.depth -= 1
        if rec.depth == 0:
            _recording = None
        trace.spans = _collect(rec.closed[n0:], t_start)
        trace.counters = {k: v - c0.get(k, 0) for k, v in rec.counters.items()
                          if v != c0.get(k, 0)}


class StageTimer:
    """Accumulating named timers: `with timer.span("dispatch"): ...`. Each
    stage is a span too (`STAGE_SPANS`), timed by the same clock reads."""

    def __init__(self):
        self.totals: dict[str, float] = collections.defaultdict(float)
        self.counts: dict[str, int] = collections.defaultdict(int)
        self.last: dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str, frame: int | None = None):
        s = Span(STAGE_SPANS.get(name, "svnicp." + name), frame=frame)
        try:
            with s:
                yield
        finally:
            self._add(name, s.seconds)

    def _add(self, name: str, seconds: float) -> None:
        self.totals[name] += seconds
        self.counts[name] += 1
        self.last[name] = seconds

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
    the card is present) and write it to `log_dir` as a TensorBoard trace,
    the program's spans (`svnicp.*`) among the host's operations on the
    kernels' clock; yields the `Trace` of the spans, filled at the exit."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)), tracing() as trace:
        yield trace
