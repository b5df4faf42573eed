"""The measured window: the drive fed to `LIOPipeline` closed loop (replay)
or at the sensor's rate (live), each frame's pose and covariance read to
the host as a user who publishes odometry reads them.

Replay: passes over the drive back to back, each a fresh pipeline, until
`seconds` have passed; the window closes at the end of the frame that
crosses it. Live: one pipeline, the drive's first frames fed as warm-up
before the window, then each scan handed over at its due time on the
sensor's clock and each IMU sample at its own stamp, in arrival order;
the window holds the scans due within `seconds` of its opening.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np


@dataclasses.dataclass
class FrameRecord:
    k: int                    # frame of the drive
    t_feed: float             # perf_counter when the scan was handed over
    t_done: float             # ... when its pose and var_icp were on the host
    due: float | None         # live: when the scan was due
    arrived: bool             # its pose reached the host
    ok: bool                  # ... with align_ok
    iterations: int
    preprocess_s: float       # the pipeline's `preprocess` span of the frame


@dataclasses.dataclass
class Window:
    frames: list
    t_open: float
    t_close: float
    passes: list              # the pipelines, oldest first (at most two kept)

    @property
    def seconds(self) -> float:
        return self.t_close - self.t_open


def _read_back(out) -> np.ndarray:
    """The frame's position, rotation and var_icp on the host, one copy."""
    import torch

    return torch.cat([out.pose_t.reshape(3), out.pose_r.reshape(9),
                      out.var_icp.reshape(6)]).cpu().numpy()


class Feeder:
    """Feeds frames of the drive into one pipeline. With `spans` (a traced
    run) each call sits in a named `record_function` span, so the trace
    can say which call the host was in."""

    def __init__(self, pipe, drive, particles, spans: bool = False):
        self.pipe, self.drive, self.particles = pipe, drive, particles
        self.spans = spans

    def _span(self, name: str):
        if not self.spans:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function("lio_bench." + name)

    def imu(self, k: int) -> None:
        with self._span("feed_imu"):
            for t, acc, gyro in self.drive.imu[k]:
                self.pipe.feed_imu(t, acc, gyro)

    def scan(self, k: int):
        """Hand scan k over, a sweep's 4th column as its per-point times;
        -> (pose read back or None, iterations, ok)."""
        scan = self.drive.scans[k]
        points, times = (scan, None) if scan.shape[1] == 3 else (scan[:, :3], scan[:, 3])
        with self._span("feed_scan"):
            out = self.pipe.feed_scan(float(self.drive.times[k]), points, timestamps=times,
                                      init_particles=self.particles[k])
        if out is None:
            return None, 0, False
        with self._span("read_back"):
            return _read_back(out), int(out.icp_iterations), bool(out.align_ok)


def warm_up(make_pipe, drive, particles, frames: int):
    """Feed the drive's first frames through a pipeline (set-up); returns it."""
    f = Feeder(make_pipe(), drive, particles)
    for k in range(frames):
        f.imu(k)
        f.scan(k)
    return f.pipe


class _Stretch:
    """Starts the trace at window frame `start` and stops it `count` frames
    later (nothing without a tracer)."""

    def __init__(self, tracer, start: int, count: int):
        self.tracer, self.start, self.end = tracer, start, start + count
        self.cm = None

    def before(self, i: int) -> None:
        if self.tracer is not None and i == self.start:
            self.cm = self.tracer()
            self.cm.__enter__()

    def after(self, i: int) -> None:
        if self.cm is not None and i == self.end - 1:
            self.cm.__exit__(None, None, None)
            self.cm = None

    def close(self) -> None:
        if self.cm is not None:
            self.cm.__exit__(None, None, None)
            self.cm = None


def replay(make_pipe, drive, particles, seconds: float, tracer=None,
           trace_start: int = 0, trace_frames: int = 0) -> Window:
    frames: list[FrameRecord] = []
    passes = []
    stretch = _Stretch(tracer, trace_start, trace_frames)
    t_open = time.perf_counter()
    t_now = t_open
    try:
        while t_now - t_open < seconds:
            feeder = Feeder(make_pipe(), drive, particles, spans=tracer is not None)
            passes = (passes + [feeder.pipe])[-2:]
            for k in range(len(drive.times)):
                i = len(frames)
                stretch.before(i)
                feeder.imu(k)
                t0 = time.perf_counter()
                host, its, ok = feeder.scan(k)
                t_now = time.perf_counter()
                timing = feeder.pipe.frame_timings[-1] if feeder.pipe.frame_timings else {}
                frames.append(FrameRecord(k, t0, t_now, None, host is not None,
                                          host is not None and ok, its,
                                          float(timing.get("preprocessing_time", 0.0))))
                stretch.after(i)
                if t_now - t_open >= seconds:
                    break
    finally:
        stretch.close()
    return Window(frames, t_open, t_now, passes)


def live_frames(seconds: float, rate_hz: float) -> int:
    """The scans due in a live window."""
    return int(np.ceil(seconds * rate_hz))


def live(pipe, drive, particles, warmup: int, rate_hz: float, seconds: float,
         tracer=None, trace_start: int = 0, trace_frames: int = 0) -> Window:
    """Frames `warmup`.. at the sensor's rate; the pipeline has already
    taken frames 0..warmup-1."""
    feeder = Feeder(pipe, drive, particles, spans=tracer is not None)
    n_win = live_frames(seconds, rate_hz)
    t_first = float(drive.times[warmup])
    frames: list[FrameRecord] = []
    stretch = _Stretch(tracer, trace_start, trace_frames)
    t_open = time.perf_counter()

    def wait_until(due: float) -> None:
        while True:
            left = due - time.perf_counter()
            if left <= 0:
                return
            time.sleep(min(left, 0.002) if left > 0.0005 else 0)

    try:
        for i in range(n_win):
            k = warmup + i
            stretch.before(i)
            for t, acc, gyro in drive.imu[k]:
                wait_until(t_open + (t - t_first))
                with feeder._span("feed_imu"):
                    pipe.feed_imu(t, acc, gyro)
            due = t_open + (float(drive.times[k]) - t_first)
            wait_until(due)
            t0 = time.perf_counter()
            host, its, ok = feeder.scan(k)
            t1 = time.perf_counter()
            timing = pipe.frame_timings[-1] if pipe.frame_timings else {}
            frames.append(FrameRecord(k, t0, t1, due, host is not None,
                                      host is not None and ok, its,
                                      float(timing.get("preprocessing_time", 0.0))))
            stretch.after(i)
    finally:
        stretch.close()
    t_close = max(time.perf_counter(), t_open + seconds)
    return Window(frames, t_open, t_close, [pipe])

