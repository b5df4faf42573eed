"""Host-side ingest and staging for LIOPipeline.

Port of `svnicp_tpu/runtime/ingest.py`: the IMU window bookkeeping, the
raw-scan staging (`_pack_frame`, with per-point sweep times), the
host-preprocessed staging (crop + stage-A downsample in native code,
`_stage_scan_pre_untimed`, carrying the kept rows' sweep times when the
step deskews), the int16 upload of either (`quantize`), and the
stage-ahead pair that runs frame k's staging on one worker thread while
frame k-1 is dispatched (the native calls release the GIL). Every staging
route packs the frame's IMU window on the calling thread when the frame is
staged, as the JAX package does, and hands it to the step with the scan.
`run_threaded` feeds scans from a producer thread through the native
lock-free ring (`io/native.ScanRing`). The dispatch half stays in
`runtime/pipeline.py`.
"""

from __future__ import annotations

import concurrent.futures
import sys
import threading
import time
from typing import NamedTuple

import numpy as np

from svnicp_tpu_torch.io import native
from svnicp_tpu_torch.runtime import profiling


def quantize(buf: np.ndarray) -> np.ndarray:
    """preprocess.quantize_upload: rows on the 2^-8 m int16 grid, clipped at
    +-128 m. A time column rides the same grid and clips at 127.996, as in
    the JAX package (`runtime/ingest.py:84`); the step dequantizes."""
    return np.clip(np.round(buf * 256.0), -32768, 32767).astype(np.int16)


class ImuWindow(NamedTuple):
    """One frame's IMU samples, packed as the JAX package packs them."""

    buf: np.ndarray   # [W,7] dt + acc + gyro, the first `count` rows valid
    count: int
    dropped: int      # oldest samples the window could not hold


class IngestDriver:
    """Mixin of LIOPipeline; its host attributes are set in
    LIOPipeline.__init__."""

    def feed_imu(self, t: float, acc, gyro) -> None:
        dt = 0.0 if self._last_imu_time is None else t - self._last_imu_time
        self._last_imu_time = t
        self._imu_samples.append((dt, np.asarray(acc, np.float64),
                                  np.asarray(gyro, np.float64)))
        self._imu_times.append(t)

    def _take_imu_window(self, t_frame: float):
        """Consume the (dt, acc, gyro) samples up to t_frame, synthesizing
        the interpolated boundary sample (ref: OdometryPipeline.cpp:502-513)."""
        out = []
        times, samples = self._imu_times, self._imu_samples
        n_used = 0
        for i, t in enumerate(times):
            if t <= t_frame:
                out.append(samples[i])
                n_used = i + 1
                continue
            prev_t = times[i - 1] if i > 0 else None
            if prev_t is not None and prev_t < t_frame < t:
                gap, off = t - prev_t, t_frame - prev_t
                ratio = off / gap
                acc = (1 - ratio) * samples[i - 1][1] + ratio * samples[i][1]
                gyro = (1 - ratio) * samples[i - 1][2] + ratio * samples[i][2]
                out.append((off, acc, gyro))
                samples[i] = (gap - off, samples[i][1], samples[i][2])
            break
        del times[:n_used]
        del samples[:n_used]
        return out

    def _pack_imu(self, t: float) -> ImuWindow:
        """The samples up to `t` as an ImuWindow: a window longer than
        `imu_window` drops (and counts) its oldest samples."""
        w = self.imu_window
        window = self._take_imu_window(t)
        n_drop = max(len(window) - w, 0)
        if n_drop:
            self.imu_dropped_total += n_drop
            print(f"[svnicp] WARNING: IMU window overflow at t={t:.3f}: "
                  f"dropped {n_drop} oldest samples (window={w})",
                  file=sys.stderr)
        triples = window[-w:]
        imu_buf = np.zeros((w, 7), self.cfg.np_dtype)
        for i, (dt, a, g) in enumerate(triples):
            imu_buf[i, 0] = dt
            imu_buf[i, 1:4] = a
            imu_buf[i, 4:7] = g
        return ImuWindow(imu_buf, len(triples), n_drop)

    def _apply_extrinsic(self, points: np.ndarray) -> np.ndarray:
        """lidar -> IMU extrinsic at ingest (ref: OdometryPipeline.cpp:349)."""
        r_ext = np.asarray(self.cfg.lio.extrinsic_R, np.float32).reshape(3, 3)
        t_ext = np.asarray(self.cfg.lio.extrinsic_t, np.float32)
        if np.allclose(r_ext, np.eye(3)) and np.allclose(t_ext, 0.0):
            return points
        return np.asarray(points, np.float32) @ r_ext.T + t_ext

    def _pack_frame(self, t: float, points: np.ndarray, timestamps=None):
        """Raw staging (bootstrap frame, and every frame without
        host_downsample): native crop + pad into raw_capacity rows ->
        (scan [cap,3], n_points, ImuWindow). With per-point timestamps the
        first raw_capacity rows are padded uncropped, in their order, with
        the time as a 4th column (scan [cap,4]): the crop runs on the device
        after deskew, as in the JAX package. With quantize_upload the rows
        are int16 (`quantize`)."""
        cap = self.cfg.preprocess.raw_capacity
        pp = self.cfg.preprocess
        with self.timer.span("preprocess"):
            points = self._apply_extrinsic(points)
            if timestamps is None:
                rows, _, n = native.stage_scan(points, pp.min_range,
                                               pp.max_range, cap)
                rows, n = rows.astype(self.cfg.np_dtype, copy=False), min(int(n), cap)
            else:
                n = min(len(points), cap)
                rows = np.zeros((cap, 4), self.cfg.np_dtype)
                rows[:n, :3] = points[:n]
                rows[:n, 3] = np.asarray(timestamps[:n])
            if pp.quantize_upload:
                rows = quantize(rows)
        return rows, n, self._pack_imu(t)

    def _stage_scan_pre_untimed(self, points: np.ndarray, timestamps=None):
        """Native crop + the stage-A (0.5 voxel) downsample -> (to_map rows
        [2*source_capacity,3], count); with per-point `timestamps` the kept
        rows' times as a 4th column, for the device deskew; int16 rows with
        quantize_upload. Pure, so it runs on the worker."""
        pp = self.cfg.preprocess
        pts, ts, n = native.stage_scan_ts(self._apply_extrinsic(points), timestamps,
                                          pp.min_range, pp.max_range, pp.raw_capacity)
        map_buf, map_ts, n_map = native.downsample_one_stage_ts(
            pts[:n], None if ts is None else ts[:n], 0.5 * pp.voxel_size,
            2 * self.cfg.icp.source_capacity)
        if map_ts is not None:
            map_buf = np.concatenate([map_buf, map_ts[:, None]], axis=1)
        if pp.quantize_upload:
            return quantize(map_buf), n_map
        return map_buf.astype(self.cfg.np_dtype, copy=False), n_map

    def _pack_frame_pre(self, t: float, points: np.ndarray, timestamps=None):
        with self.timer.span("preprocess"):
            ds_buf, n_map = self._stage_scan_pre_untimed(points, timestamps)
        return ds_buf, n_map, self._pack_imu(t)

    def _timed_stage_pre(self, points, timestamps, frame_idx: int):
        """Worker-thread staging timed by its own span (not the pipeline's
        StageTimer), so preprocessing time is attributed to the right
        frame."""
        with profiling.Span(profiling.STAGE_SPANS["preprocess"], frame=frame_idx) as s:
            out = self._stage_scan_pre_untimed(points, timestamps)
        return out, s.seconds

    def _feed_scan_ahead(self, t: float, points: np.ndarray, timestamps,
                         init_particles):
        """Submit frame t's staging (points with their times, if any) to the
        worker and dispatch the frame staged before it (one frame of output
        latency; flush() drains)."""
        if self._stage_pool is None:
            self._stage_pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="svnicp-stage")
        imu = self._pack_imu(t)
        idx = self._frames
        fut = self._stage_pool.submit(self._timed_stage_pre, points, timestamps, idx)
        self._frames += 1
        self._last_frame_time = t
        self._pending.append((t, imu, fut, idx, init_particles))
        if len(self._pending) > 1:
            return self._dispatch_pending()
        return None

    def _dispatch_pending(self):
        t, imu, fut, idx, init_particles = self._pending.pop(0)
        (ds_buf, n_map), pre_dt = fut.result()
        out = self._dispatch_pre(t, ds_buf, n_map, imu, idx, init_particles)
        self.outputs.append(out)
        self.times.append(t)
        self.frame_timings.append({
            "preprocessing_time": pre_dt,
            "steinicp_time": self.timer.last.get("dispatch", 0.0),
        })
        self._maybe_rebalance()
        return out

    def run_threaded(self, scan_stream, ring_slots: int = 16) -> int:
        """Consume an iterator of (t, points) through a producer thread and
        the native SPSC ring (`ScanRing`, slots of preprocess.raw_capacity
        points), running `feed_scan` on the calling thread as scans arrive;
        then `flush()`. The executor topology of the reference (sensor
        callbacks on their own threads feeding the ICP worker through ring
        buffers, ref: SVNICPNode.cpp:24-25, OdometryPipeline.cpp:106-110):
        the producer only iterates the stream and pushes, retrying while the
        ring is full, so no scan is dropped. An error in the stream is
        raised here. Returns the number of frames processed."""
        ring = native.ScanRing(slots=ring_slots,
                               max_points=self.cfg.preprocess.raw_capacity)
        done = threading.Event()
        failed: list[BaseException] = []

        def producer():
            try:
                for t, pts in scan_stream:
                    if done.is_set():    # the consumer stopped
                        return
                    pts = np.asarray(pts, np.float32)
                    while not ring.push(pts, float(t)):
                        if done.wait(0.001):
                            return
            except BaseException as e:   # handed to the consuming thread
                failed.append(e)
            finally:
                done.set()

        worker = threading.Thread(target=producer, name="svnicp-ingest",
                                  daemon=True)
        worker.start()
        n0 = len(self.outputs)
        try:
            while True:
                item = ring.pop()
                if item is None:
                    if done.is_set() and len(ring) == 0:
                        break
                    time.sleep(0.0005)
                    continue
                pts, t = item
                self.feed_scan(t, pts)
            if failed:
                raise failed[0]
            # staged-ahead or batched frames may still be pending
            self.flush()
        finally:
            done.set()
            worker.join()
        return len(self.outputs) - n0
