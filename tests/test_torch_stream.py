"""The port's SVNL log (`svnicp_tpu_torch/io/stream.py`) against the JAX
package's `svnicp_tpu/io/stream.py`, and its native loaders
(`io/native.extract_timestamps`, `read_kitti_bin`) against their plain
versions:

- both writers give identical bytes: `record_synthetic` with and without
  the time field, and every packet of a `record_proxy` loop log (3 frames,
  `path_shape="loop"`, `scan_range=9.0`) re-written from the packets both
  readers give. The two `record_proxy` logs agree in every byte of the
  framing, the IMU packets and the time fields; a point may differ by one
  float32 unit in the last place (the sweep's poses are interpolated in
  float32, and XLA's CPU sin and cos round otherwise than torch's: 3 of
  ~122,000 points here), and every point lies within 1e-6 m;
- each reader reads the other package's logs to identical packets,
  strided records with f4, f8 and u4 time fields and NaN rows included;
- `play` makes the same calls in the same order.
"""

import io

import numpy as np
import pytest

from svnicp_tpu.io import stream as jstream
from svnicp_tpu_torch.io import native as tnative
from svnicp_tpu_torch.io import stream as tstream

LOOP = dict(n_frames=3, path_shape="loop", loop_radius=6.0, scan_range=9.0, seed=3)


@pytest.mark.parametrize("time_field", [True, False])
def test_record_synthetic_bytes_equal(tmp_path, time_field):
    jp, tp = tmp_path / "j.svnl", tmp_path / "t.svnl"
    gj = jstream.record_synthetic(str(jp), n_frames=4, n_points=1500,
                                  with_time_field=time_field)
    gt = tstream.record_synthetic(str(tp), n_frames=4, n_points=1500,
                                  with_time_field=time_field)
    assert jp.read_bytes() == tp.read_bytes()
    np.testing.assert_array_equal(gj, gt)


def _read(mod, data: bytes):
    return list(mod.StreamReader(io.BytesIO(data)))


def _rewrite(mod, packets) -> bytes:
    buf = io.BytesIO()
    w = mod.StreamWriter(buf)
    for p in packets:
        if hasattr(p, "acc"):
            w.write_imu(p.stamp, p.acc, p.gyro)
        else:
            w.write_cloud_xyz(p.stamp, p.points, p.timestamps)
    return buf.getvalue()


@pytest.fixture(scope="module")
def loop_logs(tmp_path_factory):
    d = tmp_path_factory.mktemp("loop")
    gj = jstream.record_proxy(str(d / "j.svnl"), **LOOP)
    gt = tstream.record_proxy(str(d / "t.svnl"), **LOOP)
    return (d / "j.svnl").read_bytes(), (d / "t.svnl").read_bytes(), gj, gt


def test_record_proxy_loop_logs_agree(loop_logs):
    jb, tb, gj, gt = loop_logs
    assert len(jb) == len(tb)
    np.testing.assert_array_equal(gj, gt)
    pj, pt = _read(jstream, jb), _read(tstream, tb)
    assert [type(p).__name__ for p in pj] == [type(p).__name__ for p in pt]
    assert sum(hasattr(p, "points") for p in pj) == 3
    n_pts = n_diff = 0
    for a, b in zip(pj, pt):
        assert a.stamp == b.stamp
        if hasattr(a, "acc"):
            np.testing.assert_array_equal(a.acc, b.acc)
            np.testing.assert_array_equal(a.gyro, b.gyro)
            continue
        assert a.points.shape == b.points.shape
        np.testing.assert_array_equal(a.timestamps, b.timestamps)
        np.testing.assert_allclose(a.points, b.points, rtol=0, atol=1e-6)
        n_diff += int((a.points != b.points).any(axis=1).sum())
        n_pts += len(a.points)
    assert n_diff <= 1e-4 * n_pts, (n_diff, n_pts)


def test_writers_give_identical_bytes_on_the_same_packets(loop_logs):
    """Both writers re-write the same packets (each package's log read by
    each reader) to identical bytes, which read back to the same packets
    (the times are already normalised, so they stay as they are)."""
    jb, tb, _, _ = loop_logs
    for data in (jb, tb):
        for reader in (jstream, tstream):
            packets = _read(reader, data)
            out = _rewrite(tstream, packets)
            assert out == _rewrite(jstream, packets)
            again = _read(tstream, out)
            for a, b in zip(packets, again):
                for x, y in zip(a, b):
                    np.testing.assert_array_equal(x, y)


def _strided_cloud(rng, n, time_dtype, nan_rows):
    """Records of 32 bytes: pad, x at 4, z at 8, y at 16, the time at 20
    (f4, u4) or 24 (f8), intensity bytes between."""
    step = 32
    rec = np.zeros((n, step), np.uint8)
    xyz = rng.normal(scale=10.0, size=(n, 3)).astype("<f4")
    xyz[nan_rows, 1] = np.nan
    rec[:, 4:8] = xyz[:, 0:1].view(np.uint8)
    rec[:, 8:12] = xyz[:, 2:3].view(np.uint8)
    rec[:, 16:20] = xyz[:, 1:2].view(np.uint8)
    off = 24 if time_dtype == "f8" else 20
    if time_dtype == "f8":
        t = 1.7e9 + rng.uniform(0.0, 0.1, n)           # epoch stamps
    elif time_dtype == "u4":
        t = rng.integers(0, 100_000, n)
    else:
        t = rng.uniform(-0.05, 0.05, n)
    t = np.asarray(t, "<" + time_dtype)
    t[nan_rows] = 0                                     # garbage stamps on NaN rows
    width = t.dtype.itemsize
    rec[:, off:off + width] = t.reshape(n, 1).view(np.uint8)
    rec[:, 28:32] = 7
    return rec, step, (4, 16, 8), off


@pytest.mark.parametrize("time_dtype", ["f4", "f8", "u4"])
def test_readers_read_each_others_strided_logs(time_dtype):
    rng = np.random.default_rng(11)
    nan_rows = np.array([3, 17, 18, 400])
    rec, step, off_xyz, off_t = _strided_cloud(rng, 600, time_dtype, nan_rows)
    logs = []
    for mod in (jstream, tstream):
        buf = io.BytesIO()
        w = mod.StreamWriter(buf)
        w.write_imu(0.01, [0.1, 0.2, 9.8], [0.0, 0.01, -0.02])
        w.write_cloud(0.05, rec, 600, step, off_xyz, off_t, time_dtype)
        w.write_cloud(0.15, rec[:5], 5, step, off_xyz, -1)
        logs.append(buf.getvalue())
    assert logs[0] == logs[1]
    for reader in (jstream, tstream):
        pj = _read(jstream, logs[0])
        pt = _read(reader, logs[1])
        assert len(pj) == len(pt) == 3
        cj, ct = pj[1], pt[1]
        assert ct.points.shape == (600 - len(nan_rows), 3)
        np.testing.assert_array_equal(cj.points, ct.points)
        np.testing.assert_array_equal(cj.timestamps, ct.timestamps)
        assert ct.timestamps.min() == 0.0 and ct.timestamps.max() == 1.0
        assert pt[2].timestamps is None
        np.testing.assert_array_equal(pj[0].acc, pt[0].acc)


@pytest.mark.parametrize("time_dtype", ["f4", "f8", "u4"])
def test_extract_timestamps_native_equals_plain(time_dtype):
    rng = np.random.default_rng(3)
    rec, step, _, off_t = _strided_cloud(rng, 257, time_dtype, np.array([], int))
    got, ok = tnative.extract_timestamps(rec.tobytes(), 257, step, off_t, time_dtype)
    want, ok_p = tnative.extract_timestamps_numpy(rec.tobytes(), 257, step, off_t,
                                                  time_dtype)
    assert ok and ok_p
    np.testing.assert_array_equal(got, want)
    flat = np.zeros((4, 8), np.uint8)
    assert not tnative.extract_timestamps(flat.tobytes(), 4, 8, 0, "f4")[1]
    with pytest.raises(KeyError):
        tnative.extract_timestamps(flat.tobytes(), 4, 8, 0, "i2")


def test_read_kitti_bin_native_equals_plain(tmp_path):
    pts = np.random.default_rng(0).normal(size=(5000, 4)).astype(np.float32)
    path = tmp_path / "000000.bin"
    pts.tofile(path)
    got = tnative.read_kitti_bin(str(path))
    np.testing.assert_array_equal(got, tnative.read_kitti_bin_numpy(str(path)))
    np.testing.assert_array_equal(got, pts[:, :3])
    np.testing.assert_array_equal(tnative.read_kitti_bin(str(path), capacity=100),
                                  pts[:100, :3])
    with pytest.raises(IOError):
        tnative.read_kitti_bin(str(tmp_path / "missing.bin"))


class _Recorder:
    def __init__(self):
        self.calls = []

    def feed_imu(self, t, acc, gyro):
        self.calls.append(("imu", t, np.asarray(acc).tobytes(), np.asarray(gyro).tobytes()))

    def feed_scan(self, t, points, timestamps=None):
        self.calls.append(("scan", t, points.tobytes(),
                           None if timestamps is None else timestamps.tobytes()))

    def flush(self):
        self.calls.append(("flush",))


def test_play_makes_the_same_calls(tmp_path):
    log = tmp_path / "s.svnl"
    tstream.record_synthetic(str(log), n_frames=5, n_points=800)
    rec_j, rec_t = _Recorder(), _Recorder()
    seen = []
    with open(log, "rb") as f:
        nj = jstream.play(rec_j, f)
    with open(log, "rb") as f:
        nt = tstream.play(rec_t, f, progress=lambda n, s: seen.append((n, s)))
    assert nj == nt == 5
    assert rec_j.calls == rec_t.calls
    assert rec_t.calls[-1] == ("flush",)
    assert [n for n, _ in seen] == [1, 2, 3, 4, 5]


def test_bad_logs_raise():
    with pytest.raises(ValueError, match="magic"):
        tstream.StreamReader(io.BytesIO(b"NOPE!"))
    buf = io.BytesIO()
    tstream.StreamWriter(buf).write_imu(0.0, [0, 0, 0], [0, 0, 0])
    with pytest.raises(ValueError, match="truncated"):
        list(tstream.StreamReader(io.BytesIO(buf.getvalue()[:-3])))
    with pytest.raises(ValueError, match="records carry"):
        tstream.StreamWriter(io.BytesIO()).write_cloud(0.0, b"\0" * 10, 1, 12)
