"""Host frame staging: range crop + pad, and one uniform-downsample stage
(or both stages), each also carrying per-point sweep times; the KITTI .bin
reader and the per-point time field of a log's point records; and
`ScanRing`, the lock-free scan queue of the threaded ingest.

ctypes bindings for `csrc/host_staging.cpp`, the port's own copy of the
host functions of `native/svnicp_native.cpp` the odometry path, the
readers and the threaded ingest call. The
library is built with g++ into `build/svnicp_tpu_torch/` at first use (the
JAX package's flags, so both produce the same bytes); if it cannot be
built, the staging functions raise. The numpy versions beside them compute
the same selection and order and are the tests' plain versions.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from svnicp_tpu_torch.kernels._build import BUILD_DIR, CSRC

_SOURCE = CSRC / "host_staging.cpp"
_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-march=native",
          "-shared"]
_lock = threading.Lock()
_lib = None


def library() -> ctypes.CDLL:
    """The staging library, built with g++ on first call. Raises on failure."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(_SOURCE.read_bytes()
                                + " ".join(_FLAGS).encode()).hexdigest()[:16]
        path = BUILD_DIR / f"libhost_staging-{digest}.so"
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(
                [os.environ.get("CXX", "g++"), *_FLAGS, "-o", str(tmp),
                 str(_SOURCE)], capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"building {_SOURCE.name} failed:\n"
                                   f"{proc.stdout}{proc.stderr}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path))
        fptr = ctypes.POINTER(ctypes.c_float)
        lib.svn_stage_scan.restype = ctypes.c_int
        lib.svn_stage_scan.argtypes = [
            fptr, ctypes.c_int, ctypes.c_float, ctypes.c_float, fptr,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        lib.svn_downsample_one_stage.restype = ctypes.c_int
        lib.svn_downsample_one_stage.argtypes = [
            fptr, ctypes.c_int, ctypes.c_float, fptr, ctypes.c_int]
        lib.svn_stage_scan_ts.restype = ctypes.c_int
        lib.svn_stage_scan_ts.argtypes = [
            fptr, fptr, ctypes.c_int, ctypes.c_float, ctypes.c_float, fptr,
            fptr, ctypes.c_int]
        lib.svn_downsample_one_stage_ts.restype = ctypes.c_int
        lib.svn_downsample_one_stage_ts.argtypes = [
            fptr, fptr, ctypes.c_int, ctypes.c_float, fptr, fptr, ctypes.c_int]
        lib.svn_read_kitti_bin.restype = ctypes.c_int
        lib.svn_read_kitti_bin.argtypes = [ctypes.c_char_p, fptr, ctypes.c_int]
        lib.svn_extract_timestamps.restype = ctypes.c_int
        lib.svn_extract_timestamps.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, fptr]
        iptr = ctypes.POINTER(ctypes.c_int)
        lib.svn_downsample_two_stage.restype = None
        lib.svn_downsample_two_stage.argtypes = [
            fptr, ctypes.c_int, ctypes.c_float, fptr, ctypes.c_int, iptr, fptr,
            ctypes.c_int, iptr]
        lib.svn_ring_create.restype = ctypes.c_void_p
        lib.svn_ring_create.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.svn_ring_destroy.restype = None
        lib.svn_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.svn_ring_size.restype = ctypes.c_int
        lib.svn_ring_size.argtypes = [ctypes.c_void_p]
        lib.svn_ring_push.restype = ctypes.c_int
        lib.svn_ring_push.argtypes = [ctypes.c_void_p, fptr, ctypes.c_int,
                                      ctypes.c_double]
        lib.svn_ring_pop.restype = ctypes.c_int
        lib.svn_ring_pop.argtypes = [ctypes.c_void_p, fptr,
                                     ctypes.POINTER(ctypes.c_double)]
        _lib = lib
        return lib


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def stage_scan(xyz: np.ndarray, min_range: float, max_range: float,
               capacity: int) -> tuple[np.ndarray, np.ndarray, int]:
    """Crop by range and pad -> (padded [capacity,3] f32, valid, count)."""
    lib = library()
    xyz = np.ascontiguousarray(xyz, np.float32)
    out = np.empty((capacity, 3), np.float32)
    valid = np.empty(capacity, np.uint8)
    n = lib.svn_stage_scan(_fptr(xyz), len(xyz), min_range, max_range,
                           _fptr(out),
                           valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                           capacity)
    return out, valid.astype(bool), n


def downsample_one_stage(xyz: np.ndarray, voxel: float, capacity: int
                         ) -> tuple[np.ndarray, int]:
    """One uniform-downsample stage -> ([capacity,3] zero-padded, count)."""
    lib = library()
    xyz = np.ascontiguousarray(xyz, np.float32)
    out = np.zeros((capacity, 3), np.float32)
    n = lib.svn_downsample_one_stage(_fptr(xyz), len(xyz), voxel, _fptr(out),
                                     capacity)
    return out, n


def _times(ts, capacity):
    """(contiguous float32 times, their output buffer), or (None, None)."""
    if ts is None:
        return None, None
    return np.ascontiguousarray(ts, np.float32), np.zeros(capacity, np.float32)


def _optr(a):
    return None if a is None else _fptr(a)


def stage_scan_ts(xyz: np.ndarray, ts: np.ndarray | None, min_range: float,
                  max_range: float, capacity: int
                  ) -> tuple[np.ndarray, np.ndarray | None, int]:
    """`stage_scan` carrying per-point times (same selection and order) ->
    (padded [capacity,3] f32, padded times [capacity] f32, count); with ts
    None the times are None."""
    lib = library()
    xyz = np.ascontiguousarray(xyz, np.float32)
    ts, out_ts = _times(ts, capacity)
    out = np.empty((capacity, 3), np.float32)
    n = lib.svn_stage_scan_ts(_fptr(xyz), _optr(ts), len(xyz), min_range,
                              max_range, _fptr(out), _optr(out_ts), capacity)
    return out, out_ts, n


def downsample_one_stage_ts(xyz: np.ndarray, ts: np.ndarray | None, voxel: float,
                            capacity: int
                            ) -> tuple[np.ndarray, np.ndarray | None, int]:
    """`downsample_one_stage` carrying the kept rows' times -> ([capacity,3]
    and [capacity] zero-padded, count); with ts None the times are None."""
    lib = library()
    xyz = np.ascontiguousarray(xyz, np.float32)
    ts, out_ts = _times(ts, capacity)
    out = np.zeros((capacity, 3), np.float32)
    n = lib.svn_downsample_one_stage_ts(_fptr(xyz), _optr(ts), len(xyz), voxel,
                                        _fptr(out), _optr(out_ts), capacity)
    return out, out_ts, n


def downsample_two_stage(xyz: np.ndarray, voxel: float, src_capacity: int,
                         map_capacity: int
                         ) -> tuple[np.ndarray, int, np.ndarray, int]:
    """Both downsample stages: to_map = one stage of the input at
    0.5 * voxel, source = one stage of to_map at 1.5 * voxel -> (map rows
    [map_capacity,3] zero-padded, n_map, source rows [src_capacity,3]
    zero-padded, n_src)."""
    lib = library()
    xyz = np.ascontiguousarray(xyz, np.float32)
    out_map = np.zeros((map_capacity, 3), np.float32)
    out_src = np.zeros((src_capacity, 3), np.float32)
    n_map, n_src = ctypes.c_int(), ctypes.c_int()
    lib.svn_downsample_two_stage(_fptr(xyz), len(xyz), voxel, _fptr(out_map),
                                 map_capacity, ctypes.byref(n_map),
                                 _fptr(out_src), src_capacity, ctypes.byref(n_src))
    return out_map, n_map.value, out_src, n_src.value


class ScanRing:
    """Lock-free single-producer single-consumer queue of scans (the
    threaded ingest's), `slots` scans of at most `max_points` points each,
    in the native library. A full ring refuses a push (returns False: the
    producer retries), and a longer scan keeps its first `max_points`
    points."""

    def __init__(self, slots: int = 16, max_points: int = 1 << 17):
        self._lib = library()
        self._max_points = max_points
        self._h = self._lib.svn_ring_create(slots, max_points * 3)

    def push(self, xyz: np.ndarray, stamp: float) -> bool:
        xyz = np.ascontiguousarray(xyz, np.float32)
        return bool(self._lib.svn_ring_push(self._h, _fptr(xyz), len(xyz), stamp))

    def pop(self) -> tuple[np.ndarray, float] | None:
        """The oldest scan and its stamp, or None when the ring is empty."""
        out = np.empty((self._max_points, 3), np.float32)
        stamp = ctypes.c_double()
        n = self._lib.svn_ring_pop(self._h, _fptr(out), ctypes.byref(stamp))
        if n < 0:
            return None
        return out[:n], stamp.value

    def __len__(self) -> int:
        return self._lib.svn_ring_size(self._h)

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.svn_ring_destroy(self._h)
            self._h = None


class ScanRingNumpy:
    """Plain version of `ScanRing`, with its semantics: a full ring refuses
    the push and a scan is cut to the slot. (The JAX package's fallback
    for a missing library drops the oldest scan instead, which loses frames
    under a lagging consumer; this one does not.)"""

    def __init__(self, slots: int = 16, max_points: int = 1 << 17):
        self._slots = slots
        self._max_points = max_points
        self._queue: collections.deque = collections.deque()
        self._lock = threading.Lock()

    def push(self, xyz: np.ndarray, stamp: float) -> bool:
        scan = np.array(np.asarray(xyz, np.float32)[: self._max_points])
        with self._lock:
            if len(self._queue) >= self._slots:
                return False
            self._queue.append((scan, float(stamp)))
            return True

    def pop(self) -> tuple[np.ndarray, float] | None:
        with self._lock:
            return self._queue.popleft() if self._queue else None

    def __len__(self) -> int:
        with self._lock:
            return len(self._queue)


_TIME_CODES = {"f4": 0, "f8": 1, "u4": 2}


def read_kitti_bin(path: str, capacity: int = 1 << 18) -> np.ndarray:
    """[N,3] float32 from a KITTI velodyne .bin (intensity dropped), at
    most `capacity` points."""
    lib = library()
    out = np.empty((capacity, 3), np.float32)
    n = lib.svn_read_kitti_bin(os.fsencode(path), _fptr(out), capacity)
    if n < 0:
        raise IOError(f"cannot read {path}")
    return out[:n]


def extract_timestamps(data: bytes | np.ndarray, n: int, stride: int,
                       offset: int, dtype: str) -> tuple[np.ndarray, bool]:
    """Per-point times of n interleaved records (`stride` bytes each, an
    f4, f8 or u4 field at `offset`), min-max normalised -> ([n] f32, ok);
    ok is False when every time is equal."""
    lib = library()
    buf = np.frombuffer(data, np.uint8) if isinstance(data, bytes) else data
    buf = np.ascontiguousarray(buf)
    out = np.empty(n, np.float32)
    ok = lib.svn_extract_timestamps(
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n, stride, offset,
        _TIME_CODES[dtype], _fptr(out))
    if ok < 0:
        raise ValueError(f"bad time dtype {dtype}")
    return out, bool(ok)


def read_kitti_bin_numpy(path: str, capacity: int = 1 << 18) -> np.ndarray:
    """Plain version of `read_kitti_bin`."""
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return np.ascontiguousarray(raw[:capacity, :3])


def extract_timestamps_numpy(data, n, stride, offset, dtype):
    """Plain version of `extract_timestamps`."""
    buf = np.frombuffer(data, np.uint8) if isinstance(data, bytes) else data
    rec = np.dtype({"names": ["t"], "formats": ["<" + dtype], "offsets": [offset],
                    "itemsize": stride})
    vals = np.ascontiguousarray(buf)[: n * stride].view(rec)["t"].astype(np.float64)
    if n == 0 or not vals.max() > vals.min():
        return np.empty(n, np.float32), False
    mn = vals.min()
    return ((vals - mn) * (1.0 / (vals.max() - mn))).astype(np.float32), True


def downsample_two_stage_numpy(xyz, voxel, src_capacity, map_capacity):
    """Plain version of `downsample_two_stage` (the stage voxels scaled in
    float32, as the native code scales them)."""
    v = np.float32(voxel)
    out_map, n_map = downsample_one_stage_numpy(xyz, np.float32(0.5) * v,
                                                map_capacity)
    out_src, n_src = downsample_one_stage_numpy(out_map[:n_map], np.float32(1.5) * v,
                                                src_capacity)
    return out_map, n_map, out_src, n_src


def _stage_keep(xyz, min_range, max_range):
    d2 = (xyz * xyz).sum(1)
    return (d2 > np.float32(min_range) ** 2) & (d2 < np.float32(max_range) ** 2) \
        & np.isfinite(d2)


def stage_scan_numpy(xyz, min_range, max_range, capacity):
    """Plain version of `stage_scan`."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    pts = xyz[_stage_keep(xyz, min_range, max_range)][:capacity]
    out = np.zeros((capacity, 3), np.float32)
    out[: len(pts)] = pts
    valid = np.arange(capacity) < len(pts)
    return out, valid, len(pts)


def stage_scan_ts_numpy(xyz, ts, min_range, max_range, capacity):
    """Plain version of `stage_scan_ts`."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    ts = np.ascontiguousarray(ts, np.float32)
    keep = _stage_keep(xyz, min_range, max_range)
    pts, tt = xyz[keep][:capacity], ts[keep][:capacity]
    out = np.zeros((capacity, 3), np.float32)
    out_ts = np.zeros(capacity, np.float32)
    out[: len(pts)] = pts
    out_ts[: len(pts)] = tt
    return out, out_ts, len(pts)


def downsample_one_stage_numpy(xyz, voxel, capacity):
    """Plain version of `downsample_one_stage`: same selection and order."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    sel = _downsample_indices(xyz, voxel, capacity)
    out = np.zeros((capacity, 3), np.float32)
    out[: len(sel)] = xyz[sel]
    return out, len(sel)


def downsample_one_stage_ts_numpy(xyz, ts, voxel, capacity):
    """Plain version of `downsample_one_stage_ts`."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    ts = np.ascontiguousarray(ts, np.float32)
    sel = _downsample_indices(xyz, voxel, capacity)
    out = np.zeros((capacity, 3), np.float32)
    out_ts = np.zeros(capacity, np.float32)
    out[: len(sel)] = xyz[sel]
    out_ts[: len(sel)] = ts[sel]
    return out, out_ts, len(sel)


def _downsample_indices(xyz, voxel, capacity):
    """The rows one downsample stage keeps, in output order."""
    if len(xyz) == 0:
        return np.zeros(0, np.int64)
    bits, mask, half = 10, (1 << 10) - 1, 1 << 9
    g = np.floor(xyz / np.float32(voxel)).astype(np.int64)
    key = ((((g[:, 0] + half) & mask) << (2 * bits))
           | (((g[:, 1] + half) & mask) << bits) | ((g[:, 2] + half) & mask))
    key = key.astype(np.int32)
    center = (np.floor(xyz / np.float32(voxel)) + 0.5) * np.float32(voxel)
    d = ((xyz - center) ** 2).sum(1).astype(np.float32)
    order = np.lexsort((np.arange(len(xyz)), d, key))
    skey = key[order]
    first = np.concatenate([[True], skey[1:] != skey[:-1]])
    sel = order[first]
    x = key[sel].astype(np.uint32)
    x ^= x >> 16
    x = (x * np.uint32(0x7FEB352D)) & np.uint32(0xFFFFFFFF)
    x ^= x >> 15
    x = (x * np.uint32(0x846CA68B)) & np.uint32(0xFFFFFFFF)
    x ^= x >> 16
    rank = (x & np.uint32(0xFFFFFFFE)).astype(np.int32)
    return sel[np.lexsort((key[sel], rank))][:capacity]
