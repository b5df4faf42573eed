"""Build the CUDA kernels with nvcc by hand and load them with ctypes.

Each source under `svnicp_tpu_torch/csrc/*.cu` becomes its own shared
library with a plain C interface, compiled for sm_90a (`-gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`). No source
includes PyTorch's headers, so a build takes seconds where
`torch.utils.cpp_extension.load` takes minutes. Libraries land in
`build/svnicp_tpu_torch/` at the root of the checkout, named by a hash of
their sources and flags, and are built at first use: the first launch of
any kernel builds all of them, one nvcc process per source, all at once.

Every C entry point takes its pointers as `void*` (ctypes.c_void_p), sizes
as int, the CUDA stream last, launches on that stream without
synchronizing, and returns `cudaGetLastError()`; `check` raises on a
nonzero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "svnicp_tpu_torch"
CUDA_SOURCES = ("stage1.cu", "plane_moments.cu", "point_moments.cu", "stein.cu",
                "nn_match.cu", "eskf_propagate.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argument types of every exported entry (pointers and the stream as void*)
SIGNATURES = {
    "stage1.cu": {"svn_stage1_candidates": [_P] * 4 + [_I] * 5 + [_P] * 4},
    "plane_moments.cu": {"svn_plane_moments": [_P] * 6 + [_I] * 3 + [_F] + [_P] * 4},
    "point_moments.cu": {"svn_point_moments": [_P] * 5 + [_I] * 3 + [_F] + [_P] * 4},
    "stein.cu": {"svn_stein_update": [_P] * 5 + [_I, _F] + [_P] * 4},
    "nn_match.cu": {"svn_nn_match": [_P] * 3 + [_I] * 3 + [_P] * 3},
    "eskf_propagate.cu": {"svn_eskf_propagate": [_P] * 7 + [_I] * 3 + [_P] * 2},
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# source -> nvcc's output with the ptxas register/spill report (kept beside
# each library, so a later process that loads it reads the same report)
build_log: dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are "
                       "built on the machine that has the card")


def _digest(paths, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for p in paths:
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _out_path(src: str) -> Path:
    deps = [CSRC / src, *sorted(CSRC.glob("*.cuh"))]
    return BUILD_DIR / f"{Path(src).stem}-{_digest(deps, NVCC_FLAGS)}.so"


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every CUDA source not built yet (in parallel) and load all.
    Raises when nvcc fails, with its output."""
    with _lock:
        if len(_libs) == len(CUDA_SOURCES):
            return _libs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for src in CUDA_SOURCES:
            out = _out_path(src)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                   str(CSRC / src)]
            procs[src] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True),
                          tmp, out)
        failed = []
        for src, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            build_log[src] = log
            if proc.returncode != 0:
                failed.append(f"{src}:\n{log}")
            else:
                out.with_suffix(".log").write_text(log)
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        for src in CUDA_SOURCES:
            saved = _out_path(src).with_suffix(".log")
            if src not in build_log and saved.exists():
                build_log[src] = saved.read_text()
            lib = ctypes.CDLL(str(_out_path(src)))
            for name, argtypes in SIGNATURES[src].items():
                getattr(lib, name).restype = ctypes.c_int
                getattr(lib, name).argtypes = argtypes
            lib.svn_cuda_error_string.restype = ctypes.c_char_p
            lib.svn_cuda_error_string.argtypes = [ctypes.c_int]
            _libs[src] = lib
        return _libs


_count_lock = threading.Lock()


def count_launch(wrapper, n: int = 1) -> None:
    """Add n (one launch by default) to `wrapper.launches`. The shards of an
    in-process mesh run on threads of their own; the mesh's baton lets one
    run at a time, and the lock keeps the count exact should a caller launch
    from threads of its own."""
    with _count_lock:
        wrapper.launches += n


def library(src: str) -> ctypes.CDLL:
    """The loaded library built from `csrc/<src>` (building all at first use)."""
    return build_all()[src]


def check(err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err != 0:
        msg = next(iter(_libs.values())).svn_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def require_cuda_f32(name: str, *tensors) -> None:
    """The kernels take contiguous float32 CUDA tensors on one device (bool
    masks as 1-byte elements); anything else raises, nothing falls back."""
    import torch

    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: argument {i} is on {t.device}; the kernel "
                             f"takes CUDA tensors on one device")
        if t.dtype not in (torch.float32, torch.bool):
            raise TypeError(f"{name}: argument {i} is {t.dtype}; the kernel "
                            f"takes float32 (and bool masks)")
        if not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} is not contiguous")
