#!/usr/bin/env python3
"""Where the time goes inside the port's B2, B3 and B4 kernels, on one NVIDIA GPU.

    python3 tools/torch_kernel_phases.py

Copies `svnicp_tpu_torch/csrc/stein.cu`, `plane_moments.cu` and
`point_moments.cu` into
`build/kernel_phases/`, inserts a `clock64()` stamp at each phase boundary
(thread 0 of block 0; every stamp but the last follows a block barrier, so
it marks when the whole block finished the phase before), builds the copies
with the port's nvcc flags and runs them on chip_smoke.py's operands: B3 at
P=10 and P=64 (random SPD ensembles), B2 at the main path's shapes (P=64,
B=4096, K=32, the synthetic tie operands), B4 at the GEODE-Alpha path's
shapes (P=10, B=4096, K=104) and configs/subt_mrs.yaml's (P=30, B=8192,
K=104), on the same synthetic operands. Prints the cycles of each phase
(median over 50 launches) and the kernel's device time from torch.profiler,
with the card's SM clock and power limit. The instrumented copies are
measurement aids only; the port never loads them. Fails when an anchor is
not found in a source, so the phases follow the sources as they change.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "build", "kernel_phases")
STAMP = ("if (threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0) "
         "g_clk[{n}] = clock64();\n")
HEADER = ('#include "common.cuh"\n__device__ unsigned long long g_clk[16];\n'
          'SVN_EXPORT int probe_clocks(void* out) {\n'
          '  return static_cast<int>(cudaMemcpyFromSymbol(out, g_clk, sizeof(g_clk)));\n}\n')

# source -> [(phase name, anchor, insert before (True) or after the anchor,
#             [condition of a stamp inside a loop])]
PHASES = {
    "stein.cu": [
        ("start", "  const bool store = P <= kStoreMaxP;\n", False),
        ("stage operands", "  // 1. per particle", True),
        ("solve, so3_log", "  // 2. h_mean", True),
        ("h_mean, centring", "  // 3. exact lower median", True),
        ("pass 0 count", "    if (tid == 0 && prefix == 0u) atomicAdd(&hcur[0]", True, "d == 0"),
        ("pass 0 barrier", "    unsigned cnt[8], tot = 0u;", True, "d == 0"),
        ("pass 0 scan", "    rank = __shfl_sync(0xFFFFFFFFu, r, owner);\n", False, "d == 0"),
        ("passes 1-3", "  const float med = __uint_as_float(prefix);", True),
        ("kernel rows", "  // 5. per particle", True),
        ("repulsion, pose update", "  // 6. exit statistics", True),
        ("exit sums", "    stats[1] = sqrtf(m2);\n  }\n", False),
    ],
    "plane_moments.cu": [
        ("start", "  const int p0 = blockIdx.y * kGroup;\n", False),
        ("first chunk arrives", "    const float* st = smem + (ch % kStages) * kStage", True,
         "ch == 0"),
        ("scores, minima", "  // moments: over the lane's", True),
        ("moments, warp sums", "  for (int e = threadIdx.x; e < kMom * kGroup; e += kThreads) {", True),
        ("tile partials", "      partial[(static_cast<long long>(tile) * kMom + v) * P + p0 + q] = s;\n"
                          "    }\n  }\n", False),
    ],
    "point_moments.cu": [
        ("start", "  const bool live_p = p < P;\n", False),
        ("first chunk arrives", "    // the slice's candidates of the chunk", True, "ch == 0"),
        ("scores, minima", "  __syncthreads();  // the hand-over and the warp sums below reuse the stage buffers\n",
         False),
        ("hand-over, moments, warp sums", "  for (int e = threadIdx.x; e < kMom * G; e += kThreads) {", True),
        ("tile partials", "      partial[(static_cast<long long>(tile) * kMom + v) * P + pq] = s;\n"
                          "    }\n  }\n", False),
    ],
}


def instrument(src: str) -> str:
    text = open(os.path.join(ROOT, "svnicp_tpu_torch", "csrc", src)).read()
    for n, (_, anchor, before, *cond) in enumerate(PHASES[src]):
        if text.count(anchor) != 1:
            raise RuntimeError(f"{src}: anchor {anchor!r} found {text.count(anchor)} times")
        stamp = (f"  if ({cond[0]}) " if cond else "  ") + STAMP.format(n=n)
        text = text.replace(anchor, stamp + anchor if before else anchor + stamp)
    return HEADER + text


def build(src: str) -> ctypes.CDLL:
    from svnicp_tpu_torch.kernels import _build

    os.makedirs(OUT, exist_ok=True)
    cu = os.path.join(OUT, src)
    with open(cu, "w") as f:
        f.write(instrument(src))
    so = cu.replace(".cu", ".so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", so, cu],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    lib.probe_clocks.restype = ctypes.c_int
    lib.probe_clocks.argtypes = [ctypes.c_void_p]
    for name, argtypes in _build.SIGNATURES[src].items():
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = argtypes
    return lib


def phases(lib, src: str, launch, reps: int = 50) -> list[tuple[str, float]]:
    import numpy as np
    import torch

    buf = (ctypes.c_ulonglong * 16)()
    rows = []
    for _ in range(reps):
        assert launch() == 0
        torch.cuda.synchronize()
        assert lib.probe_clocks(ctypes.addressof(buf)) == 0
        clk = np.array(buf[: len(PHASES[src])], dtype=np.int64)
        rows.append(np.diff(clk))
    med = np.median(np.stack(rows), axis=0)
    return [(PHASES[src][n + 1][0], float(c)) for n, c in enumerate(med)]


def main() -> int:
    import torch

    import chip_smoke as cs
    from svnicp_tpu_torch import config as cfg_mod
    from svnicp_tpu_torch.kernels import _build

    if not torch.cuda.is_available():
        print("torch_kernel_phases: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    ptr, stream = _build.ptr, _build.stream_of

    stein = build("stein.cu")
    for p in (10, 64):
        hess, b, r, t, _ = cs.stein_inputs(p, dev, seed=13)
        r_out, t_out = torch.empty_like(r), torch.empty_like(t)
        stats = torch.empty(2, device=dev)

        def launch_b3():
            return stein.svn_stein_update(ptr(hess), ptr(b), ptr(r), ptr(t), None, p, 3.0,
                                          ptr(r_out), ptr(t_out), ptr(stats), stream(hess))

        ph = phases(stein, "stein.cu", launch_b3)
        ms = cs.device_ms(launch_b3, 200, ["stein_kernel"])
        print(f"B3 P={p}: device {ms * 1e3:.2f} us; cycles per phase (thread 0): "
              + ", ".join(f"{n} {c:.0f}" for n, c in ph) + f"; sum {sum(c for _, c in ph):.0f}")

    plane = build("plane_moments.cu")
    cfg = cfg_mod.from_yaml(os.path.join(ROOT, "configs", "tpu_plane.yaml"))
    params, prep = cs.tied_moments_inputs(cfg.icp, 64, 4096, 32, dev, seed=12)
    p, (_, k, nb) = params.shape[0], prep.feat13.shape
    partial = torch.empty((-(-nb // 32), 27, p), device=dev)
    h, bvec = torch.empty((p, 6, 6), device=dev), torch.empty((p, 6), device=dev)

    def launch_b2():
        return plane.svn_plane_moments(*(ptr(x) for x in (params, *prep)), p, k, nb,
                                       float(cfg.icp.max_dist), ptr(partial), ptr(h),
                                       ptr(bvec), stream(params))

    ph = phases(plane, "plane_moments.cu", launch_b2)
    ms = cs.device_ms(launch_b2, 100, ["plane_moments_kernel"])
    ms_sys = cs.device_ms(launch_b2, 100, ["plane_system_kernel"])
    print(f"B2 P={p} B={nb} K={k}: device {ms * 1e3:.2f} us + system pass "
          f"{ms_sys * 1e3:.2f} us; cycles per phase (block 0): "
          + ", ".join(f"{n} {c:.0f}" for n, c in ph) + f"; sum {sum(c for _, c in ph):.0f}")

    point = build("point_moments.cu")
    gcfg = cfg_mod.from_yaml(os.path.join(ROOT, "configs", "geode_alpha.yaml"))
    for p, nb in ((10, 4096), (30, 8192)):
        params, prep = cs.tied_moments_inputs(gcfg.icp, p, nb, 100, dev, seed=15)
        k = prep.feat13.shape[1]
        partial = torch.empty((-(-nb // 16), 16, p), device=dev)
        h, bvec = torch.empty((p, 6, 6), device=dev), torch.empty((p, 6), device=dev)

        def launch_b4():
            return point.svn_point_moments(*(ptr(x) for x in (params, *prep)), p, k, nb,
                                           float(gcfg.icp.max_dist), ptr(partial), ptr(h),
                                           ptr(bvec), stream(params))

        ph = phases(point, "point_moments.cu", launch_b4)
        ms = cs.device_ms(launch_b4, 100, ["point_moments_kernel"])
        ms_sys = cs.device_ms(launch_b4, 100, ["point_system_kernel"])
        print(f"B4 P={p} B={nb} K={k}: device {ms * 1e3:.2f} us + system pass "
              f"{ms_sys * 1e3:.2f} us; cycles per phase (block 0): "
              + ", ".join(f"{n} {c:.0f}" for n, c in ph) + f"; sum {sum(c for _, c in ph):.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
