#!/usr/bin/env python3
"""Where the time goes inside the port's five kernels, on one NVIDIA GPU.

    python3 tools/torch_kernel_phases.py

Copies `svnicp_tpu_torch/csrc/stein.cu`, `plane_moments.cu`,
`point_moments.cu`, `nn_match.cu` (with the score loop they share,
`point_match.cuh`) and `stage1.cu` into `build/kernel_phases/<kernel>/`,
inserts a `clock64()` stamp at each phase boundary (thread 0 of block 0;
every stamp but the last follows a block barrier, so it marks when the
whole block finished the phase before), builds the copies
with the port's nvcc flags and runs them on chip_smoke.py's operands: B3 at
P=10 and P=64 (random SPD ensembles), B2 at the main path's shapes (P=64,
B=4096, K=32, the synthetic tie operands), B4 at the GEODE-Alpha path's
shapes (P=10, B=4096, K=104) and configs/subt_mrs.yaml's (P=30, B=8192,
K=104), B5 at the SVGD path's (P=30, B=4096, K=104), on the same synthetic
operands, and B1 on the main path's stage-1 operands (B=4096 against a
65,536-row map) at k=32 and k=100. Prints the cycles of each phase (median
over 50 launches) and the kernel's device time from torch.profiler,
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

# source -> [(phase name, file the anchor is in, anchor, insert before (True)
#             or after the anchor, [condition of a stamp inside a loop])]
PHASES = {
    "stein.cu": [
        ("start", "stein.cu", "  const bool store = P <= kStoreMaxP;\n", False),
        ("stage operands", "stein.cu", "  // 1. per particle", True),
        ("solve, so3_log", "stein.cu", "  // 2. h_mean", True),
        ("h_mean, centring", "stein.cu", "  // 3. exact lower median", True),
        ("pass 0 count", "stein.cu", "    if (tid == 0 && prefix == 0u) atomicAdd(&hcur[0]", True,
         "d == 0"),
        ("pass 0 barrier", "stein.cu", "    unsigned cnt[8], tot = 0u;", True, "d == 0"),
        ("pass 0 scan", "stein.cu", "    rank = __shfl_sync(0xFFFFFFFFu, r, owner);\n", False,
         "d == 0"),
        ("passes 1-3", "stein.cu", "  const float med = __uint_as_float(prefix);", True),
        ("kernel rows", "stein.cu", "  // 5. per particle", True),
        ("repulsion, pose update", "stein.cu", "  // 6. exit statistics", True),
        ("exit sums", "stein.cu", "    stats[1] = sqrtf(m2);\n  }\n", False),
    ],
    "plane_moments.cu": [
        ("start", "plane_moments.cu", "  const int p0 = blockIdx.y * kGroup;\n", False),
        ("first chunk arrives", "plane_moments.cu",
         "    const float* st = smem + (ch % kStages) * kStage", True, "ch == 0"),
        ("scores, minima", "plane_moments.cu", "  // moments: over the lane's", True),
        ("moments, warp sums", "plane_moments.cu",
         "  for (int e = threadIdx.x; e < kMom * kGroup; e += kThreads) {", True),
        ("tile partials", "plane_moments.cu",
         "      partial[(static_cast<long long>(tile) * kMom + v) * P + p0 + q] = s;\n"
         "    }\n  }\n", False),
    ],
    "point_moments.cu": [
        ("start", "point_moments.cu", "  const bool live_p = p < P;\n", False),
        ("first chunk arrives", "point_match.cuh", "    // the slice's candidates of the chunk",
         True, "ch == 0"),
        ("scores, minima", "point_match.cuh",
         "  __syncthreads();  // the hand-over below reuses the stage buffers\n", False),
        ("hand-over, moments, warp sums", "point_moments.cu",
         "  for (int e = threadIdx.x; e < kMom * G; e += kThreads) {", True),
        ("tile partials", "point_moments.cu",
         "      partial[(static_cast<long long>(tile) * kMom + v) * P + pq] = s;\n"
         "    }\n  }\n", False),
    ],
    "nn_match.cu": [
        ("start", "nn_match.cu", "  const bool live_p = p < P;\n", False),
        ("first chunk arrives", "point_match.cuh", "    // the slice's candidates of the chunk",
         True, "ch == 0"),
        ("scores, minima", "point_match.cuh",
         "  __syncthreads();  // the hand-over below reuses the stage buffers\n", False),
        ("hand-over, stores", "nn_match.cu", "}\n\ntemplate <int G>\ncudaError_t launch_match",
         True),
    ],
    "stage1.cu": [
        ("start", "stage1.cu", "  // the pieces of group c;", True),
        ("first piece arrives", "stage1.cu",
         "    const float4* tile = reinterpret_cast<const float4*>", True, "i == 0"),
        ("scores, minima", "stage1.cu", "  // the ties: every target of chunks first..last", True),
        ("tie sums, writes", "stage1.cu", "}\n\n}  // namespace", True),
    ],
}


def instrument(src: str) -> dict[str, str]:
    """The instrumented text of `src` and of every header it has an anchor
    in, by file name."""
    files = {}
    for n, (_, name, anchor, before, *cond) in enumerate(PHASES[src]):
        if name not in files:
            with open(os.path.join(ROOT, "svnicp_tpu_torch", "csrc", name)) as f:
                files[name] = f.read()
        text = files[name]
        if text.count(anchor) != 1:
            raise RuntimeError(f"{name}: anchor {anchor!r} found {text.count(anchor)} times")
        stamp = (f"  if ({cond[0]}) " if cond else "  ") + STAMP.format(n=n)
        files[name] = text.replace(anchor, stamp + anchor if before else anchor + stamp)
    files[src] = HEADER + files[src]
    return files


def build(src: str) -> ctypes.CDLL:
    from svnicp_tpu_torch.kernels import _build

    out = os.path.join(OUT, src.split(".")[0])
    os.makedirs(out, exist_ok=True)
    for name, text in instrument(src).items():
        with open(os.path.join(out, name), "w") as f:
            f.write(text)
    cu = os.path.join(out, src)
    so = cu.replace(".cu", ".so")
    # the instrumented headers come first on the include path
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", out, "-I", str(_build.CSRC),
                    "-o", so, cu], check=True, capture_output=True, text=True)
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

    match = build("nn_match.cu")
    p, nb = 30, 4096
    params, prep = cs.tied_moments_inputs(gcfg.icp, p, nb, 100, dev, seed=16)
    k = prep.feat13.shape[1]
    matched, best = torch.empty((3, p, nb), device=dev), torch.empty((p, nb), device=dev)

    def launch_b5():
        return match.svn_nn_match(ptr(params), ptr(prep.feat13), ptr(prep.cand_t), p, k, nb,
                                  ptr(matched), ptr(best), stream(params))

    ph = phases(match, "nn_match.cu", launch_b5)
    ms = cs.device_ms(launch_b5, 100, ["nn_match_kernel"])
    print(f"B5 P={p} B={nb} K={k}: device {ms * 1e3:.2f} us; cycles per phase (block 0): "
          + ", ".join(f"{n} {c:.0f}" for n, c in ph) + f"; sum {sum(c for _, c in ph):.0f}")

    # B1 on the main path's stage-1 operands (scan 2's source against the map
    # of scans 0-1) at k=32 and k=100
    from svnicp_tpu_torch.kernels import knn

    stage1 = build("stage1.cu")
    _, _, _, scans = cs.bench_sequence(3)
    src, sv, tgt, tv = cs.stage1_inputs(cfg, scans, dev)
    nb, nt = src.shape[0], tgt.shape[0]
    for k in (32, 100):
        blk = knn.bucket_block_size(nt, k)
        group = (nt + (-nt) % (k * blk)) // k
        prep = torch.empty((k * group, 4), device=dev)
        cand, d2 = torch.empty((nb, k, 3), device=dev), torch.empty((nb, k), device=dev)

        def launch_b1():
            return stage1.svn_stage1_candidates(ptr(src), ptr(sv), ptr(tgt), ptr(tv), nb, nt,
                                                k, blk, group, ptr(prep), ptr(cand), ptr(d2),
                                                stream(src))

        ph = phases(stage1, "stage1.cu", launch_b1)
        ms_prep = cs.device_ms(launch_b1, 100, ["stage1_prep_kernel"])
        ms = cs.device_ms(launch_b1, 100, ["stage1_kernel"])
        print(f"B1 B={nb} Nt={nt} k={k}: device {ms_prep * 1e3:.2f} us target prep + "
              f"{ms * 1e3:.2f} us search; cycles per phase (block 0): "
              + ", ".join(f"{n} {c:.0f}" for n, c in ph) + f"; sum {sum(c for _, c in ph):.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
