"""The CUDA source of kernel B4 (`svnicp_tpu_torch/csrc/point_moments.cu`)
run on the CPU, against its plain PyTorch version.

g++ compiles the unchanged source against a small emulation of the CUDA
features it uses: each block's threads run as host threads with a block
barrier, a warp shuffle meets its warp at a per-warp barrier, and a
cp.async copy is a plain copy. The library keeps the kernel's C entry, so
`point_moments`' arguments go to it as they go to the built kernel on the
card, and its H and b are held to `point_moments_plain` as the card tests
hold the built kernel (tests/test_torch_cuda.py). This checks the
kernel's indexing, particle groups, tie sums, hand-over between warps and
the system fill on a host without a card; the timing of the asynchronous
copies, and anything the card's compiler does, only the card shows.
"""

import ctypes
import shutil
import subprocess

import pytest
import torch

from svnicp_tpu_torch.core import geometry as geo
from svnicp_tpu_torch.core import svn
from svnicp_tpu_torch.kernels import _build, nn

CUDA_RUNTIME_H = r"""
#pragma once
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>
using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __restrict__
#define __align__(n) __attribute__((aligned(n)))
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0 };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float4 { float x, y, z, w; };
inline float4 make_float4(float a, float b, float c, float d) { return {a, b, c, d}; }
inline thread_local dim3 threadIdx, blockIdx;
inline std::barrier<>* g_block = nullptr;
inline std::vector<std::barrier<>*> g_warps;
inline float g_xchg[1024];
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "no error"; }
inline void __syncthreads() { g_block->arrive_and_wait(); }
inline float __int_as_float(int i) { float f; std::memcpy(&f, &i, 4); return f; }
inline float __shfl_xor_sync(unsigned, float v, int off) {
  const int t = threadIdx.x;
  g_xchg[t] = v;
  g_warps[t / 32]->arrive_and_wait();
  const float r = g_xchg[(t & ~31) | ((t & 31) ^ off)];
  g_warps[t / 32]->arrive_and_wait();
  return r;
}
// kernel<<<grid, block>>>(args...): the blocks one after another (so a
// block's __shared__ statics are its own), each block's threads at once
template <typename K>
struct Launch {
  K kernel;
  dim3 grid;
  int block;
  template <typename... A>
  void operator()(A... args) {
    for (unsigned by = 0; by < grid.y; ++by) {
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::barrier<> bar(block);
        std::vector<std::barrier<>*> warps;
        for (int w = 0; w < block / 32; ++w) warps.push_back(new std::barrier<>(32));
        g_block = &bar;
        g_warps = warps;
        std::vector<std::thread> threads;
        for (int t = 0; t < block; ++t) {
          threads.emplace_back([=, this] {
            threadIdx = dim3(t);
            blockIdx = dim3(bx, by);
            kernel(args...);
          });
        }
        for (auto& th : threads) th.join();
        for (auto* w : warps) delete w;
      }
    }
  }
};
template <typename K>
Launch<K> launch(K kernel, dim3 grid, int block) { return Launch<K>{kernel, grid, block}; }
"""

COMMON_CUH = r"""
#pragma once
#include <cuda_runtime.h>
#define SVN_LAUNCH(kernel, grid, block, smem, stream) launch(kernel, dim3(grid), (block))
#define SVN_EXPORT extern "C" __attribute__((visibility("default")))
inline void cp_async16(float* dst, const float* src, bool pred) {
  for (int i = 0; i < 4; ++i) dst[i] = pred ? src[i] : 0.f;
}
inline void cp_async4(float* dst, const float* src, bool pred) { *dst = pred ? *src : 0.f; }
inline void cp_async_commit() {}
template <int N> inline void cp_async_wait() {}
"""


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulated kernel")
    d = tmp_path_factory.mktemp("b4_emulated")
    (d / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    (d / "common.cuh").write_text(COMMON_CUH)
    src = d / "point_moments.cu"
    src.write_bytes((_build.CSRC / "point_moments.cu").read_bytes())
    lib = d / "libpoint_moments.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", "-w",
                    "-I", str(d), "-x", "c++", str(src), "-o", str(lib)], check=True)
    dll = ctypes.CDLL(str(lib))
    entry = dll.svn_point_moments
    entry.argtypes = _build.SIGNATURES["point_moments.cu"]["svn_point_moments"]
    entry.restype = ctypes.c_int
    return entry


def run_emulated(entry, params, prep, max_dist):
    p = params.shape[0]
    _, k, b = prep.feat13.shape
    partial = torch.full((-(-b // nn._POINT_TILE), nn._N_POINT_SUMS, p), float("nan"))
    h = torch.full((p, 6, 6), float("nan"))
    bvec = torch.full((p, 6), float("nan"))
    err = entry(*(_build.ptr(t) for t in (params, *prep)), p, k, b, float(max_dist),
                _build.ptr(partial), _build.ptr(h), _build.ptr(bvec), None)
    assert err == 0
    return h, bvec


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("p,b,k,pad", [(1, 7, 3, True), (10, 37, 12, True),
                                       (30, 64, 100, True), (40, 50, 16, True),
                                       (12, 45, 13, False)])
def test_point_moments_kernel_source_on_the_cpu(emulated, p, b, k, pad, ties):
    # the card test's operands (tests/test_torch_cuda.py): candidate j 0.1 (j+1)
    # m from its point, a sixth of the points beyond the gate, 10% of the
    # slots and points invalid; P=1, 10 and 12 take groups of 16 lanes, P=30
    # one of 32, P=40 two groups; B=7, 37 and 45 the 4-byte copies; K=13 left
    # unpadded puts NaN biases past K inside the last chunk
    g = torch.Generator().manual_seed(p * b + k)
    src = torch.randn((b, 3), generator=g) * 5
    dirs = torch.nn.functional.normalize(torch.randn((b, k, 3), generator=g), dim=-1)
    radius = (0.1 + 0.1 * torch.arange(k))[None, :].repeat(b, 1)
    radius[: b // 6] += 3.0
    cand = src[:, None, :] + dirs * radius[..., None]
    cvalid = torch.rand((b, k), generator=g) > 0.1
    cvalid[b // 2] = False
    valid = torch.rand(b, generator=g) > 0.1
    xi = torch.randn((p, 6), generator=g) * 1e-4
    params = torch.cat([geo.so3_exp(xi[:, 3:]).reshape(p, 9), xi[:, :3]], -1).contiguous()
    if pad:
        cand, cvalid = nn.pad_candidates(cand, cvalid, multiple=8)
    feat, bias = svn.correspondence_features(src, cand, cvalid)
    prep = nn.prepare_moments_point(feat, bias, cand, src, valid)
    tied = [j for j in (1, 5, 9) if j < prep.feat13.shape[1]] if ties else []
    # candidate 0's score at another position: 5 in another slice of the chunk's
    # candidates (P=1, 10, 12), 9 in the next chunk
    for j in tied:
        prep.feat13[:, j] = prep.feat13[:, 0]
        prep.cand_t[:, j] = prep.cand_t[:, 0] + 0.05 * j
    h_k, b_k = run_emulated(emulated, params, prep, 3.0)
    h_p, b_p = nn.point_moments_plain(params, prep, 3.0)
    torch.testing.assert_close(h_k, h_p, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(b_k, b_p, rtol=1e-4, atol=1e-3)
    assert torch.equal(h_k, h_k.transpose(1, 2))
    h_k2, b_k2 = run_emulated(emulated, params, prep, 3.0)
    assert torch.equal(h_k, h_k2) and torch.equal(b_k, b_k2)
    if ties:
        # ten times closer to the tie-averaged answer than to the first index's
        first = nn.PointPrep(*(x.clone() for x in prep))
        for j in tied:
            first.cand_t[:, j] = first.cand_t[:, 0]
        e_first = (b_k - nn.point_moments_plain(params, first, 3.0)[1]).abs().max()
        assert e_first > 10 * (b_k - b_p).abs().max()
