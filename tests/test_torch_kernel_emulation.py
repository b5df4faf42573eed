"""The CUDA sources of kernels B4, B5 and B1 (`svnicp_tpu_torch/csrc/`
`point_moments.cu`, `nn_match.cu` with the score loop they share in
`point_match.cuh`, and `stage1.cu`) run on the CPU, against their plain
PyTorch versions.

g++ compiles each unchanged source against a small emulation of the CUDA
features it uses: each block's threads run as host threads with a block
barrier, a warp shuffle meets its warp at a per-warp barrier (which is
also `__syncwarp`), and a cp.async copy is a plain copy. The library keeps
the kernel's C entry, so the wrapper's arguments go to it as they go to
the built kernel on the card, and its outputs are held to the plain
version as the card tests hold the built kernel (tests/test_torch_cuda.py).
This checks each kernel's indexing, particle groups or source blocks, tie
sums, hand-over between warps or blocks and its epilogue on a host without
a card; the timing of the asynchronous copies, and anything the card's
compiler does, only the card shows.
"""

import ctypes
import shutil
import subprocess

import pytest
import torch

from svnicp_tpu_torch.core import geometry as geo
from svnicp_tpu_torch.core import svn
from svnicp_tpu_torch.kernels import _build, knn, nn

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
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
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
inline void __syncwarp(unsigned = 0xffffffffu) { g_warps[threadIdx.x / 32]->arrive_and_wait(); }
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
            blockIdx = dim3(bx, by, 0);
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


def build_emulated(tmp_path_factory, src: str) -> ctypes.CDLL:
    """g++ build of csrc/<src>, unchanged, with the port's headers but
    common.cuh replaced by the emulation above."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the emulated kernel")
    d = tmp_path_factory.mktemp(src.replace(".", "_"))
    (d / "cuda_runtime.h").write_text(CUDA_RUNTIME_H)
    for h in _build.CSRC.glob("*.cuh"):
        (d / h.name).write_bytes(h.read_bytes())
    (d / "common.cuh").write_text(COMMON_CUH)
    (d / src).write_bytes((_build.CSRC / src).read_bytes())
    lib = d / f"lib{src}.so"
    subprocess.run([gxx, "-std=c++20", "-O1", "-pthread", "-shared", "-fPIC", "-w",
                    "-I", str(d), "-x", "c++", str(d / src), "-o", str(lib)], check=True)
    dll = ctypes.CDLL(str(lib))
    for name, argtypes in _build.SIGNATURES[src].items():
        getattr(dll, name).argtypes = argtypes
        getattr(dll, name).restype = ctypes.c_int
    return dll


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    return build_emulated(tmp_path_factory, "point_moments.cu").svn_point_moments


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


def point_operands(p, b, k, pad, ties):
    """The card test's operands (tests/test_torch_cuda.py): candidate j 0.1
    (j+1) m from its point, a sixth of the points beyond the gate, 10% of
    the slots and points invalid and point b // 2 with no valid slot. With
    `ties`, candidates 1, 5 and 9 take candidate 0's score features but
    other positions: 5 lies in another slice of the chunk's candidates (at
    G = 16), 9 in the next chunk -> (params, prep, tied slots)."""
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
    for j in tied:
        prep.feat13[:, j] = prep.feat13[:, 0]
        prep.cand_t[:, j] = prep.cand_t[:, 0] + 0.05 * j
    return params, prep, tied


def first_index(prep, tied):
    """The prep whose answer a first-index tie rule gives: the tied slots
    carry candidate 0's coordinates."""
    first = nn.PointPrep(*(x.clone() for x in prep))
    for j in tied:
        first.cand_t[:, j] = first.cand_t[:, 0]
    return first


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("p,b,k,pad", [(1, 7, 3, True), (10, 37, 12, True),
                                       (30, 64, 100, True), (40, 50, 16, True),
                                       (12, 45, 13, False), (64, 64, 100, True)])
def test_point_moments_kernel_source_on_the_cpu(emulated, p, b, k, pad, ties):
    # P=1, 10 and 12 take groups of 16 lanes, P=30 one of 32, P=40 two
    # groups, P=64 two full groups of 32 (the bench's point-to-point row, K
    # padded to 104); B=7, 37 and 45 the 4-byte copies; K=13 left unpadded
    # puts NaN biases past K inside the last chunk
    params, prep, tied = point_operands(p, b, k, pad, ties)
    h_k, b_k = run_emulated(emulated, params, prep, 3.0)
    h_p, b_p = nn.point_moments_plain(params, prep, 3.0)
    torch.testing.assert_close(h_k, h_p, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(b_k, b_p, rtol=1e-4, atol=1e-3)
    assert torch.equal(h_k, h_k.transpose(1, 2))
    h_k2, b_k2 = run_emulated(emulated, params, prep, 3.0)
    assert torch.equal(h_k, h_k2) and torch.equal(b_k, b_k2)
    if ties:
        # ten times closer to the tie-averaged answer than to the first index's
        e_first = (b_k - nn.point_moments_plain(params, first_index(prep, tied), 3.0)[1])
        assert e_first.abs().max() > 10 * (b_k - b_p).abs().max()


@pytest.fixture(scope="module")
def emulated_match(tmp_path_factory):
    return build_emulated(tmp_path_factory, "nn_match.cu").svn_nn_match


def run_match(entry, params, prep):
    p = params.shape[0]
    _, k, b = prep.feat13.shape
    matched = torch.full((3, p, b), float("nan"))
    best = torch.full((p, b), float("nan"))
    err = entry(*(_build.ptr(t) for t in (params, prep.feat13, prep.cand_t)), p, k, b,
                _build.ptr(matched), _build.ptr(best), None)
    assert err == 0
    return matched.permute(1, 2, 0), best


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("p,b,k,pad", [(1, 7, 8, True), (10, 37, 104, True),
                                       (30, 64, 104, True), (33, 37, 8, True),
                                       (40, 64, 104, True), (16, 64, 8, True),
                                       (12, 45, 13, False), (64, 64, 32, True)])
def test_nn_match_kernel_source_on_the_cpu(emulated_match, p, b, k, pad, ties):
    # P=1, 10, 12 and 16 take groups of 16 lanes, P=30 one of 32, P=33 and
    # 40 two groups in grid y, P=64 two full groups (the bench's SVGD row); B=64 the 16-byte copies and float4 stores,
    # B=7, 37 and 45 the 4-byte ones and a tile that ends inside the points;
    # K=13 left unpadded puts NaN biases past K inside the last chunk
    params, prep, tied = point_operands(p, b, k, pad, ties)
    m_k, best_k = run_match(emulated_match, params, prep)
    m_p, best_p = nn.nn_match_plain(params, prep)
    fin = torch.isfinite(best_p)
    assert torch.equal(torch.isfinite(best_k), fin) and not fin[:, b // 2].any()
    # candidates lie 0.1 m apart in distance: no near-ties, the same picks;
    # a point with no valid slot keeps best = +inf and the mean of all slots
    torch.testing.assert_close(m_k, m_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(best_k[fin], best_p[fin], rtol=1e-4, atol=1e-3)
    assert (best_k[~fin] == float("inf")).all()
    m_k2, best_k2 = run_match(emulated_match, params, prep)
    assert torch.equal(m_k, m_k2) and torch.equal(best_k, best_k2)
    if ties:
        m_first, _ = nn.nn_match_plain(params, first_index(prep, tied))
        e_first = (m_k - m_first)[fin].abs().max()
        assert e_first > 10 * (m_k - m_p)[fin].abs().max()


@pytest.fixture(scope="module")
def emulated_stage1(tmp_path_factory):
    return build_emulated(tmp_path_factory, "stage1.cu").svn_stage1_candidates


def run_stage1(entry, src, sv, tgt, tv, k):
    b, nt = src.shape[0], tgt.shape[0]
    blk = knn.bucket_block_size(nt, k)
    group = (nt + (-nt) % (k * blk)) // k
    prep = torch.full((k * group, 4), float("nan"))
    cand = torch.full((b, k, 3), float("nan"))
    d2 = torch.full((b, k), float("nan"))
    err = entry(*(_build.ptr(t) for t in (src, sv, tgt, tv)), b, nt, k, blk, group,
                *(_build.ptr(t) for t in (prep, cand, d2)), None)
    assert err == 0
    return cand, d2


def stage1_operands(b, nt, k):
    """Random sources and targets (every target farther than 3 m from the
    origin), 10% of the sources and 20% of the targets invalid, group k - 1
    with no valid target (k > 1), and source 0 at the origin with exact
    ties in group 0: targets (2,0,0), (0,2,0), (0,0,2) in its first rows and
    (-2,0,0) at position 256 (in its second piece of 256 targets: the tie
    sums span chunks and pieces)."""
    g = torch.Generator().manual_seed(b * k + nt)
    src = torch.randn((b, 3), generator=g) * 10
    tgt = torch.randn((nt, 3), generator=g) * 10
    tgt = tgt * ((tgt.norm(dim=-1, keepdim=True) + 3.0) / tgt.norm(dim=-1, keepdim=True))
    sv = torch.rand(b, generator=g) > 0.1
    tv = torch.rand(nt, generator=g) > 0.2
    blk = knn.bucket_block_size(nt, k)
    rows = torch.arange(nt)
    if k > 1:
        tv[(rows // blk) % k == k - 1] = False
    src[0] = 0.0
    sv[0] = True
    for r, p in zip(range(3), torch.eye(3) * 2.0):
        tgt[r], tv[r] = p, True
    far = (256 // blk * k) * blk + 256 % blk
    if far < nt:
        tgt[far] = torch.tensor([-2.0, 0.0, 0.0])
        tv[far] = True
    return src, sv, tgt, tv


@pytest.mark.parametrize("b,nt,k", [(37, 300, 1), (37, 5000, 12), (600, 20000, 32),
                                    (37, 50, 12), (1, 64, 1), (129, 4096, 32),
                                    (300, 9000, 100), (513, 2000, 7)])
def test_stage1_kernel_source_on_the_cpu(emulated_stage1, b, nt, k):
    # Nt=300, 5000, 20000, 9000 and 2000 are not multiples of k * blk
    # (padding rows at the end of groups), Nt=4096 at k=32 is; at Nt=50,
    # k=12 groups 7-11 hold only padding; B=600 and 513 take a second,
    # ragged block of sources
    src, sv, tgt, tv = stage1_operands(b, nt, k)
    cand_k, d2_k = run_stage1(emulated_stage1, src, sv, tgt, tv, k)
    cand_p, d2_p = nn.bucketed_candidates_plain(src, tgt, sv, tv, k)
    fin = torch.isfinite(d2_p)
    assert torch.equal(torch.isfinite(d2_k), fin)
    if k > 1:
        assert not fin[:, k - 1].any()
    # a slot whose pick differs from the plain version's must be a near-tie
    # in float64: runner-up within 2e-6 max(|s|^2, 1) of the minimum
    score, _ = knn.group_scores(src.double(), tgt.double(), tv, k)
    two = torch.topk(score, min(2, score.shape[-1]), dim=-1, largest=False).values
    scale = (src.double() ** 2).sum(-1, keepdim=True).clamp_min(1.0)
    near_tie = (two[..., -1] - two[..., 0]) <= 2e-6 * scale
    differ = fin & ((cand_k - cand_p).abs().amax(-1) > 1e-4)
    assert bool((near_tie | ~differ).all())
    same = fin & ~differ
    torch.testing.assert_close(cand_k[same], cand_p[same], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(d2_k[fin], d2_p[fin], rtol=1e-4, atol=1e-4)
    # the exact ties of source 0 in group 0 are averaged
    want = (torch.tensor([0.0, 2.0, 2.0]) / 4 if 256 < score.shape[-1] and nt > 256
            else torch.full((3,), 2.0 / 3))
    torch.testing.assert_close(cand_k[0, 0], want, rtol=1e-6, atol=1e-6)
    cand_k2, d2_k2 = run_stage1(emulated_stage1, src, sv, tgt, tv, k)
    assert torch.equal(cand_k, cand_k2) and torch.equal(d2_k, d2_k2)
