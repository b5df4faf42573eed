// B2: fused point-to-plane correspondence + Gauss-Newton moments.
//
// Replaces the TPU kernel svnicp_tpu/kernels/nn_pallas.py:fused_moments_plane_kb
// (body _plane_moments_kernel_kb). For every (particle p, source point b):
// the min over the K candidates of score = params13[p] . feat13[:, k, b]
// (|c|^2 - 2 <T_p s_b, c>), the tie-averaged n.q of the minima, the gate
// d2 = max(best + |T_p s_b|^2, 0) < max_dist (squared distance against the
// unsquared max_dist: the reference quirk) with best < 1e30, the plane
// residual r = n.(T_p s_b) - n.q, the weight (md/(md + 3|r|))^2 times the gate
// and the point mask, and the 21 upper-triangle entries of w g g^T and the 6
// of w r g, g = [R^T n, s x R^T n]. Those 27 sums over the points of a block
// go to per-tile partials [n_tiles, 27, P]; a second pass sums the tiles in a
// fixed order (no atomics), so repeated runs give bit-identical moments.
//
// What bounds it: arithmetic. At the main path's shapes (P=64, K=32, B=4096)
// the function needs ~8 flops per (p,b,k) triple in the form
// |c|^2 - 2 c.(T s) plus ~145 per (p,b), about 0.1 GFLOP, against ~1.8 MB of
// candidates, normals and source; this kernel does 13 FMAs per triple
// (0.25 GFLOP) on 7.3 MB of prepared features. The design reads each point's
// 13x32 features once per group of 8 particles (particles sit in shared
// memory, points on threads, so the feature loads are coalesced along B),
// keeps the running min / tie count / n.q sum of its 8 particles in
// registers, and reduces the 27 moments with warp shuffles and then across
// the block's 4 warps in shared memory.

#include "tiles.cuh"

namespace {

constexpr int kPts = 128;   // source points per block (one per thread)
constexpr int kPart = 8;    // particles per block
constexpr int kMom = 27;    // 21 H entries + 6 b entries
constexpr int kWarps = kPts / 32;

__global__ void __launch_bounds__(kPts)
plane_moments_kernel(const float* __restrict__ params,   // [P,12]
                     const float* __restrict__ feat13,   // [13,K,B]
                     const float* __restrict__ ndotc,    // [K,B]
                     const float* __restrict__ src_t,    // [3,B]
                     const float* __restrict__ nrm_t,    // [3,B]
                     const float* __restrict__ vmask,    // [B]
                     int P, int K, int B, float max_dist,
                     float* __restrict__ partial) {      // [n_tiles,27,P]
  __shared__ float prm[kPart][13];
  __shared__ float red[kWarps][kPart][kMom];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.x;
  const int p0 = blockIdx.y * kPart;
  const int b = tile * kPts + tid;
  if (tid < kPart * 13) {
    const int q = tid / 13, c = tid - q * 13;
    const int p = p0 + q;
    prm[q][c] = p < P ? (c < 12 ? params[p * 12 + c] : 1.f) : 0.f;
  }
  __syncthreads();

  const bool live = b < B;
  float best[kPart], cnt[kPart], nqs[kPart];
#pragma unroll
  for (int q = 0; q < kPart; ++q) {
    best[q] = INFINITY;
    cnt[q] = 0.f;
    nqs[q] = 0.f;
  }
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, n0 = 0.f, n1 = 0.f, n2 = 0.f, vm = 0.f;
  if (live) {
    for (int k = 0; k < K; ++k) {
      float f[13];
#pragma unroll
      for (int c = 0; c < 13; ++c) f[c] = feat13[(static_cast<long long>(c) * K + k) * B + b];
      const float nd = ndotc[static_cast<long long>(k) * B + b];
#pragma unroll
      for (int q = 0; q < kPart; ++q) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < 13; ++c) s += prm[q][c] * f[c];
        if (s < best[q]) {
          best[q] = s;
          cnt[q] = 1.f;
          nqs[q] = nd;
        } else if (s == best[q]) {
          cnt[q] += 1.f;
          nqs[q] += nd;
        }
      }
    }
    s0 = src_t[b];
    s1 = src_t[B + b];
    s2 = src_t[2 * B + b];
    n0 = nrm_t[b];
    n1 = nrm_t[B + b];
    n2 = nrm_t[2 * B + b];
    vm = vmask[b];
  }

#pragma unroll
  for (int q = 0; q < kPart; ++q) {
    float m[kMom];
#pragma unroll
    for (int v = 0; v < kMom; ++v) m[v] = 0.f;
    if (live && p0 + q < P) {
      const float* pr = prm[q];
      float t2 = 0.f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float ti = pr[3 * i] * s0 + pr[3 * i + 1] * s1 + pr[3 * i + 2] * s2 + pr[9 + i];
        t2 += ti * ti;
      }
      const float d2 = fmaxf(best[q] + t2, 0.f);
      const bool gate = (d2 < max_dist) && (best[q] < 1e30f);
      const float u0 = pr[0] * n0 + pr[3] * n1 + pr[6] * n2;
      const float u1 = pr[1] * n0 + pr[4] * n1 + pr[7] * n2;
      const float u2 = pr[2] * n0 + pr[5] * n1 + pr[8] * n2;
      const float nts = u0 * s0 + u1 * s1 + u2 * s2;
      const float ntt = pr[9] * n0 + pr[10] * n1 + pr[11] * n2;
      const float nq = nqs[q] / fmaxf(cnt[q], 1.f);
      const float r = nts + ntt - nq;
      float w = max_dist / (max_dist + 3.f * fabsf(r));
      w = w * w * (gate ? 1.f : 0.f) * vm;
      const float wr = w * r;
      const float g[6] = {u0, u1, u2, s1 * u2 - s2 * u1, s2 * u0 - s0 * u2, s0 * u1 - s1 * u0};
      int e = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int j = i; j < 6; ++j) m[e++] = w * g[i] * g[j];
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) m[21 + i] = wr * g[i];
    }
#pragma unroll
    for (int v = 0; v < kMom; ++v) {
      const float s = warp_sum(m[v]);
      if (lane == 0) red[warp][q][v] = s;
    }
  }
  __syncthreads();
  for (int e = tid; e < kPart * kMom; e += kPts) {
    const int q = e / kMom, v = e - q * kMom;
    const int p = p0 + q;
    if (p < P) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += red[w][q][v];
      partial[(static_cast<long long>(tile) * kMom + v) * P + p] = s;
    }
  }
}

}  // namespace

// Writes the per-particle moments [27, P] (rows 0-20: H upper triangle in
// row-major order, rows 21-26: b) into `out`; `partial` is scratch of
// ceil(B/128)*27*P floats.
SVN_EXPORT int svn_plane_moments(const void* params, const void* feat13, const void* ndotc,
                                 const void* src_t, const void* nrm_t, const void* vmask,
                                 int P, int K, int B, float max_dist, void* partial,
                                 void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (B + kPts - 1) / kPts;
  if (P > 0) {
    if (n_tiles > 0) {
      const dim3 grid(n_tiles, (P + kPart - 1) / kPart);
      SVN_LAUNCH(plane_moments_kernel, grid, kPts, 0, st)(
          static_cast<const float*>(params), static_cast<const float*>(feat13),
          static_cast<const float*>(ndotc), static_cast<const float*>(src_t),
          static_cast<const float*>(nrm_t), static_cast<const float*>(vmask), P, K, B,
          max_dist, static_cast<float*>(partial));
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int n = kMom * P;
    SVN_LAUNCH(sum_tiles_kernel, (n + 255) / 256, 256, 0, st)(
        static_cast<const float*>(partial), n_tiles, n, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
