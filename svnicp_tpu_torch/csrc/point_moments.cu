// B4: fused point-to-point correspondence + Gauss-Newton block moments.
//
// Replaces the TPU kernel svnicp_tpu/kernels/nn_pallas.py:fused_moments_kb
// (body _moments_kernel_kb). For every (particle p, source point b): the min
// over the K candidates of score = params13[p] . feat13[:, k, b]
// (|c|^2 - 2 <T_p s_b, c>), the mean of the tied minima's coordinates (the
// matched point q), the gate d2 = max(best + |T_p s_b|^2, 0) < max_dist
// (squared distance against the unsquared max_dist: the reference quirk)
// with best < 1e30 (a point with no valid candidate has best = +inf), the
// residual e = (T_p s_b - q) * gate, the weight (md/(md + 3|e|))^2 times the
// point mask (a gated-out pair keeps w = 1 with e = 0 and s = 0, so it adds
// only to sw: the reference's identity damping), and the 19 block moments
// sw, m1 = sum w s, m2 = sum w s s^T, b_t = sum R^T (w e),
// b_r = sum s x R^T (w e), with s = s_b * gate. The host assembles H and b
// from them. Those 19 sums over the points of a block go to per-tile
// partials [n_tiles, 19, P]; a second pass sums the tiles in a fixed order
// (no atomics), so repeated runs give bit-identical moments.
//
// What bounds it: the function needs each slot's 3 coordinates and validity
// (~5.3 MB at the geode path's shapes, P=10, K=100, B=4096) and, in the form
// |c|^2 - 2 c.(T s), about 8 flops per (particle, valid slot) plus ~165 per
// (particle, point), ~0.04 GFLOP: bytes at those shapes, bytes and
// arithmetic about equal at subt_mrs's (P=30, B=8192). This first kernel
// instead reads the prepared 13-float features of each slot (feat13, the B2
// layout) plus its 3 coordinates, 16 floats per slot (27 MB at geode
// shapes), and does 13 FMAs per (particle, slot), once per group of 8
// particles: particles sit in shared memory, points on threads, so the
// loads are coalesced along B; each thread keeps the running min, tie count
// and coordinate sums of its 8 particles in registers, and the 19 moments
// are reduced with warp shuffles and then across the block's 4 warps in
// shared memory.

#include "tiles.cuh"

namespace {

constexpr int kPts = 128;   // source points per block (one per thread)
constexpr int kPart = 8;    // particles per block
constexpr int kMom = 19;    // sw, m1[3], m2[9], b_t[3], b_r[3]
constexpr int kWarps = kPts / 32;

__global__ void __launch_bounds__(kPts)
point_moments_kernel(const float* __restrict__ params,   // [P,12]
                     const float* __restrict__ feat13,   // [13,K,B]
                     const float* __restrict__ cand_t,   // [3,K,B]
                     const float* __restrict__ src_t,    // [3,B]
                     const float* __restrict__ vmask,    // [B]
                     int P, int K, int B, float max_dist,
                     float* __restrict__ partial) {      // [n_tiles,19,P]
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
  float best[kPart], cnt[kPart], qx[kPart], qy[kPart], qz[kPart];
#pragma unroll
  for (int q = 0; q < kPart; ++q) {
    best[q] = INFINITY;
    cnt[q] = 0.f;
    qx[q] = 0.f;
    qy[q] = 0.f;
    qz[q] = 0.f;
  }
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, vm = 0.f;
  if (live) {
    const long long kb = static_cast<long long>(K) * B;
    for (int k = 0; k < K; ++k) {
      const long long off = static_cast<long long>(k) * B + b;
      float f[13];
#pragma unroll
      for (int c = 0; c < 13; ++c) f[c] = feat13[c * kb + off];
      const float cx = cand_t[off], cy = cand_t[kb + off], cz = cand_t[2 * kb + off];
#pragma unroll
      for (int q = 0; q < kPart; ++q) {
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < 13; ++c) s += prm[q][c] * f[c];
        // +inf == +inf counts as a tie, as in the plain version: a point
        // whose slots are all invalid averages them and is gated out below
        if (s < best[q]) {
          best[q] = s;
          cnt[q] = 1.f;
          qx[q] = cx;
          qy[q] = cy;
          qz[q] = cz;
        } else if (s == best[q]) {
          cnt[q] += 1.f;
          qx[q] += cx;
          qy[q] += cy;
          qz[q] += cz;
        }
      }
    }
    s0 = src_t[b];
    s1 = src_t[B + b];
    s2 = src_t[2 * B + b];
    vm = vmask[b];
  }

#pragma unroll
  for (int q = 0; q < kPart; ++q) {
    float m[kMom];
#pragma unroll
    for (int v = 0; v < kMom; ++v) m[v] = 0.f;
    if (live && p0 + q < P) {
      const float* pr = prm[q];
      const float t0 = pr[0] * s0 + pr[1] * s1 + pr[2] * s2 + pr[9];
      const float t1 = pr[3] * s0 + pr[4] * s1 + pr[5] * s2 + pr[10];
      const float t2 = pr[6] * s0 + pr[7] * s1 + pr[8] * s2 + pr[11];
      const float d2 = fmaxf(best[q] + (t0 * t0 + t1 * t1 + t2 * t2), 0.f);
      const bool gate = (d2 < max_dist) && (best[q] < 1e30f);
      const float inv = 1.f / fmaxf(cnt[q], 1.f);
      const float e0 = gate ? t0 - qx[q] * inv : 0.f;
      const float e1 = gate ? t1 - qy[q] * inv : 0.f;
      const float e2 = gate ? t2 - qz[q] * inv : 0.f;
      const float en = sqrtf(e0 * e0 + e1 * e1 + e2 * e2);
      float w = max_dist / (max_dist + 3.f * en);
      w = w * w * vm;
      const float we0 = w * e0, we1 = w * e1, we2 = w * e2;
      const float g0 = gate ? s0 : 0.f, g1 = gate ? s1 : 0.f, g2 = gate ? s2 : 0.f;
      // R^T (w e), R[i][j] = pr[3 i + j]
      const float r0 = pr[0] * we0 + pr[3] * we1 + pr[6] * we2;
      const float r1 = pr[1] * we0 + pr[4] * we1 + pr[7] * we2;
      const float r2 = pr[2] * we0 + pr[5] * we1 + pr[8] * we2;
      const float g[3] = {g0, g1, g2};
      m[0] = w;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        m[1 + i] = w * g[i];
#pragma unroll
        for (int j = 0; j < 3; ++j) m[4 + 3 * i + j] = w * g[i] * g[j];
      }
      m[13] = r0;
      m[14] = r1;
      m[15] = r2;
      m[16] = g1 * r2 - g2 * r1;
      m[17] = g2 * r0 - g0 * r2;
      m[18] = g0 * r1 - g1 * r0;
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

// Writes the per-particle moments [19, P] (row 0: sw, 1-3: m1, 4-12: m2
// row-major, 13-15: b_t, 16-18: b_r) into `out`; `partial` is scratch of
// ceil(B/128)*19*P floats.
SVN_EXPORT int svn_point_moments(const void* params, const void* feat13, const void* cand_t,
                                 const void* src_t, const void* vmask, int P, int K, int B,
                                 float max_dist, void* partial, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (B + kPts - 1) / kPts;
  if (P > 0) {
    if (n_tiles > 0) {
      const dim3 grid(n_tiles, (P + kPart - 1) / kPart);
      SVN_LAUNCH(point_moments_kernel, grid, kPts, 0, st)(
          static_cast<const float*>(params), static_cast<const float*>(feat13),
          static_cast<const float*>(cand_t), static_cast<const float*>(src_t),
          static_cast<const float*>(vmask), P, K, B, max_dist, static_cast<float*>(partial));
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const int n = kMom * P;
    SVN_LAUNCH(sum_tiles_kernel, (n + 255) / 256, 256, 0, st)(
        static_cast<const float*>(partial), n_tiles, n, static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
