// B2: fused point-to-plane correspondence + Gauss-Newton system.
//
// Replaces the TPU kernel svnicp_tpu/kernels/nn_pallas.py:fused_moments_plane_kb
// (body _plane_moments_kernel_kb, and the symmetric fill after it). For
// every (particle p, source point b): the min over the K candidates of
// score = params13[p] . feat13[:, k, b] (|c|^2 - 2 <T_p s_b, c>), the
// tie-averaged n.q of the minima, the gate d2 = max(best + |T_p s_b|^2, 0)
// < max_dist (squared distance against the unsquared max_dist: the
// reference quirk) with best < 1e30, the plane residual
// r = n.(T_p s_b) - n.q, the weight (md/(md + 3|r|))^2 times the gate and
// the point mask, and the 21 upper-triangle entries of w g g^T and the 6 of
// w r g, g = [R^T n, s x R^T n]. Those 27 sums over a block's points go to
// per-tile partials [n_tiles, 27, P]; a second kernel sums the tiles in a
// fixed order (no atomics, so repeated runs give the same bits) and writes
// the system itself: H [P,6,6] symmetric + 1e-6 I and b [P,6].
//
// What bounds it: arithmetic. At the main path's shapes (P=64, K=32,
// B=4096) the score takes 13 FMAs per (p,b,k) triple, 1.1e8 FMAs (3.3 us at
// 67 TFLOP/s), plus a compare-and-select for the running minimum; the
// prepared features are 7.3 MB (2.2 us at 3.35 TB/s). On the card the
// score loop is bound by instruction issue (FMAs are ~55% of its
// instructions). The design:
//   - a block owns a tile of 32 points and serves up to 64 particles from
//     one copy of the tile's features in shared memory, so the features
//     cross device memory once per launch (for P <= 64);
//   - the tile is staged in chunks of 8 candidates with cp.async, three
//     buffers deep, so any K fits, the next chunk's copy overlaps this
//     chunk's arithmetic and a chunk costs one barrier;
//   - register blocking: a warp holds all 64 particles (2 a lane, 13
//     parameters each) and 4 points, whose features are one float4 per
//     candidate and feature row that all lanes read at once (a broadcast),
//     so one shared load feeds 8 FMAs; a lane keeps the running min / tie
//     count / n.q sum of its 2 x 4 pairs;
//   - a chunk's scores stay in registers: one min over them, then one
//     equality pass adds the ties as hit * n.c by an FMA (4 instructions
//     per triple beside the 13 FMAs, where a running minimum with its tie
//     count took about 9 in the SASS), the same ties summed in the same
//     order;
//   - the 27 sums per particle: over a lane's 4 points in registers, then
//     over the block's 8 warps in shared memory in a fixed order;
//   - the tile sum reads the partials coalesced along the particles.

#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kTile = 32;                    // source points per block
constexpr int kPtsPerWarp = 4;               // one float4
constexpr int kWarps = kTile / kPtsPerWarp;  // one warp per 4 points
constexpr int kThreads = kWarps * 32;
constexpr int kLanePart = 2;                 // particles per lane
constexpr int kGroup = 32 * kLanePart;       // particles per block
constexpr int kChunk = 8;                    // candidates per stage
constexpr int kRows = 14 * kChunk;           // 13 feature rows + n.c, per candidate
constexpr int kStage = kRows * kTile;        // floats per stage
constexpr int kMom = 27;                     // 21 H entries + 6 b entries
constexpr int kRed = (kWarps / 2) * kGroup * kMom;
constexpr int kStages = 3;                   // a chunk in use, the next in flight
static_assert(kRed <= kStages * kStage, "the warp partials reuse the stage buffers");

// Copy candidates [k0, k0 + kChunk) of the tile's points b0.. into `st`:
// row c * kChunk + kk (c < 13: feature c, c = 13: n.c), kTile floats each.
// Slots past K or B are zero-filled and never read as candidates or points.
__device__ __forceinline__ void load_chunk(float* st, const float* __restrict__ feat13,
                                           const float* __restrict__ ndotc, int K, int B,
                                           int k0, int b0, bool vec) {
  if (vec) {  // B % 4 == 0: 16-byte copies, 8 per row
    for (int e = threadIdx.x; e < kRows * (kTile / 4); e += kThreads) {
      const int row = e >> 3, seg = e & 7;
      const int c = row / kChunk, k = k0 + (row - c * kChunk), b = b0 + seg * 4;
      const bool ok = k < K && b < B;
      const float* src = !ok ? feat13
                         : c < 13 ? feat13 + (static_cast<long long>(c) * K + k) * B + b
                                  : ndotc + static_cast<long long>(k) * B + b;
      cp_async16(st + row * kTile + seg * 4, src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < kRows * kTile; e += kThreads) {
      const int row = e / kTile, t = e - row * kTile;
      const int c = row / kChunk, k = k0 + (row - c * kChunk), b = b0 + t;
      const bool ok = k < K && b < B;
      const float* src = !ok ? feat13
                         : c < 13 ? feat13 + (static_cast<long long>(c) * K + k) * B + b
                                  : ndotc + static_cast<long long>(k) * B + b;
      cp_async4(st + row * kTile + t, src, ok);
    }
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads)
plane_moments_kernel(const float* __restrict__ params,   // [P,12]
                     const float* __restrict__ feat13,   // [13,K,B]
                     const float* __restrict__ ndotc,    // [K,B]
                     const float* __restrict__ src_t,    // [3,B]
                     const float* __restrict__ nrm_t,    // [3,B]
                     const float* __restrict__ vmask,    // [B]
                     int P, int K, int B, float max_dist, int vec,
                     float* __restrict__ partial) {      // [n_tiles,27,P]
  __shared__ __align__(16) float smem[kStages * kStage];
  __shared__ float pts[7][kTile];   // source [3], normal [3], mask
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int tile = blockIdx.x;
  const int b0 = tile * kTile;
  const int p0 = blockIdx.y * kGroup;
  const int t0 = warp * kPtsPerWarp;           // the warp's first point in the tile

  // the lane's particles: p0 + lane + 32 q
  float prm[kLanePart][13];
#pragma unroll
  for (int q = 0; q < kLanePart; ++q) {
    const int p = p0 + lane + 32 * q;
#pragma unroll
    for (int c = 0; c < 13; ++c) prm[q][c] = p < P ? (c < 12 ? params[p * 12 + c] : 1.f) : 0.f;
  }
  float best[kLanePart][4], cnt[kLanePart][4], nqs[kLanePart][4];
#pragma unroll
  for (int q = 0; q < kLanePart; ++q) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      best[q][j] = INFINITY;
      cnt[q][j] = 0.f;
      nqs[q][j] = 0.f;
    }
  }

  // the tile's source points, normals and mask, in the first copy group
  for (int e = threadIdx.x; e < 7 * kTile; e += kThreads) {
    const int row = e / kTile, t = e - row * kTile, b = b0 + t;
    const float* src = b >= B ? src_t
                       : row < 3 ? src_t + row * B + b
                       : row < 6 ? nrm_t + (row - 3) * B + b
                                 : vmask + b;
    cp_async4(&pts[row][t], src, b < B);
  }
  // the copy of chunk ch + 1 goes to a buffer that every warp left before
  // the barrier of chunk ch - 1, so a chunk needs one barrier
  const int n_chunks = (K + kChunk - 1) / kChunk;
  load_chunk(smem, feat13, ndotc, K, B, 0, b0, vec != 0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      load_chunk(smem + ((ch + 1) % kStages) * kStage, feat13, ndotc, K, B, (ch + 1) * kChunk,
                 b0, vec != 0);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* st = smem + (ch % kStages) * kStage + t0;
    const int nk = min(kChunk, K - ch * kChunk);
    // the chunk's scores (NaN past K: no minimum, no tie)
    float sc[kChunk][kLanePart][4];
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
#pragma unroll
      for (int q = 0; q < kLanePart; ++q) {
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[kk][q][j] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < 13; ++c) {
        const float4 f = *reinterpret_cast<const float4*>(st + (c * kChunk + kk) * kTile);
#pragma unroll
        for (int q = 0; q < kLanePart; ++q) {
          sc[kk][q][0] += prm[q][c] * f.x;
          sc[kk][q][1] += prm[q][c] * f.y;
          sc[kk][q][2] += prm[q][c] * f.z;
          sc[kk][q][3] += prm[q][c] * f.w;
        }
      }
      if (kk >= nk) {
#pragma unroll
        for (int q = 0; q < kLanePart; ++q) {
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[kk][q][j] = __int_as_float(0x7FC00000);
        }
      }
    }
    // a smaller minimum restarts the tie count and n.q sum; then every score
    // equal to the minimum adds to them, in candidate order: the same set
    // and the same order of sums as a running minimum over k
#pragma unroll
    for (int q = 0; q < kLanePart; ++q) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float cmin = sc[0][q][j];
#pragma unroll
        for (int kk = 1; kk < kChunk; ++kk) cmin = fminf(cmin, sc[kk][q][j]);
        const bool lower = cmin < best[q][j];
        best[q][j] = lower ? cmin : best[q][j];
        cnt[q][j] = lower ? 0.f : cnt[q][j];
        nqs[q][j] = lower ? 0.f : nqs[q][j];
      }
    }
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      const float4 nd4 = *reinterpret_cast<const float4*>(st + (13 * kChunk + kk) * kTile);
      const float nd[4] = {nd4.x, nd4.y, nd4.z, nd4.w};
#pragma unroll
      for (int q = 0; q < kLanePart; ++q) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // hit * n.c as the plain version sums it: fma(1, x, s) rounds as
          // s + x, fma(0, x, s) = s
          const float hit = sc[kk][q][j] == best[q][j] ? 1.f : 0.f;
          cnt[q][j] += hit;
          nqs[q][j] = fmaf(hit, nd[j], nqs[q][j]);
        }
      }
    }
  }
  __syncthreads();  // the warp partials below reuse the stage buffers

  // moments: over the lane's 4 points in registers, then warp w + 4 onto
  // warp w, then over warps 0-3 in order (the stage buffers hold the sums)
  float* red = smem;  // [kWarps / 2][kGroup][27]
#pragma unroll
  for (int q = 0; q < kLanePart; ++q) {
    const int pl = lane + 32 * q;
    const bool live_p = p0 + pl < P;
    float m[kMom];
#pragma unroll
    for (int v = 0; v < kMom; ++v) m[v] = 0.f;
    // no branch: a point past B (zero-filled) or a particle past P adds
    // exactly 0 (w = 0, every other factor finite), so the 4 points overlap
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int t = t0 + j;
      const float live = live_p && b0 + t < B ? 1.f : 0.f;
      const float s0 = pts[0][t], s1 = pts[1][t], s2 = pts[2][t];
      const float n0 = pts[3][t], n1 = pts[4][t], n2 = pts[5][t];
      const float vm = pts[6][t];
      float t2 = 0.f;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const float ti = prm[q][3 * i] * s0 + prm[q][3 * i + 1] * s1 +
                         prm[q][3 * i + 2] * s2 + prm[q][9 + i];
        t2 += ti * ti;
      }
      const float d2 = fmaxf(best[q][j] + t2, 0.f);
      const bool gate = (d2 < max_dist) && (best[q][j] < 1e30f);
      const float u0 = prm[q][0] * n0 + prm[q][3] * n1 + prm[q][6] * n2;
      const float u1 = prm[q][1] * n0 + prm[q][4] * n1 + prm[q][7] * n2;
      const float u2 = prm[q][2] * n0 + prm[q][5] * n1 + prm[q][8] * n2;
      const float nts = u0 * s0 + u1 * s1 + u2 * s2;
      const float ntt = prm[q][9] * n0 + prm[q][10] * n1 + prm[q][11] * n2;
      // x / 1 = x: the division only where minima tied
      const float nq = cnt[q][j] > 1.f ? nqs[q][j] / cnt[q][j] : nqs[q][j];
      const float r = nts + ntt - nq;
      float w = max_dist / (max_dist + 3.f * fabsf(r));
      w = w * w * (gate ? 1.f : 0.f) * vm * live;
      const float wr = w * r;
      const float g[6] = {u0, u1, u2, s1 * u2 - s2 * u1, s2 * u0 - s0 * u2, s0 * u1 - s1 * u0};
      int e = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
#pragma unroll
        for (int jj = i; jj < 6; ++jj) m[e++] += w * g[i] * g[jj];
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) m[21 + i] += wr * g[i];
    }
    float* slot = red + ((warp % (kWarps / 2)) * kGroup + pl) * kMom;
    if (warp >= kWarps / 2) {
#pragma unroll
      for (int v = 0; v < kMom; ++v) slot[v] = m[v];
    }
    __syncthreads();
    if (warp < kWarps / 2) {
#pragma unroll
      for (int v = 0; v < kMom; ++v) slot[v] = m[v] + slot[v];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < kMom * kGroup; e += kThreads) {
    const int v = e / kGroup, q = e - v * kGroup;
    if (p0 + q < P) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps / 2; ++w) s += red[(w * kGroup + q) * kMom + v];
      partial[(static_cast<long long>(tile) * kMom + v) * P + p0 + q] = s;
    }
  }
}

// The tiles' partials summed in a fixed order and written as the system
// itself. Block (v, particle group): thread (p, g) sums every kSysGroups-th
// tile (loads coalesced along p), then thread (p, 0) adds the groups in
// order. v < 21 fills H[p] at (i,j) and (j,i) of the row-major upper
// triangle, + 1e-6 on the diagonal; v >= 21 is b[p][v-21].
constexpr int kSysGroups = 8;

__global__ void __launch_bounds__(kGroup * kSysGroups)
plane_system_kernel(const float* __restrict__ partial, int n_tiles, int P,
                    float* __restrict__ h_out, float* __restrict__ b_out) {
  __shared__ float red[kSysGroups][kGroup];
  const int v = blockIdx.x;
  const int pl = threadIdx.x % kGroup, g = threadIdx.x / kGroup;
  const int p = blockIdx.y * kGroup + pl;
  float s = 0.f;
  if (p < P) {
#pragma unroll 16
    for (int t = g; t < n_tiles; t += kSysGroups) {
      s += partial[(static_cast<long long>(t) * kMom + v) * P + p];
    }
  }
  red[g][pl] = s;
  __syncthreads();
  if (g != 0 || p >= P) return;
  s = 0.f;
#pragma unroll
  for (int q = 0; q < kSysGroups; ++q) s += red[q][pl];
  if (v >= 21) {
    b_out[p * 6 + (v - 21)] = s;
    return;
  }
  int i = 0, start = 0;
  while (v >= start + 6 - i) {
    start += 6 - i;
    ++i;
  }
  const int j = i + (v - start);
  const float hv = s + (i == j ? 1e-6f : 0.f);
  h_out[p * 36 + i * 6 + j] = hv;
  h_out[p * 36 + j * 6 + i] = hv;
}

}  // namespace

// Writes the point-to-plane system H [P,6,6] (symmetric + 1e-6 I) into
// `h_out` and b [P,6] into `b_out`; `partial` is scratch of
// ceil(B/32)*27*P floats.
SVN_EXPORT int svn_plane_moments(const void* params, const void* feat13, const void* ndotc,
                                 const void* src_t, const void* nrm_t, const void* vmask,
                                 int P, int K, int B, float max_dist, void* partial,
                                 void* h_out, void* b_out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (B + kTile - 1) / kTile;
  if (P <= 0) return static_cast<int>(cudaSuccess);
  if (n_tiles > 0) {
    const bool vec = B % 4 == 0 && reinterpret_cast<uintptr_t>(feat13) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(ndotc) % 16 == 0;
    const dim3 grid(n_tiles, (P + kGroup - 1) / kGroup);
    SVN_LAUNCH(plane_moments_kernel, grid, kThreads, 0, st)(
        static_cast<const float*>(params), static_cast<const float*>(feat13),
        static_cast<const float*>(ndotc), static_cast<const float*>(src_t),
        static_cast<const float*>(nrm_t), static_cast<const float*>(vmask), P, K, B, max_dist,
        vec ? 1 : 0, static_cast<float*>(partial));
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 sys_grid(kMom, (P + kGroup - 1) / kGroup);
  SVN_LAUNCH(plane_system_kernel, sys_grid, kGroup * kSysGroups, 0, st)(
      static_cast<const float*>(partial), n_tiles, P, static_cast<float*>(h_out),
      static_cast<float*>(b_out));
  return static_cast<int>(cudaGetLastError());
}
