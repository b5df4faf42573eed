// B4: fused point-to-point correspondence + Gauss-Newton system.
//
// Replaces the TPU kernel svnicp_tpu/kernels/nn_pallas.py:fused_moments_kb
// (body _moments_kernel_kb, and the block-moment assembly after it). For
// every (particle p, source point b): the min over the K candidates of
// score = params13[p] . feat13[:, k, b] (|c|^2 - 2 <T_p s_b, c>), the mean
// of the tied minima's coordinates (the matched point q), the gate
// d2 = max(best + |T_p s_b|^2, 0) < max_dist (squared distance against the
// unsquared max_dist: the reference quirk) with best < 1e30 (a point with
// no valid candidate has best = +inf), the residual e = (T_p s_b - q) * gate,
// the weight (md/(md + 3|e|))^2 times the point mask (a gated-out pair keeps
// w = 1 with e = 0 and s = 0, so it adds only to sw: the reference's
// identity damping), and the system
//   H = [[sw I, -[m1]x], [[m1]x, tr(m2) I - m2]] + 1e-6 I,   b = [b_t, b_r],
// sw = sum w, m1 = sum w s, m2 = sum w s s^T, b_t = sum R^T (w e),
// b_r = sum s x R^T (w e), with s = s_b * gate. Every distinct entry of H
// and b is one sum over the points: sw, m1 [3], the diagonal of
// tr(m2) I - m2 (sum w (s_j^2 + s_k^2), j, k the other two axes) [3], m2's
// off-diagonal [3], b_t [3] and b_r [3], 16 sums. So H is symmetric by
// construction and no entry waits for another. The 16 sums over a block's
// points go to per-tile partials [n_tiles, 16, P]; a second kernel sums the
// tiles in a fixed order (no atomics, so repeated runs give the same bits)
// and writes H [P,6,6] and b [P,6] itself.
//
// What bounds it: the prepared operands, 16 floats per slot (feat13 and
// cand_t: 27.3 MB at the geode path's shapes P=10, B=4096, K=104, 8.1 us at
// 3.35 TB/s), beside the score's 13 FMAs per (particle, point, slot) and
// the minimum and tie pass after them, which are issued at up to one warp
// instruction per cycle and scheduler (at subt_mrs's P=30, B=8192 about as
// long as the bytes). The design:
//   - the score loop is point_match.cuh's, shared with B5: a block owns a
//     tile of 16 points and serves a group of up to 32 particles (G = 16
//     up to P=16, else 32; grid y takes more groups) from one copy of the
//     tile's operands, staged in chunks of 8 candidates with cp.async, a
//     lane holding one particle and 4 points, chunk-wise minima with an
//     FMA tie pass; the source points and mask come with the first chunk;
//   - the 16 sums: over a lane's 4 points in registers, over the warp's
//     point groups by shuffles, over the block's warps in shared memory,
//     each in a fixed order;
//   - the system kernel reads the partials coalesced along the particles.

#include <stdint.h>

#include "point_match.cuh"

namespace {

constexpr int kMom = 16;  // distinct sums of H and b (see above)

template <int G>
__global__ void __launch_bounds__(kThreads)
point_moments_kernel(const float* __restrict__ params,   // [P,12]
                     const float* __restrict__ feat13,   // [13,K,B]
                     const float* __restrict__ cand_t,   // [3,K,B]
                     const float* __restrict__ src_t,    // [3,B]
                     const float* __restrict__ vmask,    // [B]
                     int P, int K, int B, float max_dist, int vec,
                     float* __restrict__ partial) {      // [n_tiles,16,P]
  using S = Shape<G>;
  static_assert(S::kHand + S::kPtWarps * kMom * G <= kStages * kStage,
                "the hand-over and the warp sums reuse the stage buffers");
  __shared__ __align__(16) float smem[kStages * kStage];
  __shared__ float pts[4][kTile];  // source [3], mask
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slice = warp / S::kPtWarps, pw = warp % S::kPtWarps;
  const int tile = blockIdx.x, b0 = tile * kTile;
  const int slot = lane % G, p = blockIdx.y * G + slot;     // the lane's particle
  const int t0 = pw * S::kWarpPts + lane / G * kLanePts;   // its first point in the tile
  const bool live_p = p < P;

  // params13 = [vec(R), t, 1]; a lane past P scores with 0, ..., 0, 1
  float prm[13];
#pragma unroll
  for (int c = 0; c < 13; ++c) prm[c] = c == 12 ? 1.f : live_p ? params[p * 12 + c] : 0.f;

  // the tile's source points and mask, in the first copy group
  for (int e = threadIdx.x; e < 4 * kTile; e += kThreads) {
    const int row = e / kTile, t = e % kTile, b = b0 + t;
    const float* src = b >= B ? src_t : row < 3 ? src_t + row * B + b : vmask + b;
    cp_async4(&pts[row][t], src, b < B);
  }
  float* red = smem + S::kHand;  // [kPtWarps][16][G]
  match_tile<G>(smem, prm, feat13, cand_t, K, B, b0, vec != 0, slice, pw, lane, t0,
                [&](const Minima& mn) {
    // the 16 sums of the lane's particle over its 4 points. No branch: a
    // point past B (zero-filled) or a particle past P has w = 0 and every
    // other factor finite, so it adds exactly 0.
    float m[kMom];
#pragma unroll
    for (int v = 0; v < kMom; ++v) m[v] = 0.f;
#pragma unroll
    for (int j = 0; j < kLanePts; ++j) {
      const int t = t0 + j;
      const float s0 = pts[0][t], s1 = pts[1][t], s2 = pts[2][t];
      const float vm = live_p ? pts[3][t] : 0.f;
      const float x0 = prm[0] * s0 + prm[1] * s1 + prm[2] * s2 + prm[9];
      const float x1 = prm[3] * s0 + prm[4] * s1 + prm[5] * s2 + prm[10];
      const float x2 = prm[6] * s0 + prm[7] * s1 + prm[8] * s2 + prm[11];
      const float d2 = fmaxf(mn.best[j] + (x0 * x0 + x1 * x1 + x2 * x2), 0.f);
      const bool gate = (d2 < max_dist) && (mn.best[j] < 1e30f);
      const float inv = 1.f / fmaxf(mn.cnt[j], 1.f);
      const float e0 = gate ? x0 - mn.x[j] * inv : 0.f;
      const float e1 = gate ? x1 - mn.y[j] * inv : 0.f;
      const float e2 = gate ? x2 - mn.z[j] * inv : 0.f;
      const float en = sqrtf(e0 * e0 + e1 * e1 + e2 * e2);
      float w = max_dist / (max_dist + 3.f * en);
      w = w * w * vm;
      const float we0 = w * e0, we1 = w * e1, we2 = w * e2;
      const float g0 = gate ? s0 : 0.f, g1 = gate ? s1 : 0.f, g2 = gate ? s2 : 0.f;
      // R^T (w e), R[i][j] = prm[3 i + j]
      const float r0 = prm[0] * we0 + prm[3] * we1 + prm[6] * we2;
      const float r1 = prm[1] * we0 + prm[4] * we1 + prm[7] * we2;
      const float r2 = prm[2] * we0 + prm[5] * we1 + prm[8] * we2;
      const float wg0 = w * g0, wg1 = w * g1, wg2 = w * g2;
      m[0] += w;
      m[1] += wg0;
      m[2] += wg1;
      m[3] += wg2;
      m[4] += wg1 * g1 + wg2 * g2;  // tr(m2) - m2[i][i]
      m[5] += wg0 * g0 + wg2 * g2;
      m[6] += wg0 * g0 + wg1 * g1;
      m[7] += wg0 * g1;  // m2[0][1], [0][2], [1][2]
      m[8] += wg0 * g2;
      m[9] += wg1 * g2;
      m[10] += r0;
      m[11] += r1;
      m[12] += r2;
      m[13] += g1 * r2 - g2 * r1;
      m[14] += g2 * r0 - g0 * r2;
      m[15] += g0 * r1 - g1 * r0;
    }
    // over the warp's point groups (lanes G apart), then over the warps in order
#pragma unroll
    for (int v = 0; v < kMom; ++v) {
#pragma unroll
      for (int off = G; off < 32; off <<= 1) m[v] += __shfl_xor_sync(0xffffffffu, m[v], off);
    }
    if (lane < G) {
#pragma unroll
      for (int v = 0; v < kMom; ++v) red[(pw * kMom + v) * G + slot] = m[v];
    }
  });
  __syncthreads();
  for (int e = threadIdx.x; e < kMom * G; e += kThreads) {
    const int v = e / G, q = e % G, pq = blockIdx.y * G + q;
    if (pq < P) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < S::kPtWarps; ++w) s += red[(w * kMom + v) * G + q];
      partial[(static_cast<long long>(tile) * kMom + v) * P + pq] = s;
    }
  }
}

// H[i][j] and H[j][i] of one particle's row-major H.
__device__ __forceinline__ void put2(float* h, int i, int j, float x) {
  h[i * 6 + j] = x;
  h[j * 6 + i] = x;
}

// The tiles' partials summed in a fixed order and written as the system.
// Block (v, particle group): thread (p, g) sums every kSysGroups-th tile
// (loads coalesced along p), then thread (p, 0) adds the groups in order and
// writes the entries of H[p] (or b[p]) that sum v is.
constexpr int kSysPart = 32;
constexpr int kSysGroups = 16;

__global__ void __launch_bounds__(kSysPart * kSysGroups)
point_system_kernel(const float* __restrict__ partial, int n_tiles, int P,
                    float* __restrict__ h_out, float* __restrict__ b_out) {
  __shared__ float red[kSysGroups][kSysPart];
  const int v = blockIdx.x;
  const int pl = threadIdx.x % kSysPart, g = threadIdx.x / kSysPart;
  const int p = blockIdx.y * kSysPart + pl;
  float s = 0.f;
  if (p < P) {
#pragma unroll 8
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
  float* h = h_out + p * 36;
  switch (v) {
    case 0:  // sw I + 1e-6 I, and the zeros of H
      for (int i = 0; i < 3; ++i) {
        h[i * 7] = s + 1e-6f;
        put2(h, i, (i + 1) % 3, 0.f);
        put2(h, i, i + 3, 0.f);
      }
      break;
    case 1:  // m1 in [m1]x (rows 3-5, columns 0-2) and -[m1]x (its transpose)
      put2(h, 1, 5, s);
      put2(h, 2, 4, -s);
      break;
    case 2:
      put2(h, 2, 3, s);
      put2(h, 0, 5, -s);
      break;
    case 3:
      put2(h, 0, 4, s);
      put2(h, 1, 3, -s);
      break;
    case 4:  // tr(m2) - m2[i][i] + 1e-6
    case 5:
    case 6:
      h[(v - 1) * 7] = s + 1e-6f;
      break;
    case 7:  // -m2[0][1], -m2[0][2], -m2[1][2]
      put2(h, 3, 4, -s);
      break;
    case 8:
      put2(h, 3, 5, -s);
      break;
    case 9:
      put2(h, 4, 5, -s);
      break;
    default:  // b_t, b_r
      b_out[p * 6 + (v - 10)] = s;
  }
}

template <int G>
cudaError_t launch_moments(const float* params, const float* feat13, const float* cand_t,
                           const float* src_t, const float* vmask, int P, int K, int B,
                           float max_dist, int vec, int n_tiles, float* partial,
                           cudaStream_t st) {
  const dim3 grid(n_tiles, (P + G - 1) / G);
  SVN_LAUNCH(point_moments_kernel<G>, grid, kThreads, 0, st)(
      params, feat13, cand_t, src_t, vmask, P, K, B, max_dist, vec, partial);
  return cudaGetLastError();
}

}  // namespace

// Writes the point-to-point system H [P,6,6] (symmetric, + 1e-6 I) into
// `h_out` and b [P,6] into `b_out`; `partial` is scratch of
// ceil(B/16)*16*P floats.
SVN_EXPORT int svn_point_moments(const void* params, const void* feat13, const void* cand_t,
                                 const void* src_t, const void* vmask, int P, int K, int B,
                                 float max_dist, void* partial, void* h_out, void* b_out,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (B + kTile - 1) / kTile;
  if (P <= 0) return static_cast<int>(cudaSuccess);
  if (n_tiles > 0) {
    const int vec = B % 4 == 0 && reinterpret_cast<uintptr_t>(feat13) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(cand_t) % 16 == 0;
    const auto* prm = static_cast<const float*>(params);
    const auto* f13 = static_cast<const float*>(feat13);
    const auto* cnd = static_cast<const float*>(cand_t);
    const auto* src = static_cast<const float*>(src_t);
    const auto* msk = static_cast<const float*>(vmask);
    auto* out = static_cast<float*>(partial);
    const cudaError_t err =
        P <= 16 ? launch_moments<16>(prm, f13, cnd, src, msk, P, K, B, max_dist, vec, n_tiles, out, st)
                : launch_moments<32>(prm, f13, cnd, src, msk, P, K, B, max_dist, vec, n_tiles, out, st);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 sys_grid(kMom, (P + kSysPart - 1) / kSysPart);
  SVN_LAUNCH(point_system_kernel, sys_grid, kSysPart * kSysGroups, 0, st)(
      static_cast<const float*>(partial), n_tiles, P, static_cast<float*>(h_out),
      static_cast<float*>(b_out));
  return static_cast<int>(cudaGetLastError());
}
