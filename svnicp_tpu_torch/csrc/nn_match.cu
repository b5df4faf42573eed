// B5: fused per-iteration 1-NN among the stage-1 candidates (the SVGD loop's
// correspondence search).
//
// Replaces the TPU kernel svnicp_tpu/kernels/nn_pallas.py:fused_nn_match
// (body _kernel). For every (particle p, source point b): the min over the K
// candidate slots of score = params13[p] . feat13[:, k, b]
// (|c|^2 - 2 <T_p s_b, c>, +inf at an invalid slot) and the mean of the
// coordinates of the slots that tie at that minimum (the matched point).
// Outputs: matched [3, P, B] and best [P, B]; the caller adds |T_p s_b|^2
// for the squared distance. A slot scoring +inf ties with the +inf start
// value, exactly as the plain version's `score == best` does, so a point with
// no valid candidate averages its (finite) slot coordinates and keeps
// best = +inf, which the caller's gate rejects: no inf - inf anywhere.
//
// What bounds it: the function needs each slot's 3 coordinates and |c|^2
// once (6.6 MB at the SVGD path's shapes, P=30, B=4096, K=100) and writes
// 4 floats per (particle, point) (2 MB): ~2.6 us of bytes at 3.35 TB/s,
// against ~1e8 operations in the form |c|^2 - 2 c.(T s) (~1.5 us of FP32).
// This first kernel instead reads B4's prepared operands, 13 feature floats
// plus 3 coordinates per slot (27 MB), and does 13 FMAs per (particle,
// slot): points sit on threads, so every load is coalesced along B, and a
// block serves kPart particles held in shared memory, so each slot's 16
// floats are read once per group of kPart particles; the running minimum,
// tie count and coordinate sums of those particles stay in registers.
// Two particles per block: more read the slots fewer times but leave fewer
// threads to hide the load latency (at P=30, B=4096: 480 blocks).
// Reading only coordinates and staging a point tile's candidates in shared
// memory across all particles is the later, faster design.

#include "common.cuh"

namespace {

constexpr int kPts = 128;   // source points per block (one per thread)
constexpr int kPart = 2;    // particles per block
static_assert(kPart * 13 <= kPts, "one thread loads each particle parameter");

__global__ void __launch_bounds__(kPts)
nn_match_kernel(const float* __restrict__ params,   // [P,12]
                const float* __restrict__ feat13,   // [13,K,B]
                const float* __restrict__ cand_t,   // [3,K,B]
                int P, int K, int B,
                float* __restrict__ matched,        // [3,P,B]
                float* __restrict__ best_out) {     // [P,B]
  __shared__ float prm[kPart][13];
  const int tid = threadIdx.x;
  const int b = blockIdx.x * kPts + tid;
  const int p0 = blockIdx.y * kPart;
  if (tid < kPart * 13) {
    const int q = tid / 13, c = tid - q * 13;
    const int p = p0 + q;
    prm[q][c] = p < P ? (c < 12 ? params[p * 12 + c] : 1.f) : 0.f;
  }
  __syncthreads();
  if (b >= B) return;

  float best[kPart], cnt[kPart], qx[kPart], qy[kPart], qz[kPart];
#pragma unroll
  for (int q = 0; q < kPart; ++q) {
    best[q] = INFINITY;
    cnt[q] = 0.f;
    qx[q] = 0.f;
    qy[q] = 0.f;
    qz[q] = 0.f;
  }
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

  const long long pb = static_cast<long long>(P) * B;
#pragma unroll
  for (int q = 0; q < kPart; ++q) {
    const int p = p0 + q;
    if (p < P) {
      const long long o = static_cast<long long>(p) * B + b;
      const float inv = 1.f / fmaxf(cnt[q], 1.f);
      matched[o] = qx[q] * inv;
      matched[pb + o] = qy[q] * inv;
      matched[2 * pb + o] = qz[q] * inv;
      best_out[o] = best[q];
    }
  }
}

}  // namespace

// Writes matched [3,P,B] (the tie-averaged nearest candidate of every
// particle and point) and best [P,B] (its score |c|^2 - 2 <T s, c>).
SVN_EXPORT int svn_nn_match(const void* params, const void* feat13, const void* cand_t,
                            int P, int K, int B, void* matched, void* best, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P > 0 && B > 0) {
    const dim3 grid((B + kPts - 1) / kPts, (P + kPart - 1) / kPart);
    SVN_LAUNCH(nn_match_kernel, grid, kPts, 0, st)(
        static_cast<const float*>(params), static_cast<const float*>(feat13),
        static_cast<const float*>(cand_t), P, K, B, static_cast<float*>(matched),
        static_cast<float*>(best));
  }
  return static_cast<int>(cudaGetLastError());
}
