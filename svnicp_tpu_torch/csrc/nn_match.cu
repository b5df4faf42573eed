// B5: fused per-iteration 1-NN among the stage-1 candidates (the SVGD loop's
// correspondence search).
//
// Replaces the TPU kernel svnicp_tpu/kernels/nn_pallas.py:fused_nn_match
// (body _kernel). For every (particle p, source point b): the min over the K
// candidate slots of score = params13[p] . feat13[:, k, b]
// (|c|^2 - 2 <T_p s_b, c>, +inf at an invalid slot) and the mean of the
// coordinates of the slots that tie at that minimum (the matched point).
// Outputs: matched [3, P, B] and best [P, B]; the caller adds |T_p s_b|^2
// for the squared distance and applies its gate and point mask. A slot
// scoring +inf ties with the +inf start value, exactly as the plain
// version's `score == best` does, so a point with no valid candidate
// averages its (finite) slot coordinates and keeps best = +inf, which the
// caller's gate rejects: no inf - inf anywhere.
//
// What bounds it: the function needs each slot's 3 coordinates and |c|^2
// once and writes 4 floats per (particle, point); in the operand form it
// reads (B4's prepared operands, 13 feature floats plus 3 coordinates a
// slot) those 16 floats cross device memory once per launch for P <= 32,
// and the 13 FMAs per (particle, point, slot), the minimum and the tie pass
// are issued at up to one warp instruction per cycle and scheduler. The
// design is B4's match half, point_match.cuh's score loop: a block owns a
// tile of 16 points and serves a group of up to 32 particles (G = 16 up to
// P=16, else 32; grid y takes more groups) from one copy of the tile's
// operands in shared memory. Its epilogue writes each lane's 4 points as
// one float4 of each output row along B.

#include <stdint.h>

#include "point_match.cuh"

namespace {

template <int G>
__global__ void __launch_bounds__(kThreads)
nn_match_kernel(const float* __restrict__ params,   // [P,12]
                const float* __restrict__ feat13,   // [13,K,B]
                const float* __restrict__ cand_t,   // [3,K,B]
                int P, int K, int B, int vec,
                float* __restrict__ matched,        // [3,P,B]
                float* __restrict__ best_out) {     // [P,B]
  using S = Shape<G>;
  __shared__ __align__(16) float smem[kStages * kStage];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int slice = warp / S::kPtWarps, pw = warp % S::kPtWarps;
  const int b0 = blockIdx.x * kTile;
  const int p = blockIdx.y * G + lane % G;                  // the lane's particle
  const int t0 = pw * S::kWarpPts + lane / G * kLanePts;   // its first point in the tile
  const bool live_p = p < P;

  // params13 = [vec(R), t, 1]; a lane past P scores with 0, ..., 0, 1
  float prm[13];
#pragma unroll
  for (int c = 0; c < 13; ++c) prm[c] = c == 12 ? 1.f : live_p ? params[p * 12 + c] : 0.f;

  match_tile<G>(smem, prm, feat13, cand_t, K, B, b0, vec != 0, slice, pw, lane, t0,
                [&](const Minima& mn) {
    const int b = b0 + t0;
    if (!live_p || b >= B) return;
    float q[3][kLanePts];
#pragma unroll
    for (int j = 0; j < kLanePts; ++j) {
      const float inv = 1.f / fmaxf(mn.cnt[j], 1.f);
      q[0][j] = mn.x[j] * inv;
      q[1][j] = mn.y[j] * inv;
      q[2][j] = mn.z[j] * inv;
    }
    const long long pb = static_cast<long long>(P) * B;
    const long long o = static_cast<long long>(p) * B + b;
    if (vec) {  // B % 4 == 0, so b (a multiple of 4) .. b + 3 are all real
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        *reinterpret_cast<float4*>(matched + c * pb + o) =
            make_float4(q[c][0], q[c][1], q[c][2], q[c][3]);
      }
      *reinterpret_cast<float4*>(best_out + o) =
          make_float4(mn.best[0], mn.best[1], mn.best[2], mn.best[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kLanePts; ++j) {
        if (b + j < B) {
#pragma unroll
          for (int c = 0; c < 3; ++c) matched[c * pb + o + j] = q[c][j];
          best_out[o + j] = mn.best[j];
        }
      }
    }
  });
}

template <int G>
cudaError_t launch_match(const float* params, const float* feat13, const float* cand_t,
                         int P, int K, int B, int vec, float* matched, float* best,
                         cudaStream_t st) {
  const dim3 grid((B + kTile - 1) / kTile, (P + G - 1) / G);
  SVN_LAUNCH(nn_match_kernel<G>, grid, kThreads, 0, st)(params, feat13, cand_t, P, K, B,
                                                        vec, matched, best);
  return cudaGetLastError();
}

}  // namespace

// Writes matched [3,P,B] (the tie-averaged nearest candidate of every
// particle and point) and best [P,B] (its score |c|^2 - 2 <T s, c>).
SVN_EXPORT int svn_nn_match(const void* params, const void* feat13, const void* cand_t,
                            int P, int K, int B, void* matched, void* best, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (P <= 0 || B <= 0) return static_cast<int>(cudaGetLastError());
  const auto aligned = [](const void* x) { return reinterpret_cast<uintptr_t>(x) % 16 == 0; };
  const int vec = B % 4 == 0 && aligned(feat13) && aligned(cand_t) && aligned(matched) &&
                  aligned(best);
  const auto* prm = static_cast<const float*>(params);
  const auto* f13 = static_cast<const float*>(feat13);
  const auto* cnd = static_cast<const float*>(cand_t);
  auto* m = static_cast<float*>(matched);
  auto* b = static_cast<float*>(best);
  const cudaError_t err = P <= 16 ? launch_match<16>(prm, f13, cnd, P, K, B, vec, m, b, st)
                                  : launch_match<32>(prm, f13, cnd, P, K, B, vec, m, b, st);
  return static_cast<int>(err);
}
