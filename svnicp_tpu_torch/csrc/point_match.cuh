// The 1-NN score loop shared by B4 (point_moments.cu) and B5 (nn_match.cu).
//
// For every (particle p, source point b) of a tile of 16 points: the min
// over the K candidate slots of score = params13[p] . feat13[:, k, b]
// (|c|^2 - 2 <T_p s_b, c>, +inf at an invalid slot) and the count and
// coordinate sums of the slots that tie at that minimum. The layout:
//   - a block owns a tile of 16 points and serves a group of up to 32
//     particles from one copy of the tile's operands in shared memory, so
//     the operands cross device memory once per launch for P <= 32;
//   - the tile is staged in chunks of 8 candidates with cp.async, two
//     chunks in flight while one is scored (four buffers, one barrier a
//     chunk);
//   - a lane holds one particle and 4 points, whose operands are one float4
//     per candidate and row that the lanes of a point group read at once
//     (a broadcast). The particle group has G = 16 or 32 lanes, fixed at
//     compile time (grid y takes more groups above G), so a warp holds
//     32/G point groups;
//   - a block has 4 warps. At G = 32 they cover the tile's 16 points; at
//     G = 16 two warps do, and the two such pairs of warps share each
//     chunk's candidates and hand their running minima over at the end;
//   - a chunk's scores stay in registers: one min over them, then one
//     equality pass adds the ties as hit * x by an FMA, in candidate order
//     within a warp.
// A slot scoring +inf ties with the +inf start value, as the plain
// version's `score == best` does: a point whose slots are all invalid keeps
// best = +inf and sums every slot's (finite) coordinates.
#pragma once

#include "common.cuh"

namespace {

constexpr int kTile = 16;              // source points per block
constexpr int kLanePts = 4;            // points per lane: one float4
constexpr int kChunk = 8;              // candidates per stage
constexpr int kRows = 16 * kChunk;     // 13 feature rows + 3 coordinates, per candidate
constexpr int kStage = kRows * kTile;  // floats per stage
constexpr int kAhead = 2;              // chunks in flight while one is scored
constexpr int kStages = kAhead + 2;    // + the chunk scored + the one a warp may still read
constexpr int kWarps = 4;              // warps per block
constexpr int kThreads = 32 * kWarps;

// The lanes of a block whose particle group has G particles: a lane holds
// one particle and 4 points, a warp covers 32 / G groups of 4 points, and
// the tile's points take kPtWarps warps; the block's 4 warps are kSlices
// such sets, which share each chunk's candidates (kSliceK each).
template <int G>
struct Shape {
  static constexpr int kWarpPts = 32 / G * kLanePts;   // points per warp
  static constexpr int kPtWarps = kTile / kWarpPts;
  static constexpr int kSlices = kWarps / kPtWarps;
  static constexpr int kSliceK = kChunk / kSlices;
  static constexpr int kState = 5 * kLanePts;          // running minima: best, count, x, y, z
  static constexpr int kHand = (kSlices - 1) * kState * kPtWarps * 32;  // minima handed over
  static_assert(kTile % kWarpPts == 0 && kWarps % kPtWarps == 0 && kChunk % kSlices == 0,
                "a tile holds whole warps, a block whole slices, a chunk whole slices");
  static_assert(kHand <= kStages * kStage, "the hand-over reuses the stage buffers");
};

// A lane's running minima over its 4 points: the best score, the number of
// slots tied at it and their coordinate sums.
struct Minima {
  float best[kLanePts], cnt[kLanePts], x[kLanePts], y[kLanePts], z[kLanePts];
};

// Copy candidates [k0, k0 + kChunk) of the tile's points b0.. into `st`:
// row c * kChunk + kk (c < 13: feat13 row c, else cand_t row c - 13), kTile
// floats each. Slots past B are zero-filled; slots past K too, but for a
// NaN bias (the |c|^2 row), so their score is NaN: no minimum, no tie.
#define kNaN __int_as_float(0x7FC00000)
__device__ __forceinline__ void load_chunk(float* st, const float* __restrict__ feat13,
                                           const float* __restrict__ cand_t, int K, int B,
                                           int k0, int b0, bool vec) {
  const long long kb = static_cast<long long>(K) * B;
  if (vec) {  // B % 4 == 0: four 16-byte copies a thread. Thread (warp w, lane l)
              // copies candidate k0 + l / 4 of points b0 + 4 (l % 4) .. + 3 in rows
              // w, w + 4, w + 8 and w + 12: one address and test a chunk, not a copy
    static_assert(kTile == 16 && kChunk == 8 && kThreads == 128, "the copy map below");
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, kk = lane >> 2, seg = lane & 3;
    const int k = k0 + kk, b = b0 + seg * 4;
    const bool ok = k < K && b < B;
    const long long off = ok ? static_cast<long long>(k) * B + b : 0;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int c = w + 4 * n;
      float* dst = st + (c * kChunk + kk) * kTile + seg * 4;
      const float* src = c < 13 ? feat13 + c * kb + off : cand_t + (c - 13) * kb + off;
      if (c == 12 && k >= K) {
        *reinterpret_cast<float4*>(dst) = make_float4(kNaN, kNaN, kNaN, kNaN);
      } else {
        cp_async16(dst, src, ok);
      }
    }
  } else {  // kept rolled: unrolled, its addresses hoisted out of the chunk loop spill
#pragma unroll 1
    for (int e = threadIdx.x; e < kRows * kTile; e += kThreads) {
      const int row = e / kTile, t = e % kTile;
      const int c = row / kChunk, k = k0 + (row - c * kChunk), b = b0 + t;
      const bool ok = k < K && b < B;
      const long long off = static_cast<long long>(k) * B + b;
      const float* src = !ok ? feat13 : c < 13 ? feat13 + c * kb + off : cand_t + (c - 13) * kb + off;
      if (c == 12 && k >= K) {
        st[row * kTile + t] = kNaN;
      } else {
        cp_async4(st + row * kTile + t, src, ok);
      }
    }
  }
  cp_async_commit();
}

// The score loop of the tile of points b0.. for the lane's particle, whose
// params13 = [vec(R), t, 1] are `prm` (a lane past P scores with 0, ..., 0,
// 1), over the stage buffers `smem` (kStages * kStage floats). Copies the
// caller issued before the call join the first chunk's copy group. On
// return the stage buffers are free again, and the lanes of slice 0 have
// called epi(mn) with the minima of their points over all K slots.
template <int G, typename Epilogue>
__device__ __forceinline__ void match_tile(float* smem, const float (&prm)[13],
                                           const float* __restrict__ feat13,
                                           const float* __restrict__ cand_t, int K, int B,
                                           int b0, bool vec, int slice, int pw, int lane,
                                           int t0, Epilogue&& epi) {
  using S = Shape<G>;
  constexpr int kSliceK = S::kSliceK;
  Minima mn;
#pragma unroll
  for (int j = 0; j < kLanePts; ++j) {
    mn.best[j] = INFINITY;
    mn.cnt[j] = 0.f;
    mn.x[j] = 0.f;
    mn.y[j] = 0.f;
    mn.z[j] = 0.f;
  }

  // one copy group per chunk (an empty one past the last chunk), so waiting
  // for all but the newest kAhead groups waits for chunk ch. The copy of
  // chunk ch + kAhead goes to the buffer of chunk ch - 2, which every warp
  // left before the barrier of chunk ch - 1: a chunk needs one barrier.
  const int n_chunks = (K + kChunk - 1) / kChunk;
#pragma unroll
  for (int a = 0; a < kAhead; ++a) {
    if (a < n_chunks) {
      load_chunk(smem + a * kStage, feat13, cand_t, K, B, a * kChunk, b0, vec);
    } else {
      cp_async_commit();
    }
  }
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int next = ch + kAhead;
    if (next < n_chunks) {
      load_chunk(smem + (next % kStages) * kStage, feat13, cand_t, K, B, next * kChunk, b0,
                 vec);
    } else {
      cp_async_commit();
    }
    cp_async_wait<kAhead>();
    __syncthreads();
    // the slice's candidates of the chunk, slice * kSliceK + i
    const float* st = smem + (ch % kStages) * kStage + slice * kSliceK * kTile + t0;
    float sc[kSliceK][kLanePts];
#pragma unroll
    for (int i = 0; i < kSliceK; ++i) {
#pragma unroll
      for (int j = 0; j < kLanePts; ++j) sc[i][j] = 0.f;
#pragma unroll
      for (int c = 0; c < 13; ++c) {
        const float4 f = *reinterpret_cast<const float4*>(st + (c * kChunk + i) * kTile);
        sc[i][0] += prm[c] * f.x;
        sc[i][1] += prm[c] * f.y;
        sc[i][2] += prm[c] * f.z;
        sc[i][3] += prm[c] * f.w;
      }
    }
    // a smaller minimum restarts the tie count and coordinate sums; then
    // every score equal to the minimum adds to them, in candidate order: the
    // same set and the same order of sums as a running minimum over k.
#pragma unroll
    for (int j = 0; j < kLanePts; ++j) {
      float cmin = sc[0][j];
#pragma unroll
      for (int i = 1; i < kSliceK; ++i) cmin = fminf(cmin, sc[i][j]);
      const bool lower = cmin < mn.best[j];
      mn.best[j] = lower ? cmin : mn.best[j];
      mn.cnt[j] = lower ? 0.f : mn.cnt[j];
      mn.x[j] = lower ? 0.f : mn.x[j];
      mn.y[j] = lower ? 0.f : mn.y[j];
      mn.z[j] = lower ? 0.f : mn.z[j];
    }
#pragma unroll
    for (int i = 0; i < kSliceK; ++i) {
      const float4 x4 = *reinterpret_cast<const float4*>(st + (13 * kChunk + i) * kTile);
      const float4 y4 = *reinterpret_cast<const float4*>(st + (14 * kChunk + i) * kTile);
      const float4 z4 = *reinterpret_cast<const float4*>(st + (15 * kChunk + i) * kTile);
      const float cx[4] = {x4.x, x4.y, x4.z, x4.w};
      const float cy[4] = {y4.x, y4.y, y4.z, y4.w};
      const float cz[4] = {z4.x, z4.y, z4.z, z4.w};
#pragma unroll
      for (int j = 0; j < kLanePts; ++j) {
        // hit * x as the plain version sums it: fma(1, x, q) rounds as q + x
        const float hit = sc[i][j] == mn.best[j] ? 1.f : 0.f;
        mn.cnt[j] += hit;
        mn.x[j] = fmaf(hit, cx[j], mn.x[j]);
        mn.y[j] = fmaf(hit, cy[j], mn.y[j]);
        mn.z[j] = fmaf(hit, cz[j], mn.z[j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the hand-over below reuses the stage buffers

  // slices 1.. hand their running minima to slice 0, which takes them in
  // slice order: a smaller minimum replaces, an equal one adds its ties.
  // (The set of ties is the plain version's; three or more tied across
  // slices are summed in another order.)
  constexpr int kLanes = S::kPtWarps * 32;
  float* hand = smem;  // [kSlices - 1][kState][kLanes]
  const int li = pw * 32 + lane;
  if (slice > 0) {
    float* h = hand + (slice - 1) * S::kState * kLanes + li;
#pragma unroll
    for (int j = 0; j < kLanePts; ++j) {
      h[(5 * j) * kLanes] = mn.best[j];
      h[(5 * j + 1) * kLanes] = mn.cnt[j];
      h[(5 * j + 2) * kLanes] = mn.x[j];
      h[(5 * j + 3) * kLanes] = mn.y[j];
      h[(5 * j + 4) * kLanes] = mn.z[j];
    }
  }
  __syncthreads();
  if (slice == 0) {
    for (int sl = 1; sl < S::kSlices; ++sl) {
      const float* h = hand + (sl - 1) * S::kState * kLanes + li;
#pragma unroll
      for (int j = 0; j < kLanePts; ++j) {
        const float b1 = h[(5 * j) * kLanes];
        if (b1 < mn.best[j]) {
          mn.best[j] = b1;
          mn.cnt[j] = h[(5 * j + 1) * kLanes];
          mn.x[j] = h[(5 * j + 2) * kLanes];
          mn.y[j] = h[(5 * j + 3) * kLanes];
          mn.z[j] = h[(5 * j + 4) * kLanes];
        } else if (b1 == mn.best[j]) {
          mn.cnt[j] += h[(5 * j + 1) * kLanes];
          mn.x[j] += h[(5 * j + 2) * kLanes];
          mn.y[j] += h[(5 * j + 3) * kLanes];
          mn.z[j] += h[(5 * j + 4) * kLanes];
        }
      }
    }
    epi(static_cast<const Minima&>(mn));
  }
}

}  // namespace
