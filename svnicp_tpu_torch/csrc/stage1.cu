// B1: stage-1 bucketed candidate search.
//
// Replaces the TPU kernel svnicp_tpu/kernels/nn_pallas.py:bucketed_candidates
// (body _stage1_kernel). The target is split into k blocked-cyclic groups:
// group c holds rows (o*k + c)*blk + j, j < blk, o < group/blk (the JAX
// package's knn.bucket_block_size). For every source point and group the
// kernel finds the minimum of score = |c|^2 - 2<s, c> over the group's valid
// targets, averages the coordinates of tied minima (as the Pallas kernel's
// one-hot contraction does) and writes the point and its squared distance
// max(best + |s|^2, 0) (+inf for an empty group or an invalid source point).
//
// What bounds it: arithmetic. At the main path's shapes (4096 sources x
// 65,536 targets) it evaluates 2.7e8 scores against ~3 MB of input: far
// above the card's FP32 ridge point, so the loop's instructions per score
// are what count. The design:
//   - a first kernel prepares each target once per launch: the group-major
//     float4 (x, y, z, |c|^2, or 0, 0, 0, +inf for an invalid or padding
//     row) into a [k, group] scratch buffer, so no block divides, gathers or
//     reads the mask again;
//   - a block of 128 threads serves 512 consecutive source points of one
//     group, 4 a thread, and stages the group's targets in pieces of 256
//     with cp.async, two pieces in flight while one is scored (four
//     buffers, one barrier a piece). Every thread reads the same target at
//     once (a shared-memory broadcast), and one float4 feeds 4 scores;
//   - a score is 3 FMAs with -2 s folded in, w + (-2 s).c. A chunk of 8
//     targets gives one minimum per source (7 min instructions), and the
//     running minimum keeps, with no branch, the first chunk that reached
//     it and the last chunk that reached or tied it: about 5 instructions
//     a score in all. Exact ties are rare (duplicate map points, mostly in
//     one chunk, since the map keeps a voxel's points together), so they are
//     summed after the loop, by scoring the targets of chunks first..last
//     again from the scratch buffer with the same three FMAs: the count and
//     coordinate sums of every target equal to the minimum, in target
//     order;
//   - each group's loop ends at its last real row: the rows past the
//     target's end, which pad every group to one length, come last in it.
// At k=32 the grid has only 2 blocks of 4 warps an SM; splitting each
// group's targets over more blocks and merging their minima in a second
// pass was measured and was no faster, so a block scans its whole group.
// FP32 FMA throughout: TF32 would move the argmin. A group with no valid
// target keeps best = +inf and its point 0, as the plain version's.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;               // threads per block
constexpr int kSrc = 4;                     // source points per thread
constexpr int kBlockSrc = kSrc * kThreads;  // source points per block
constexpr int kChunk = 8;                   // targets per minimum
constexpr int kPiece = 256;                 // targets per stage
constexpr int kAhead = 2;                   // pieces in flight while one is scored
constexpr int kStages = kAhead + 2;         // + the piece scored + the one a warp may still read
constexpr int kPrepThreads = 256;

// prep[c * group + pos] = target row (o*k + c)*blk + j, pos = o*blk + j.
__global__ void __launch_bounds__(kPrepThreads)
stage1_prep_kernel(const float* __restrict__ tgt, const uint8_t* __restrict__ tgt_valid,
                   int n_tgt, int k, int blk, int group, float4* __restrict__ prep) {
  const long long i = static_cast<long long>(blockIdx.x) * kPrepThreads + threadIdx.x;
  if (i >= static_cast<long long>(k) * group) return;
  const int c = static_cast<int>(i / group), pos = static_cast<int>(i - static_cast<long long>(c) * group);
  const int o = pos / blk;
  const long long row = (static_cast<long long>(o) * k + c) * blk + (pos - o * blk);
  float4 v = make_float4(0.f, 0.f, 0.f, INFINITY);
  if (row < n_tgt && tgt_valid[row]) {
    const float x = tgt[3 * row], y = tgt[3 * row + 1], z = tgt[3 * row + 2];
    v = make_float4(x, y, z, x * x + y * y + z * z);
  }
  prep[i] = v;
}

// Copy targets [q * kPiece, + kPiece) of a group (past `group`: zero-filled,
// never read) into `st`.
__device__ __forceinline__ void load_piece(float* st, const float* __restrict__ grp, int group,
                                           int q) {
  static_assert(kPiece % kThreads == 0, "whole copies a thread");
#pragma unroll
  for (int r = 0; r < kPiece / kThreads; ++r) {
    const int e = r * kThreads + threadIdx.x, pos = q * kPiece + e;
    cp_async16(st + 4 * e, grp + 4 * static_cast<long long>(pos < group ? pos : 0), pos < group);
  }
  cp_async_commit();
}

// |c|^2 - 2 <s, c> as three FMAs, given -2 s.
__device__ __forceinline__ float score(float m2x, float m2y, float m2z, float4 t) {
  return fmaf(m2x, t.x, fmaf(m2y, t.y, fmaf(m2z, t.z, t.w)));
}

// The final point and squared distance of one (source, group) slot.
__device__ __forceinline__ void write_slot(float* __restrict__ cand, float* __restrict__ d2_out,
                                           long long slot, float best, float cnt, float ax,
                                           float ay, float az, float s2, bool valid) {
  const float inv = 1.f / fmaxf(cnt, 1.f);
  cand[3 * slot] = ax * inv;
  cand[3 * slot + 1] = ay * inv;
  cand[3 * slot + 2] = az * inv;
  d2_out[slot] = (best < 1e30f && valid) ? fmaxf(best + s2, 0.f) : INFINITY;
}

__global__ void __launch_bounds__(kThreads)
stage1_kernel(const float* __restrict__ src, const uint8_t* __restrict__ src_valid,
              const float* __restrict__ prep, int n_src, int n_tgt, int k, int blk, int group,
              float* __restrict__ cand, float* __restrict__ d2_out) {
  __shared__ __align__(16) float smem[kStages * kPiece * 4];
  const int c = blockIdx.y;
  const int b0 = blockIdx.x * kBlockSrc + threadIdx.x * kSrc;  // the thread's first source
  // -2 s (exact), so a score is three FMAs; the running minimum, the first
  // chunk that reached it and the last chunk that reached or tied it
  float m2x[kSrc], m2y[kSrc], m2z[kSrc], best[kSrc];
  int first[kSrc], last[kSrc];
  bool valid[kSrc];
#pragma unroll
  for (int j = 0; j < kSrc; ++j) {
    const int b = b0 + j < n_src ? b0 + j : 0;
    m2x[j] = -2.f * src[3 * b];
    m2y[j] = -2.f * src[3 * b + 1];
    m2z[j] = -2.f * src[3 * b + 2];
    valid[j] = src_valid[b] != 0;
    best[j] = INFINITY;
    first[j] = 0;
    last[j] = 0;
  }

  // the pieces of group c; one copy group per piece (an empty one past the
  // last), so waiting for all but the newest kAhead groups waits for piece
  // i, and the copy of piece i + kAhead goes to the buffer of piece i - 2,
  // which every warp left before the barrier of piece i - 1: a piece needs
  // one barrier
  const float* grp = prep + 4 * static_cast<long long>(c) * group;
  // the group's rows past n_tgt come last (its row blocks are c, c + k, ...):
  // only its first `len_c` positions, rounded up to a chunk, can be valid
  const int n_blocks = (n_tgt + blk - 1) / blk, nb_c = c < n_blocks ? (n_blocks - 1 - c) / k + 1 : 0;
  const int len_c = nb_c == 0 ? 0
                              : ((nb_c - 1) * blk + min(blk, n_tgt - ((nb_c - 1) * k + c) * blk) +
                                 kChunk - 1) / kChunk * kChunk;
  const int n = (len_c + kPiece - 1) / kPiece;
#pragma unroll
  for (int a = 0; a < kAhead; ++a) {
    if (a < n) {
      load_piece(smem + a * kPiece * 4, grp, group, a);
    } else {
      cp_async_commit();
    }
  }
  for (int i = 0; i < n; ++i) {
    if (i + kAhead < n) {
      load_piece(smem + ((i + kAhead) % kStages) * kPiece * 4, grp, group, i + kAhead);
    } else {
      cp_async_commit();
    }
    cp_async_wait<kAhead>();
    __syncthreads();
    const float4* tile = reinterpret_cast<const float4*>(smem + (i % kStages) * kPiece * 4);
    const int base = i * kPiece;
    const int len = min(kPiece, len_c - base);  // a multiple of 8
    // the next chunk's targets are read while this one is scored, so the
    // shared-memory latency hides behind the FMAs
    float4 tg[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) tg[u] = tile[u];
    for (int t = 0; t < len; t += kChunk) {
      const int tn = t + kChunk < len ? t + kChunk : t;
      float4 nx[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) nx[u] = tile[tn + u];
#pragma unroll
      for (int j = 0; j < kSrc; ++j) {
        float cmin = score(m2x[j], m2y[j], m2z[j], tg[0]);
#pragma unroll
        for (int u = 1; u < kChunk; ++u) cmin = fminf(cmin, score(m2x[j], m2y[j], m2z[j], tg[u]));
        const bool lower = cmin < best[j], tie = cmin == best[j];
        best[j] = lower ? cmin : best[j];
        first[j] = lower ? base + t : first[j];
        last[j] = lower || tie ? base + t : last[j];
      }
#pragma unroll
      for (int u = 0; u < kChunk; ++u) tg[u] = nx[u];
    }
  }
  cp_async_wait<0>();

  // the ties: every target of chunks first..last whose score equals the
  // minimum adds to the count and coordinate sums, in target order (the
  // same scores, bit for bit: the same three FMAs on the same operands)
  const float4* grp4 = reinterpret_cast<const float4*>(grp);
#pragma unroll
  for (int j = 0; j < kSrc; ++j) {
    const int b = b0 + j;
    if (b >= n_src) break;
    float cnt = 0.f, ax = 0.f, ay = 0.f, az = 0.f;
    if (best[j] < 1e30f) {
      for (int pos = first[j]; pos <= last[j]; pos += kChunk) {
        float4 t4[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) t4[u] = grp4[pos + u];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          // hit * x as a sum: fma(1, x, a) rounds as a + x, fma(0, x, a) is a
          const float hit = score(m2x[j], m2y[j], m2z[j], t4[u]) == best[j] ? 1.f : 0.f;
          cnt += hit;
          ax = fmaf(hit, t4[u].x, ax);
          ay = fmaf(hit, t4[u].y, ay);
          az = fmaf(hit, t4[u].z, az);
        }
      }
    }
    const float sx = -0.5f * m2x[j], sy = -0.5f * m2y[j], sz = -0.5f * m2z[j];
    write_slot(cand, d2_out, static_cast<long long>(b) * k + c, best[j], cnt, ax, ay, az,
               sx * sx + sy * sy + sz * sz, valid[j]);
  }
}

}  // namespace

// src [n_src,3] f32, src_valid [n_src] u8, tgt [n_tgt,3] f32, tgt_valid
// [n_tgt] u8 -> cand [n_src,k,3] f32, d2 [n_src,k] f32. `group` = the padded
// target length / k, a multiple of 8 (rows at or past n_tgt count as
// invalid). Scratch: `prep` of k*group float4 (16-byte aligned).
SVN_EXPORT int svn_stage1_candidates(const void* src, const void* src_valid,
                                     const void* tgt, const void* tgt_valid,
                                     int n_src, int n_tgt, int k, int blk, int group,
                                     void* prep, void* cand, void* d2, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_src <= 0 || k <= 0) return static_cast<int>(cudaGetLastError());
  if (group % kChunk != 0 || reinterpret_cast<uintptr_t>(prep) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_prep = static_cast<long long>(k) * group;
  if (n_prep > 0) {
    SVN_LAUNCH(stage1_prep_kernel, static_cast<unsigned>((n_prep + kPrepThreads - 1) / kPrepThreads),
               kPrepThreads, 0, st)(static_cast<const float*>(tgt),
                                    static_cast<const uint8_t*>(tgt_valid), n_tgt, k, blk,
                                    group, static_cast<float4*>(prep));
  }
  const dim3 grid((n_src + kBlockSrc - 1) / kBlockSrc, k);
  SVN_LAUNCH(stage1_kernel, grid, kThreads, 0, st)(
      static_cast<const float*>(src), static_cast<const uint8_t*>(src_valid),
      static_cast<const float*>(prep), n_src, n_tgt, k, blk, group, static_cast<float*>(cand),
      static_cast<float*>(d2));
  return static_cast<int>(cudaGetLastError());
}
