// B3: fused SVN ensemble update (Newton solve + Stein coupling + pose update).
//
// Replaces the TPU kernel svnicp_tpu/kernels/stein_pallas.py:stein_update
// (body stein_body via _kernel; helpers lower_median_bisect and
// _rot_mats_unrolled). One block updates the whole ensemble:
//   coords_i = [t_i, so3_log(R_i)]; optional MAP prior (H += diag(inv),
//   b += coords * inv, kernel coordinates whitened by the prior std);
//   newton_i = H_i^-1 b_i by the unrolled 6x6 Cholesky with the pivot floor;
//   h_mean = mean_i H_i; x = coords centred on the ensemble mean (the f32
//   cancellation fix of the JAX kernel: x*ksum - K@x on uncentred
//   coordinates loses ~1e-3 relative once the ensemble converges);
//   bandwidth = lower median of the P^2 squared distances / log(P+1), the
//   median EXACT: equal to sort(sq)[(P^2-1)//2] bit for bit;
//   stein_i = (sum_j K_ij (-newton_j) + h_mean^-1 (2/bw)(x_i ksum_i - K x))
//   / ksum_i, clipped to norm max_dist; R_i <- R_i exp(w^),
//   t_i <- R_i_new J_l(w) dt + t_i; and the exit statistics
//   mean_i |stein_i| and |mean_i stein_i|.
//
// What bounds it: neither bytes (a few KB) nor arithmetic (~80 flops per
// pair, 3e5 at P=64) but the launch and the block's dependency chain. The
// design spreads the pair work over up to 512 threads and keeps the chain
// short:
//   - the operands are staged in shared memory by asynchronous copies, all
//     in flight at once;
//   - the per-particle solves, so3_log and the pose update run one thread
//     per particle;
//   - the P^2 squared distances are computed once into shared memory
//     (P <= kStoreMaxP; above, each pass recomputes them from the shared
//     coordinates, with the same instructions and so the same bits);
//   - the lower median is a radix select on the distances' bit patterns
//     (non-negative floats order like their uint32 patterns): 4 passes of
//     8-bit digits over the unordered pairs, each a 256-bin shared histogram
//     (integer atomics) that every warp then scans for itself: one barrier
//     a pass, where a bisection takes 31 passes of two;
//   - the kernel row sums (ksum, K x, K (-newton)) take a group of up to 32
//     threads per row, over every g-th column, reduced by shuffles within
//     the group; h_mean, the coordinate mean and the exit sums spread each
//     column over the block's threads, then add the partial sums in order.
// Every sum runs in a fixed order (no float atomics), so repeated runs give
// the same bits. Nothing is padded: the kernel runs at the true P (<= 512).

#include "common.cuh"

namespace {

constexpr int kMaxP = 512;
constexpr int kThreads = 512;       // the most threads a launch uses
constexpr int kStoreMaxP = 128;     // distances kept in shared memory up to here
constexpr int kRow = 13;            // ksum, K x [6], K (-newton) [6]
constexpr int kHistPad = 256 + 32;  // a padded radix histogram

// dynamic shared memory in floats: xs, nns [P,6], r [P,9], t [P,3], and a
// region that first stages hess [P,36] and b [P,6], then holds H and x
// [P,42], then the row sums [P,13] and (P <= kStoreMaxP) the distances [P*P]
__host__ __device__ constexpr int region_floats(int p) {
  return (42 * p > kRow * p + (p <= kStoreMaxP ? p * p : 0))
             ? 42 * p
             : kRow * p + (p <= kStoreMaxP ? p * p : 0);
}
__host__ __device__ constexpr int smem_floats(int p) { return 24 * p + region_floats(p); }

constexpr int max_smem_bytes() {
  int m = 0;
  for (int p = 1; p <= kMaxP; ++p) m = smem_floats(p) > m ? smem_floats(p) : m;
  return m * 4;
}

__device__ __forceinline__ void chol_solve6(const float* a, const float* b, float* x) {
  float l[6][6];
  float linv[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float s = a[j * 6 + j];
#pragma unroll
    for (int k = 0; k < j; ++k) s -= l[j][k] * l[j][k];
    s = fmaxf(s, 1e-12f * (1.f + fabsf(a[j * 6 + j])));
    l[j][j] = sqrtf(s);
    linv[j] = 1.f / l[j][j];
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float t = a[i * 6 + j];
#pragma unroll
      for (int k = 0; k < j; ++k) t -= l[i][k] * l[j][k];
      l[i][j] = t * linv[j];
    }
  }
  float y[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= l[i][k] * y[k];
    y[i] = s * linv[i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= l[k][i] * x[k];
    x[i] = s * linv[i];
  }
}

__device__ __forceinline__ void taylor_coeffs_sq(float a2, float* sinc, float* cosc,
                                                 float* sinc3) {
  const bool small = a2 < 1e-6f;
  const float a = sqrtf(small ? 1.f : a2);
  *sinc = small ? 1.f - a2 / 6.f : sinf(a) / a;
  *cosc = small ? 0.5f - a2 / 24.f : (1.f - cosf(a)) / (a * a);
  *sinc3 = small ? 1.f / 6.f - a2 / 120.f : (a - sinf(a)) / (a * a * a);
}

__device__ __forceinline__ void so3_log(const float* R, float* w) {
  const float tr = R[0] + R[4] + R[8];
  const float cos_a = fminf(fmaxf(0.5f * (tr - 1.f), -1.f), 1.f);
  const float v0 = (R[7] - R[5]) * 0.5f;
  const float v1 = (R[2] - R[6]) * 0.5f;
  const float v2 = (R[3] - R[1]) * 0.5f;
  const float s2 = v0 * v0 + v1 * v1 + v2 * v2;
  const bool small = s2 < 1e-12f;
  const bool near_pi = small && cos_a < 0.f;
  const float sin_a = sqrtf(small ? 1.f : s2);
  const float angle = atan2f(sin_a, cos_a);
  const float factor = small ? 1.f + (1.f - cos_a) / 3.f : angle / sin_a;
  w[0] = near_pi ? 0.f : factor * v0;
  w[1] = near_pi ? 0.f : factor * v1;
  w[2] = near_pi ? 0.f : factor * v2;
}

__device__ __forceinline__ float sqdist6(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll
  for (int d = 0; d < 6; ++d) {
    const float e = a[d] - b[d];
    s += e * e;
  }
  return s;
}

// out[c] = sum over rows j < n of src[j * stride + c], c < ncol <= 64, by
// the whole block in a fixed order: thread t sums column t % ncol over rows
// t / ncol, t / ncol + G, ... (G = the threads' row groups), then thread c
// adds its column's G partial sums in order. Ends with a barrier.
__device__ __forceinline__ void column_sums(const float* src, int stride, int n, int ncol,
                                            float* part, float* out) {
  const int t = threadIdx.x;
  const int groups = max(1, min(static_cast<int>(blockDim.x) / ncol, n));
  if (t < groups * ncol) {
    const int c = t % ncol;
    float s = 0.f;
    for (int j = t / ncol; j < n; j += groups) s += src[j * stride + c];
    part[t] = s;
  }
  __syncthreads();
  if (t < ncol) {
    float s = 0.f;
    for (int g = 0; g < groups; ++g) s += part[g * ncol + t];
    out[t] = s;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads, 1)
stein_kernel(const float* __restrict__ hess, const float* __restrict__ bvec,
             const float* __restrict__ r_in, const float* __restrict__ t_in,
             const float* __restrict__ prior, int P, float max_dist,
             float* __restrict__ r_out, float* __restrict__ t_out,
             float* __restrict__ stats) {
  extern __shared__ float smem[];
  float* xs = smem;               // [P,6] kernel coordinates (centred after step 2)
  float* nns = xs + 6 * P;        // [P,6] -newton
  float* rs = nns + 6 * P;        // [P,9]
  float* ts = rs + 9 * P;         // [P,3]
  float* region = ts + 3 * P;
  float* hs = region;             // [P,36] staged hess (step 1)
  float* bs = hs + 36 * P;        // [P,6] staged b (step 1)
  float* hx = region;             // [P,42] H with the prior, x (step 2)
  float* rows = region;           // [P,13] row sums (step 4 on)
  float* sqs = rows + kRow * P;   // [P*P] distances when P <= kStoreMaxP
  __shared__ float part[kThreads];
  __shared__ float sums[42];
  __shared__ float hmean[36];
  // three radix histograms in turn; bin b at b + b / 8, so the scan's
  // 8 consecutive bins a lane fall in 8 banks
  __shared__ unsigned hist[3 * kHistPad];
  __shared__ unsigned unique_bits;

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int lane = tid & 31;
  const float fp = static_cast<float>(P);
  const bool store = P <= kStoreMaxP;

  // 0. stage the operands with asynchronous copies, all in flight at once
  for (int e = tid; e < 36 * P; e += nthreads) cp_async4(hs + e, hess + e, true);
  for (int e = tid; e < 6 * P; e += nthreads) cp_async4(bs + e, bvec + e, true);
  for (int e = tid; e < 9 * P; e += nthreads) cp_async4(rs + e, r_in + e, true);
  for (int e = tid; e < 3 * P; e += nthreads) cp_async4(ts + e, t_in + e, true);
  cp_async_commit();
  for (int e = tid; e < 2 * kHistPad; e += nthreads) hist[e] = 0u;
  cp_async_wait<0>();
  __syncthreads();

  // 1. per particle: coordinates, prior, Newton step; then H (with the
  //    prior) and x go to hx, over the staged operands (after a barrier)
  float h[36], x[6];
  if (tid < P) {
    const int i = tid;
    float c[6];
    c[0] = ts[i * 3];
    c[1] = ts[i * 3 + 1];
    c[2] = ts[i * 3 + 2];
    so3_log(rs + i * 9, c + 3);
    float b[6];
#pragma unroll
    for (int e = 0; e < 36; ++e) h[e] = hs[i * 36 + e];
#pragma unroll
    for (int d = 0; d < 6; ++d) b[d] = bs[i * 6 + d];
    if (prior != nullptr) {
#pragma unroll
      for (int d = 0; d < 6; ++d) {
        h[d * 7] += prior[d];
        b[d] += c[d] * prior[d];
      }
    }
    float newton[6];
    chol_solve6(h, b, newton);
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      x[d] = prior != nullptr ? c[d] / prior[6 + d] : c[d];
      nns[i * 6 + d] = -newton[d];
    }
  }
  __syncthreads();
  if (tid < P) {
#pragma unroll
    for (int e = 0; e < 36; ++e) hx[tid * 42 + e] = h[e];
#pragma unroll
    for (int d = 0; d < 6; ++d) hx[tid * 42 + 36 + d] = x[d];
  }
  __syncthreads();

  // 2. h_mean and the coordinate mean; centre the coordinates
  column_sums(hx, 42, P, 42, part, sums);
  if (tid < 36) hmean[tid] = sums[tid] / fp;
  if (tid < P) {
#pragma unroll
    for (int d = 0; d < 6; ++d) xs[tid * 6 + d] = x[d] - sums[36 + d] / fp;
  }
  __syncthreads();

  // 3. exact lower median of the P*P squared distances by radix select.
  //    The multiset is the P zeros of the diagonal and each unordered pair
  //    twice (sqdist6 is symmetric bit for bit), so a thread walks unordered
  //    pairs (i, i + s mod P), s = 1 .. P/2 (for even P, s = P/2 only for
  //    i < P/2), and counts each with weight 2. Pass d counts the values
  //    that share the digits chosen so far into hist[d % 3] with integer
  //    atomics (no result awaited, so a thread's pairs overlap; warp votes
  //    to group equal digits cost more than the conflicts they save) and
  //    clears the next pass's histogram; after one barrier every warp scans
  //    the histogram and picks the same bin. Each thread visits the same
  //    pairs in every pass, so pass 0 stores the distances it computes
  //    (both orders, for step 4) and the later passes read its own.
  const int n = P * P;
  const int m_pairs = P * (P - 1) / 2;
  const int di = nthreads / P, dj = nthreads - di * P;   // (s, i) += nthreads
  unsigned prefix = 0u;
  unsigned rank = static_cast<unsigned>((n - 1) / 2);
  if (store) {
    for (int e = tid; e < P; e += nthreads) sqs[e * P + e] = 0.f;
  }
  int s_off, i;   // the thread's pair (i, i + s_off mod P)
#pragma unroll 1
  for (int d = 0; d < 4; ++d) {
    const int shift = 24 - 8 * d;
    const unsigned hi_mask = d == 0 ? 0u : (0xFFFFFFFFu << (shift + 8));
    unsigned* hcur = hist + (d % 3) * kHistPad;
    s_off = 1 + tid / P;
    i = tid - (tid / P) * P;
#pragma unroll 4
    for (int e = tid; e < m_pairs; e += nthreads) {
      const int j = i + s_off < P ? i + s_off : i + s_off - P;
      float v;
      if (store && d > 0) {
        v = sqs[i * P + j];
      } else {
        v = sqdist6(xs + i * 6, xs + j * 6);
        if (store) {
          sqs[i * P + j] = v;
          sqs[j * P + i] = v;
        }
      }
      const unsigned bits = __float_as_uint(v);
      if ((bits & hi_mask) == prefix) {
        const unsigned digit = (bits >> shift) & 0xFFu;
        atomicAdd(&hcur[digit + (digit >> 3)], 2u);
      }
      i += dj;
      s_off += di;
      if (i >= P) {
        i -= P;
        ++s_off;
      }
    }
    if (tid == 0 && prefix == 0u) atomicAdd(&hcur[0], static_cast<unsigned>(P));  // diagonal
    for (int e = tid; e < kHistPad; e += nthreads) hist[((d + 1) % 3) * kHistPad + e] = 0u;
    __syncthreads();
    unsigned cnt[8], tot = 0u;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      cnt[q] = hcur[lane * 9 + q];
      tot += cnt[q];
    }
    unsigned incl = tot;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const unsigned v = __shfl_up_sync(0xFFFFFFFFu, incl, off);
      if (lane >= off) incl += v;
    }
    const unsigned excl = incl - tot;
    const bool mine = excl <= rank && rank < incl;
    unsigned r = rank - excl, in_bin = 0u;
    int bin = 0;
    bool found = false;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (!found) {
        if (r < cnt[q]) {
          found = true;
          bin = q;
          in_bin = cnt[q];
        } else {
          r -= cnt[q];
        }
      }
    }
    const int owner = __ffs(__ballot_sync(0xFFFFFFFFu, mine)) - 1;
    prefix |= static_cast<unsigned>(__shfl_sync(0xFFFFFFFFu, lane * 8 + bin, owner)) << shift;
    rank = __shfl_sync(0xFFFFFFFFu, r, owner);
    // A bin of count 2 away from zero holds one unordered pair: its value is
    // the median. The thread that visits it publishes it; the later passes
    // would only spell out its remaining bits.
    if (d < 3 && prefix != 0u && __shfl_sync(0xFFFFFFFFu, in_bin, owner) == 2u) {
      const unsigned chosen_mask = 0xFFFFFFFFu << shift;
      s_off = 1 + tid / P;
      i = tid - (tid / P) * P;
      for (int e = tid; e < m_pairs; e += nthreads) {
        const int j = i + s_off < P ? i + s_off : i + s_off - P;
        const float v = store ? sqs[i * P + j] : sqdist6(xs + i * 6, xs + j * 6);
        if ((__float_as_uint(v) & chosen_mask) == prefix) unique_bits = __float_as_uint(v);
        i += dj;
        s_off += di;
        if (i >= P) {
          i -= P;
          ++s_off;
        }
      }
      __syncthreads();
      prefix = unique_bits;
      break;
    }
  }
  const float med = __uint_as_float(prefix);
  const float bw = fmaxf(med / logf(static_cast<float>(P + 1)), 1e-12f);

  // 4. RBF kernel rows: ksum, K x, K (-newton); `g` threads per row (the
  //    most, a power of two, that fit), each over every g-th column, then a
  //    butterfly within the group. The rows overwrite hx, read in step 2.
  int g = 32;
  while (g > 1 && g * P > nthreads) g >>= 1;
  {
    const int i = tid / g, sub = tid - i * g;
    float acc[kRow];
#pragma unroll
    for (int v = 0; v < kRow; ++v) acc[v] = 0.f;
    if (i < P) {
      for (int j = sub; j < P; j += g) {
        const float s = store ? sqs[i * P + j] : sqdist6(xs + i * 6, xs + j * 6);
        const float kij = expf(-s / bw);
        acc[0] += kij;
#pragma unroll
        for (int dd = 0; dd < 6; ++dd) {
          acc[1 + dd] += kij * xs[j * 6 + dd];
          acc[7 + dd] += kij * nns[j * 6 + dd];
        }
      }
    }
    for (int off = g >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int v = 0; v < kRow; ++v) acc[v] += __shfl_xor_sync(0xFFFFFFFFu, acc[v], off);
    }
    if (i < P && sub == 0) {
#pragma unroll
      for (int v = 0; v < kRow; ++v) rows[i * kRow + v] = acc[v];
    }
  }
  __syncthreads();

  // 5. per particle: repulsion, step, clip, pose update, exit terms
  if (tid < P) {
    const int i = tid;
    const float ksum = rows[i * kRow];
    float grad_k[6], drive[6];
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      grad_k[d] = (2.f / bw) * (xs[i * 6 + d] * ksum - rows[i * kRow + 1 + d]);
      if (prior != nullptr) grad_k[d] /= prior[6 + d];
      drive[d] = rows[i * kRow + 7 + d];
    }
    float repulsion[6];
    chol_solve6(hmean, grad_k, repulsion);
    float stein[6];
    float n2 = 0.f;
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      stein[d] = (drive[d] + repulsion[d]) / ksum;
      n2 += stein[d] * stein[d];
    }
    const float scale = fminf(1.f, max_dist / fmaxf(sqrtf(n2), 1e-30f));
#pragma unroll
    for (int d = 0; d < 6; ++d) stein[d] *= scale;

    // right-multiplicative SE(3) update
    const float w0 = stein[3], w1 = stein[4], w2 = stein[5];
    const float a2 = w0 * w0 + w1 * w1 + w2 * w2;
    float sinc, cosc, sinc3;
    taylor_coeffs_sq(a2, &sinc, &cosc, &sinc3);
    const float wv[3] = {w0, w1, w2};
    const float skw[9] = {0.f, -w2, w1, w2, 0.f, -w0, -w1, w0, 0.f};
    float dr[9], jl[9];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) {
        const float w2e = wv[a] * wv[bb] - (a == bb ? a2 : 0.f);
        const float eye = a == bb ? 1.f : 0.f;
        dr[a * 3 + bb] = eye + sinc * skw[a * 3 + bb] + cosc * w2e;
        jl[a * 3 + bb] = eye + cosc * skw[a * 3 + bb] + sinc3 * w2e;
      }
    }
    const float* R = rs + i * 9;
    float rn[9];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) {
        rn[a * 3 + bb] = R[a * 3] * dr[bb] + R[a * 3 + 1] * dr[3 + bb] + R[a * 3 + 2] * dr[6 + bb];
      }
    }
    float dtl[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      dtl[a] = jl[a * 3] * stein[0] + jl[a * 3 + 1] * stein[1] + jl[a * 3 + 2] * stein[2];
    }
#pragma unroll
    for (int e = 0; e < 9; ++e) r_out[i * 9 + e] = rn[e];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      t_out[i * 3 + a] =
          rn[a * 3] * dtl[0] + rn[a * 3 + 1] * dtl[1] + rn[a * 3 + 2] * dtl[2] + ts[i * 3 + a];
    }
    // exit terms |stein_i| and stein_i, over this particle's own row
    rows[i * kRow] = sqrtf(stein[0] * stein[0] + stein[1] * stein[1] + stein[2] * stein[2] +
                           stein[3] * stein[3] + stein[4] * stein[4] + stein[5] * stein[5]);
#pragma unroll
    for (int d = 0; d < 6; ++d) rows[i * kRow + 1 + d] = stein[d];
  }
  __syncthreads();

  // 6. exit statistics: mean |stein| and |mean stein|
  column_sums(rows, kRow, P, 7, part, sums);
  if (tid == 0) {
    float m2 = 0.f;
#pragma unroll
    for (int d = 0; d < 6; ++d) {
      const float m = sums[1 + d] / fp;
      m2 += m * m;
    }
    stats[0] = sums[0] / fp;
    stats[1] = sqrtf(m2);
  }
}

}  // namespace

// hess [P,6,6], b [P,6], r [P,3,3], t [P,3], prior [2,6] (inverse variance,
// kernel scale) or NULL -> r_out [P,3,3], t_out [P,3], stats [2] =
// (mean |step|, |mean step|). 1 <= P <= 512.
SVN_EXPORT int svn_stein_update(const void* hess, const void* b, const void* r, const void* t,
                                const void* prior, int P, float max_dist, void* r_out,
                                void* t_out, void* stats, void* stream) {
  if (P < 1 || P > kMaxP) return static_cast<int>(cudaErrorInvalidValue);
  static const cudaError_t attr = cudaFuncSetAttribute(
      stein_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem_bytes());
  if (attr != cudaSuccess) return static_cast<int>(attr);
  // a thread per pair up to kThreads; at least 64, so that a thread owns
  // each of the 42 columns of the block sums
  int threads = (P * P + 31) / 32 * 32;
  threads = threads > kThreads ? kThreads : (threads < 64 ? 64 : threads);
  SVN_LAUNCH(stein_kernel, 1, threads, smem_floats(P) * 4, static_cast<cudaStream_t>(stream))(
      static_cast<const float*>(hess), static_cast<const float*>(b),
      static_cast<const float*>(r), static_cast<const float*>(t),
      static_cast<const float*>(prior), P, max_dist, static_cast<float*>(r_out),
      static_cast<float*>(t_out), static_cast<float*>(stats));
  return static_cast<int>(cudaGetLastError());
}
