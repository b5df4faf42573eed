// F1: the ESKF's propagation over one frame's IMU window, in one launch.
//
// Replaces no `pallas_call`: the JAX package runs this propagation as one
// compiled lax.scan (svnicp_tpu/runtime/pipeline.py:_imu_scan_predict over
// core/eskf.py:predict and core/imu.py:propagate). Issued op by op from
// Python, as kernels/eskf.py:propagate_plain does, the scan is ~80-100 tiny
// operations a sample. Here one block walks the window's samples in order,
// a loop inside the block in place of the scan. Per sample, with the
// arithmetic of core/eskf.predict and core/imu.propagate:
//   the current sample's acceleration compensated by ba (its compensated
//   gyro is never read: the attitude increment takes the previous sample's),
//   the previous sample kept raw, the first interval starting from the
//   window's first sample itself;
//   v' = v + R (a_prev dt_prev) + (R g) dt  (the reference's rotated gravity)
//   t' = t + v dt + g dt^2 / 2 + R (a_prev dt_prev) dt / 2
//   R' = R RzRyRx(gyro_prev dt)
//   phi = I, with dp/dv = I dt, dv/dtheta = exp((R a)^) dt (with textbook_phi
//   -(R a)^ dt), dv/dba = R dt, dtheta/dbg = -R dt, R the rotation before
//   the sample; Q = blocks R diag(var) R^T dt (velocity, attitude) and
//   2 diag(var) dt (the biases); cov' = phi cov phi^T + Q.
//
// What bounds it: neither bytes (~2 KB a window) nor operations (~0.15
// MFLOP for 10 samples) but the launch and the chain from one sample to the
// next. The covariance stays in shared memory for the whole window, one
// thread per element; the nav state and the transition's 3x3 blocks are the
// first warp's, a lane per element; three block barriers a sample. The
// noise variances come squared from the host, once a window.

#include "common.cuh"

namespace {

constexpr int kN = 15;            // error-state size
constexpr int kCov = kN * kN;
constexpr int kThreads = 256;     // one thread per covariance element
constexpr double kGravity = 9.782940329221166;  // core/imu.py:GRAVITY
constexpr double kSmall = 1e-6;                 // core/geometry.py:_SMALL

// output layout: R [9], t [3], v [3], cov [225], the last sample's Q [225]
constexpr int kOutR = 0, kOutT = 9, kOutV = 12, kOutCov = 15, kOutQ = 15 + kCov;

__device__ __forceinline__ float vsin(float x) { return sinf(x); }
__device__ __forceinline__ double vsin(double x) { return sin(x); }
__device__ __forceinline__ float vcos(float x) { return cosf(x); }
__device__ __forceinline__ double vcos(double x) { return cos(x); }
__device__ __forceinline__ float vsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double vsqrt(double x) { return sqrt(x); }

template <typename T>
struct NoiseVar {
  T v[12];  // std^2 of vel_rw [0:3], rot_rw [3:6], bg_std [6:9], ba_std [9:12]
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    eskf_propagate_kernel(const T* __restrict__ rows, int n, const T* __restrict__ r_in,
                          const T* __restrict__ t_in, const T* __restrict__ v_in,
                          const T* __restrict__ cov_in, const T* __restrict__ ba,
                          NoiseVar<T> var, int textbook, T* __restrict__ out) {
  __shared__ T cov[kCov], prod[kCov], phi[kCov], q[kCov];
  __shared__ T nav_r[9], nav_t[3], nav_v[3], s_var[12];
  // the current sample's attitude increment, (R a)^ and dt; the
  // transition's blocks: R before the sample, dv/dtheta, and Q's velocity
  // and attitude blocks. Every index that differs between threads goes to
  // shared memory (a runtime index into a thread's own array would put the
  // array in local memory).
  __shared__ T s_dR[9], s_W[9], s_dt, blk_r[9], blk_j[9], blk_qv[9], blk_qr[9];

  const int tid = threadIdx.x;
  const int ei = tid / kN, ej = tid % kN;
  if (tid < kCov) cov[tid] = cov_in[tid];
  if (tid < 9) nav_r[tid] = r_in[tid];
  if (tid < 3) {
    nav_t[tid] = t_in[tid];
    nav_v[tid] = v_in[tid];
  }
  if (tid == 0) {
#pragma unroll
    for (int k = 0; k < 12; ++k) s_var[k] = var.v[k];
  }
  // the previous sample, raw (the first warp's lanes hold it)
  T p_dt = rows[0], p_acc[3], p_gyro[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p_acc[k] = rows[1 + k];
    p_gyro[k] = rows[4 + k];
  }
  __syncthreads();

  for (int s = 0; s < n; ++s) {
    const T* row = rows + 7 * s;
    if (tid < 32) {
      // every lane computes the sample's small quantities; the lanes that
      // own an element of the new nav state or of a block then write it
      const int lane = tid;
      const T dt = row[0];
      T R[9], acc[3], f[3], ra[3];
#pragma unroll
      for (int k = 0; k < 9; ++k) R[k] = nav_r[k];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        acc[k] = row[1 + k] - ba[k];
        f[k] = p_acc[k] * p_dt;
      }
#pragma unroll
      for (int i = 0; i < 3; ++i)
        ra[i] = R[3 * i] * acc[0] + R[3 * i + 1] * acc[1] + R[3 * i + 2] * acc[2];
      if (lane == 0) {
        // attitude increment: RzRyRx(roll, pitch, yaw) of gyro_prev dt
        const T roll = p_gyro[0] * dt, pitch = p_gyro[1] * dt, yaw = p_gyro[2] * dt;
        const T cy = vcos(yaw), sy = vsin(yaw), cp = vcos(pitch), sp = vsin(pitch);
        const T cr = vcos(roll), sr = vsin(roll);
        s_dR[0] = cp * cy;
        s_dR[1] = sr * sp * cy - cr * sy;
        s_dR[2] = sr * sy + cr * sp * cy;
        s_dR[3] = cp * sy;
        s_dR[4] = cr * cy + sr * sp * sy;
        s_dR[5] = cr * sp * sy - sr * cy;
        s_dR[6] = -sp;
        s_dR[7] = sr * cp;
        s_dR[8] = cr * cp;
        // W = (R a)^
        s_W[0] = T(0), s_W[1] = -ra[2], s_W[2] = ra[1];
        s_W[3] = ra[2], s_W[4] = T(0), s_W[5] = -ra[0];
        s_W[6] = -ra[1], s_W[7] = ra[0], s_W[8] = T(0);
        s_dt = dt;
      }
      // the reference's transition takes exp(W) = I + sinc W + cosc W^2
      // (core/geometry.py:_taylor_coeffs_sq)
      const T a2 = ra[0] * ra[0] + ra[1] * ra[1] + ra[2] * ra[2];
      const bool small = a2 < T(kSmall);
      const T ang = vsqrt(small ? T(1) : a2);
      const T sinc = small ? T(1) - a2 / T(6) : vsin(ang) / ang;
      const T cosc = small ? T(0.5) - a2 / T(24) : (T(1) - vcos(ang)) / (ang * ang);
      __syncwarp();
      T r_new = T(0), v_new = T(0), t_new = T(0);
      if (lane < 9) {
        const int i = lane / 3, j = lane % 3;
        const T* ri = nav_r + 3 * i;
        const T* rj = nav_r + 3 * j;
        const T* wi = s_W + 3 * i;
        r_new = ri[0] * s_dR[j] + ri[1] * s_dR[3 + j] + ri[2] * s_dR[6 + j];
        const T ww = wi[0] * s_W[j] + wi[1] * s_W[3 + j] + wi[2] * s_W[6 + j];
        blk_j[lane] = textbook ? -s_W[lane] * dt
                               : ((i == j ? T(1) : T(0)) + sinc * s_W[lane] + cosc * ww) * dt;
        T qv = T(0), qr = T(0);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          qv += ri[k] * s_var[k] * rj[k];
          qr += ri[k] * s_var[3 + k] * rj[k];
        }
        blk_qv[lane] = qv * dt;
        blk_qr[lane] = qr * dt;
        blk_r[lane] = nav_r[lane];
      }
      if (lane < 3) {
        const T* rl = nav_r + 3 * lane;
        const T dvf = rl[0] * f[0] + rl[1] * f[1] + rl[2] * f[2];  // R (a_prev dt_prev)
        const T g = lane == 2 ? T(-kGravity) : T(0);
        const T v = nav_v[lane];
        v_new = v + dvf + rl[2] * T(-kGravity) * dt;
        t_new = nav_t[lane] + v * dt + T(0.5) * g * dt * dt + T(0.5) * dvf * dt;
      }
      __syncwarp();  // every lane has read the nav state
      if (lane < 9) nav_r[lane] = r_new;
      if (lane < 3) {
        nav_v[lane] = v_new;
        nav_t[lane] = t_new;
      }
      p_dt = dt;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        p_acc[k] = row[1 + k];
        p_gyro[k] = row[4 + k];
      }
    }
    __syncthreads();

    if (tid < kCov) {
      const T dt = s_dt;
      T f = ei == ej ? T(1) : T(0), qe = T(0);
      const int bi = ei % 3, bj = ej % 3;
      if (ei < 3 && ej == ei + 3) f = dt;
      if (ei >= 3 && ei < 6 && ej >= 6 && ej < 9) f = blk_j[3 * bi + bj];
      if (ei >= 3 && ei < 6 && ej >= 12) f = blk_r[3 * bi + bj] * dt;
      if (ei >= 6 && ei < 9 && ej >= 9 && ej < 12) f = -blk_r[3 * bi + bj] * dt;
      if (ei >= 3 && ei < 6 && ej >= 3 && ej < 6) qe = blk_qv[3 * bi + bj];
      if (ei >= 6 && ei < 9 && ej >= 6 && ej < 9) qe = blk_qr[3 * bi + bj];
      if (ei == ej && ei >= 9) qe = T(2) * s_var[ei - 3] * dt;  // the biases' variances
      phi[tid] = f;
      q[tid] = qe;
    }
    __syncthreads();

    if (tid < kCov) {  // phi cov
      T acc = T(0);
      for (int k = 0; k < kN; ++k) acc += phi[ei * kN + k] * cov[k * kN + ej];
      prod[tid] = acc;
    }
    __syncthreads();

    if (tid < kCov) {  // (phi cov) phi^T + Q
      T acc = T(0);
      for (int k = 0; k < kN; ++k) acc += prod[ei * kN + k] * phi[ej * kN + k];
      cov[tid] = acc + q[tid];
    }
    // the next sample's first writes (nav and blocks) touch nothing this
    // phase reads, and its phi and Q come after the next barrier
  }
  __syncthreads();

  if (tid < kCov) {
    out[kOutCov + tid] = cov[tid];
    out[kOutQ + tid] = q[tid];
  }
  if (tid < 9) out[kOutR + tid] = nav_r[tid];
  if (tid < 3) {
    out[kOutT + tid] = nav_t[tid];
    out[kOutV + tid] = nav_v[tid];
  }
}

template <typename T>
int launch_propagate(const void* rows, const void* r, const void* t, const void* v,
                     const void* cov, const void* ba, const double* var_host, int n,
                     int textbook, void* out, void* stream) {
  NoiseVar<T> var;
  for (int k = 0; k < 12; ++k) var.v[k] = static_cast<T>(var_host[k]);
  SVN_LAUNCH(eskf_propagate_kernel<T>, 1, kThreads, 0, static_cast<cudaStream_t>(stream))(
      static_cast<const T*>(rows), n, static_cast<const T*>(r), static_cast<const T*>(t),
      static_cast<const T*>(v), static_cast<const T*>(cov), static_cast<const T*>(ba), var,
      textbook, static_cast<T*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// rows [n,7] (dt, acc, gyro) and the state (R [3,3], t, v, cov [15,15],
// ba [3]) on the card, contiguous, all float32 (f64 = 0) or all float64
// (f64 = 1); var_host: 12 doubles in the host's memory, the variances of
// vel_rw, rot_rw, bg_std, ba_std already rounded to the working type;
// out [465] on the card (layout above).
SVN_EXPORT int svn_eskf_propagate(const void* rows, const void* r, const void* t,
                                  const void* v, const void* cov, const void* ba,
                                  const double* var_host, int n, int textbook, int f64,
                                  void* out, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  return f64 ? launch_propagate<double>(rows, r, t, v, cov, ba, var_host, n, textbook, out,
                                        stream)
             : launch_propagate<float>(rows, r, t, v, cov, ba, var_host, n, textbook, out,
                                       stream);
}
