// The second pass of the moments kernels (plane_moments.cu, point_moments.cu).
#pragma once

#include "common.cuh"

namespace {

// out[i] = sum over tiles t in order of partial[t, i], i < n (a fixed order,
// so repeated runs give the same bits).
__global__ void sum_tiles_kernel(const float* __restrict__ partial, int n_tiles, int n,
                                 float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int t = 0; t < n_tiles; ++t) s += partial[static_cast<long long>(t) * n + i];
  out[i] = s;
}

}  // namespace
