// Device code shared by the two LGSX kernels of lgsx.cu: one point's
// contribution to the 28 running sums, the fixed warp-shuffle tree, and the
// scatter of the 21 upper-triangle sums into the 6x6 output.
#pragma once
#include <cuda_runtime.h>

namespace lgsx {

constexpr int NSUM = 28;  // 21 (upper A) + 6 (g) + 1 (s)

// acc[0..27] += one point: Jacobian row J (6) of the warped point (px, py, pz) with
// fx/fy-scaled DT gradients (gx, gy) (optimizer.cpp:216-228), then
// A += w J J^T (upper triangle, row-major), g += w r J, s += w r^2.
template <int N>
__device__ __forceinline__ void accumulate(float (&acc)[N], float px, float py,
                                           float pz, float gx, float gy, float r,
                                           float w) {
  static_assert(N >= NSUM, "acc holds the 28 sums first");
  const float pzs = (pz == 0.0f) ? 1e-12f : pz;
  const float iz = 1.0f / pzs;
  const float iz2 = iz * iz;
  float J[6];
  J[0] = iz * gx;
  J[1] = iz * gy;
  J[2] = (-px * iz2) * gx + (-py * iz2) * gy;
  J[3] = (-px * py * iz2) * gx - (1.0f + py * py * iz2) * gy;
  J[4] = (1.0f + px * px * iz2) * gx + (px * py * iz2) * gy;
  J[5] = (-py * iz) * gx + (px * iz) * gy;
  const float wr = w * r;
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float jw = J[i] * w;
#pragma unroll
    for (int j = i; j < 6; ++j) acc[k++] += jw * J[j];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[21 + i] += J[i] * wr;
  acc[27] += wr * r;
}

// Fixed-order sum over the warp's 32 lanes; lane 0 holds the result.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// Store sum k (0..27) at its place in out: A (6x6 row-major, both
// triangles) at 0..35, g at 36..41, s at 42.
__device__ __forceinline__ void store_sum(float* out, int k, float s) {
  if (k < 21) {
    int i = 0, rem = k;
    while (rem >= 6 - i) { rem -= 6 - i; ++i; }
    const int j = i + rem;
    out[i * 6 + j] = s;
    out[j * 6 + i] = s;
  } else {
    out[36 + (k - 21)] = s;
  }
}

}  // namespace lgsx
