// K3 `revo_lgsx_reduce`: the LGSX normal-equation reduction on Hopper.
//
// Replaces the Pallas kernel revo_tpu/ops/pallas/lgsx.py (`lgsx_reduce`,
// `_kernel`).  From warped points p (P, 3), fx/fy-scaled DT gradients
// (P, 2), residuals r (P,) and weights w (P,) (0 on dead lanes) it forms
// the Jacobian row J (6) of every point (optimizer.cpp:216-228) and reduces
//   A = sum w J J^T (6x6),  g = sum w J r (6),  s = sum w r^2,
// unnormalized; the caller divides by the good count.
//
// One block of 1024 threads strides over P (P <= 16384 on the main path).
// Each thread keeps 28 running sums in registers (the 21 entries of A's
// upper triangle, g and s); the block reduces them with a fixed
// warp-shuffle tree and a fixed-order pass over the 32 warp partials in
// shared memory.  No float atomics: the summation order is fixed, so
// repeated runs give bit-identical systems and poses.  Bound on the H100:
// launch latency and the single block's reduction; the 16384 points carry
// 448 KB, under 1 us of HBM time.  Fusing the dt4 gather and the residual
// arithmetic into this kernel is later work.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;
constexpr int NSUM = 28;  // 21 (upper A) + 6 (g) + 1 (s)

__global__ void __launch_bounds__(THREADS)
lgsx_reduce_kernel(const float* __restrict__ wxp, const float* __restrict__ grads,
                   const float* __restrict__ res, const float* __restrict__ wts,
                   float* __restrict__ out, int P) {
  float acc[NSUM];
#pragma unroll
  for (int k = 0; k < NSUM; ++k) acc[k] = 0.0f;

  for (int p = threadIdx.x; p < P; p += THREADS) {
    const float px = wxp[3 * p], py = wxp[3 * p + 1], pz = wxp[3 * p + 2];
    const float gx = grads[2 * p], gy = grads[2 * p + 1];
    const float r = res[p], w = wts[p];
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

  // Fixed-order reduction: shuffle tree inside each warp, then warp 0 sums
  // the 32 warp partials in index order.
#pragma unroll
  for (int k = 0; k < NSUM; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc[k] += __shfl_down_sync(0xffffffffu, acc[k], o);
  }
  __shared__ float part[THREADS / 32][NSUM];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NSUM; ++k) part[warp][k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x < NSUM) {
    const int k = threadIdx.x;
    float s = 0.0f;
    for (int wi = 0; wi < THREADS / 32; ++wi) s += part[wi][k];
    // out: A (6x6 row-major, both triangles), g (6), s (1).
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
}

}  // namespace

extern "C" int revo_lgsx_reduce(const float* wxp, const float* grads,
                                const float* r, const float* w, float* out,
                                int P, cudaStream_t stream) {
  lgsx_reduce_kernel<<<1, THREADS, 0, stream>>>(wxp, grads, r, w, out, P);
  return (int)cudaGetLastError();
}
